"""HEALPix ring geometry (host numpy): the subset the SHT plan and the TOD
layer need (ring geometry, weights, pixel angles and unit vectors).

Copied from commander_tpu.sphere.healpix (same formulas, Gorski et al. 2005):
RING ordering, npix = 12 nside^2, nring = 4 nside - 1, colatitude theta in
[0, pi], z = cos(theta), longitude phi in [0, 2pi).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np


def npix_of(nside: int) -> int:
    return 12 * nside * nside


def nring_of(nside: int) -> int:
    return 4 * nside - 1


@dataclasses.dataclass(frozen=True)
class RingGeometry:
    """Static per-ring geometry for one nside, rings indexed 0..nring-1 north→south."""

    nside: int
    nphi: np.ndarray      # (nring,) int32: pixels in each ring
    z: np.ndarray         # (nring,) f64: cos(theta) of ring centers
    theta: np.ndarray     # (nring,) f64
    phi0: np.ndarray      # (nring,) f64: longitude of first pixel center
    offset: np.ndarray    # (nring,) int64: RING index of first pixel in ring

    @property
    def npix(self) -> int:
        return npix_of(self.nside)

    @property
    def nring(self) -> int:
        return nring_of(self.nside)


@functools.lru_cache(maxsize=None)
def ring_geometry(nside: int) -> RingGeometry:
    if nside < 1 or (nside & (nside - 1)) != 0:
        raise ValueError(f"nside must be a positive power of 2, got {nside}")
    nring = nring_of(nside)
    i = np.arange(1, nring + 1, dtype=np.int64)  # 1-based ring index from north pole
    nphi = np.where(
        i < nside, 4 * i, np.where(i <= 3 * nside, 4 * nside, 4 * (4 * nside - i))
    ).astype(np.int64)

    z = np.empty(nring, dtype=np.float64)
    north = i < nside
    belt = (i >= nside) & (i <= 3 * nside)
    south = i > 3 * nside
    z[north] = 1.0 - (i[north] ** 2) / (3.0 * nside**2)
    z[belt] = (2.0 * nside - i[belt]) * 2.0 / (3.0 * nside)
    isouth = 4 * nside - i[south]
    z[south] = -(1.0 - (isouth**2) / (3.0 * nside**2))

    # first-pixel phase: caps always offset half a pixel; belt alternates
    s = np.empty(nring, dtype=np.int64)
    s[north | south] = 1
    s[belt] = (i[belt] - nside + 1) % 2
    phi0 = np.pi * s / nphi

    offset = np.concatenate([[0], np.cumsum(nphi)[:-1]]).astype(np.int64)
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    return RingGeometry(nside=nside, nphi=nphi.astype(np.int32), z=z,
                        theta=theta, phi0=phi0, offset=offset)


def ring_index_of_pix(nside: int) -> np.ndarray:
    """(npix,) int32: ring index (0-based) of each RING-ordered pixel."""
    g = ring_geometry(nside)
    return np.repeat(np.arange(g.nring, dtype=np.int32), g.nphi)


def pix_in_ring_of_pix(nside: int) -> np.ndarray:
    """(npix,) int32: index-within-ring of each RING-ordered pixel."""
    g = ring_geometry(nside)
    ring = ring_index_of_pix(nside)
    return (np.arange(g.npix) - g.offset[ring]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def ring_weights(nside: int, lmax: int | None = None) -> np.ndarray:
    """Per-ring quadrature weights w_r (pixel weight of each ring), solved by
    least squares so that sum_r w_r nphi_r P_l(z_r) = 4 pi delta_l0 for even
    l <= lmax, as close as possible to the area weight 4 pi / npix."""
    g = ring_geometry(nside)
    if lmax is None:
        lmax = 2 * nside
    nhalf = 2 * nside  # independent weights: rings 0..2nside-1 incl. equator
    zs = g.z[:nhalf]
    V = np.polynomial.legendre.legvander(zs, lmax)
    P = V[:, ::2].T  # (n_even_l, nhalf)
    nphi = g.nphi[:nhalf].astype(np.float64)
    mult = np.where(np.arange(nhalf) == nhalf - 1, 1.0, 2.0)  # equator once
    A = P * (nphi * mult)[None, :]
    b = np.zeros(P.shape[0])
    b[0] = 4.0 * np.pi
    w0 = np.full(nhalf, 4.0 * np.pi / g.npix)
    dw, *_ = np.linalg.lstsq(A, b - A @ w0, rcond=None)
    w = w0 + dw
    return np.concatenate([w, w[:-1][::-1]])


def pix2ang_ring(nside: int) -> tuple[np.ndarray, np.ndarray]:
    """(theta, phi) of all pixel centers in RING order, shape (npix,)."""
    g = ring_geometry(nside)
    ring_of_pix = np.repeat(np.arange(g.nring), g.nphi)
    j = np.arange(g.npix) - g.offset[ring_of_pix]
    theta = g.theta[ring_of_pix]
    phi = g.phi0[ring_of_pix] + 2.0 * np.pi * j / g.nphi[ring_of_pix]
    return theta, phi


def pix2vec_ring(nside: int) -> np.ndarray:
    """(npix, 3) unit vectors of pixel centers in RING order."""
    theta, phi = pix2ang_ring(nside)
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)],
                    axis=-1)
