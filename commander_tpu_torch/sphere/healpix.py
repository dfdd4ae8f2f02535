"""HEALPix ring geometry (host numpy): the subset the SHT plan, the TOD
layer, the low-ell preconditioner and the point-source catalog need (ring
geometry, ring and area weights, pixel angles and unit vectors, ang2pix,
RING <-> NEST tables and udgrade index tables).

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


def area_weights(nside: int) -> np.ndarray:
    """Uniform per-ring pixel weight: Omega_pix = 4 pi / npix for every
    ring (the JAX package's get_plan(weights="area"))."""
    g = ring_geometry(nside)
    return np.full(g.nring, 4.0 * np.pi / g.npix)


# ---------------------------------------------------------------------------
# RING <-> NEST (bit-interleaved face coordinates), vectorized numpy
# ---------------------------------------------------------------------------

# jrll/jpll: face anchors from the HEALPix spec.
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], dtype=np.int64)
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], dtype=np.int64)


def _spread_bits(x: np.ndarray) -> np.ndarray:
    """Interleave zeros between bits of x (x must be < 2^32)."""
    x = x.astype(np.uint64)
    x &= np.uint64(0x00000000FFFFFFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def _compress_bits(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x5555555555555555)
    x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return x


def _xyf2nest(nside: int, x, y, f):
    return (f.astype(np.int64) * nside * nside
            + (_spread_bits(x) | (_spread_bits(y) << np.uint64(1))).astype(np.int64))


def _nest2xyf(nside: int, ipix):
    ipix = np.asarray(ipix, dtype=np.int64)
    f = ipix // (nside * nside)
    rem = (ipix % (nside * nside)).astype(np.uint64)
    x = _compress_bits(rem).astype(np.int64)
    y = _compress_bits(rem >> np.uint64(1)).astype(np.int64)
    return x, y, f


def _isqrt(x: np.ndarray) -> np.ndarray:
    r = np.floor(np.sqrt(x.astype(np.float64))).astype(np.int64)
    r = np.where((r + 1) * (r + 1) <= x, r + 1, r)
    r = np.where(r * r > x, r - 1, r)
    return r


def _ring2xyf(nside: int, ipix):
    """RING pixel index -> (x, y, face). Vectorized per the HEALPix spec."""
    ipix = np.asarray(ipix, dtype=np.int64)
    npix = npix_of(nside)
    ncap = 2 * nside * (nside - 1)
    nl2 = 2 * nside
    iring = np.empty_like(ipix)
    iphi = np.empty_like(ipix)   # 1-based index in ring
    kshift = np.zeros_like(ipix)
    nr = np.empty_like(ipix)
    face = np.empty_like(ipix)

    m = ipix < ncap  # north polar cap
    if np.any(m):
        ip = ipix[m]
        ir = (1 + _isqrt(1 + 2 * ip)) >> 1
        iring[m] = ir
        iphi[m] = (ip + 1) - 2 * ir * (ir - 1)
        nr[m] = ir
        face[m] = (iphi[m] - 1) // ir

    m = (ipix >= ncap) & (ipix < npix - ncap)  # equatorial belt
    if np.any(m):
        ip = ipix[m] - ncap
        tmp = ip // (4 * nside)
        ir = tmp + nside
        iring[m] = ir
        ph = ip - tmp * 4 * nside + 1
        iphi[m] = ph
        kshift[m] = (ir + nside) & 1
        nr[m] = nside
        ire = ir - nside + 1
        irm = nl2 + 2 - ire
        ifm = (ph - ire // 2 + nside - 1) // nside
        ifp = (ph - irm // 2 + nside - 1) // nside
        face[m] = np.where(ifp == ifm, ifp | 4, np.where(ifp < ifm, ifp, ifm + 8))

    m = ipix >= npix - ncap  # south polar cap
    if np.any(m):
        ip = npix - ipix[m]
        ir = (1 + _isqrt(2 * ip - 1)) >> 1
        iphi[m] = 4 * ir + 1 - (ip - 2 * ir * (ir - 1))
        nr[m] = ir
        face[m] = 8 + (iphi[m] - 1) // ir
        iring[m] = 4 * nside - ir

    irt = iring - _JRLL[face] * nside + 1
    ipt = 2 * iphi - _JPLL[face] * nr - kshift - 1
    ipt = np.where(ipt >= nl2, ipt - 8 * nside, ipt)
    x = (ipt - irt) >> 1
    y = (-(ipt + irt)) >> 1
    return x, y, face


def _xyf2ring(nside: int, x, y, f):
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    f = np.asarray(f, dtype=np.int64)
    npix = npix_of(nside)
    ncap = 2 * nside * (nside - 1)
    jr = _JRLL[f] * nside - x - y - 1  # ring 1..4nside-1 from north
    north = jr < nside
    south = jr > 3 * nside
    belt = ~north & ~south
    nr = np.where(north, jr, np.where(south, 4 * nside - jr, nside))
    n_before = np.where(
        north, 2 * nr * (nr - 1),
        np.where(south, npix - 2 * (nr + 1) * nr, ncap + (jr - nside) * 4 * nside))
    kshift = np.where(belt, (jr - nside) & 1, 0)
    jp = (_JPLL[f] * nr + x - y + 1 + kshift) // 2
    jp = np.where(jp > 4 * nside, jp - 4 * nside, jp)
    jp = np.where(jp < 1, jp + 4 * nside, jp)
    return n_before + jp - 1


@functools.lru_cache(maxsize=None)
def ring2nest_table(nside: int) -> np.ndarray:
    """(npix,) int64: NEST index of each RING-ordered pixel."""
    x, y, f = _ring2xyf(nside, np.arange(npix_of(nside)))
    return _xyf2nest(nside, x, y, f)


@functools.lru_cache(maxsize=None)
def nest2ring_table(nside: int) -> np.ndarray:
    """(npix,) int64: RING index of each NEST-ordered pixel."""
    x, y, f = _nest2xyf(nside, np.arange(npix_of(nside)))
    return np.asarray(_xyf2ring(nside, x, y, f))


# ---------------------------------------------------------------------------
# udgrade (RING maps; degrade averages NEST children, upgrade replicates)
# ---------------------------------------------------------------------------

def udgrade_indices(nside_in: int, nside_out: int) -> np.ndarray:
    """Index table implementing RING-ordered udgrade as a gather/segment op.

    Degrade (nside_out < nside_in): returns (npix_out, ratio) int64 — RING
    indices of the input children of each output pixel (average over axis 1).
    Upgrade: returns (npix_out,) int64 — the RING index of the parent of each
    output pixel (plain gather). Mirrors the semantics of the reference's
    ``udgrade`` (comm_map_mod.f90:1043).
    """
    if nside_in == nside_out:
        return np.arange(npix_of(nside_in))
    if nside_out < nside_in:
        ratio = (nside_in // nside_out) ** 2
        # output nest pixel k has children [k*ratio, (k+1)*ratio) in nest @ nside_in
        nest_children = (ring2nest_table(nside_out)[:, None] * ratio
                         + np.arange(ratio)[None, :])
        return nest2ring_table(nside_in)[nest_children]
    ratio = (nside_out // nside_in) ** 2
    nest_parent = ring2nest_table(nside_out) // ratio
    return nest2ring_table(nside_in)[nest_parent]


def ud_map(m: np.ndarray, nside_out: int, reduce=None) -> np.ndarray:
    """A RING map (..., npix) at nside_out: a degrade applies `reduce` to
    each output pixel's children along the last axis (the mean by
    default), an upgrade copies each parent to its children."""
    nside_in = int(round(np.sqrt(m.shape[-1] / 12.0)))
    if nside_in == nside_out:
        return m
    idx = udgrade_indices(nside_in, nside_out)
    if nside_out > nside_in:
        return m[..., idx]
    return (reduce or (lambda x: np.mean(x, axis=-1)))(m[..., idx])



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


def ang2pix_ring(nside: int, theta, phi) -> np.ndarray:
    """RING pixel index of (theta, phi): the HEALPix ang2pix_ring
    algorithm, vectorized (a catalog's source positions, run.py:526).
    Returns an int64 array, or an int for scalar input."""
    theta = np.atleast_1d(np.asarray(theta, np.float64))
    phi = np.atleast_1d(np.asarray(phi, np.float64))
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2.0 * np.pi) / (0.5 * np.pi)       # in [0, 4)
    pix = np.empty(theta.shape, np.int64)

    eq = za <= 2.0 / 3.0
    if eq.any():
        t1 = nside * (0.5 + tt[eq])
        t2 = nside * 0.75 * z[eq]
        jp = np.floor(t1 - t2).astype(np.int64)
        jm = np.floor(t1 + t2).astype(np.int64)
        ir = nside + 1 + jp - jm
        kshift = 1 - (ir & 1)
        ip = (jp + jm - nside + kshift + 1) // 2
        ip = np.mod(ip, 4 * nside)
        ncap = 2 * nside * (nside - 1)
        pix[eq] = ncap + (ir - 1) * 4 * nside + ip
    po = ~eq
    if po.any():
        tp = tt[po] - np.floor(tt[po])
        tmp = nside * np.sqrt(3.0 * (1.0 - za[po]))
        jp = np.floor(tp * tmp).astype(np.int64)
        jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
        ir = jp + jm + 1
        ip = np.floor(tt[po] * ir).astype(np.int64)
        ip = np.mod(ip, 4 * ir)
        north = z[po] > 0
        ppix = np.where(north, 2 * ir * (ir - 1) + ip,
                        npix_of(nside) - 2 * ir * (ir + 1) + ip)
        pix[po] = ppix
    return pix if pix.shape else int(pix)
