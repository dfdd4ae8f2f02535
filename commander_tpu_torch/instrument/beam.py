"""Beams (host numpy): Gaussian b_ell and the HEALPix pixel window.

Counterpart of commander_tpu.instrument.beam: gaussian_bl, pixel_window and
pixel_window_exact. The pixel window is computed from its definition (the
reference reads HEALPix's pixel_window FITS files): exactly by sub-pixel
quadrature for nside <= 128, and above that by rescaling the exact nside-128
table in l / nside. The nside-128 table ships with the port
(instrument/data/pixwin_n128_l383_r8.npy, a copy of the JAX package's);
other exact tables are cached on disk under the user's cache directory
($XDG_CACHE_HOME or ~/.cache, in commander_tpu_torch/).
"""
from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def gaussian_bl(fwhm_arcmin: float, lmax: int, pol: bool = False
                ) -> np.ndarray:
    """Gaussian temperature b_ell, (lmax+1,); with pol=True (lmax+1, 3) [T,
    E, B], the E and B rows times the spin-2 factor exp(2 sigma^2)."""
    sigma = np.deg2rad(fwhm_arcmin / 60.0) / np.sqrt(8.0 * np.log(2.0))
    ell = np.arange(lmax + 1)
    g = np.exp(-0.5 * ell * (ell + 1) * sigma**2)
    if not pol:
        return g
    pol_fac = np.exp(2.0 * sigma**2)
    return np.stack([g, g * pol_fac, g * pol_fac], axis=-1)


@functools.lru_cache(maxsize=None)
def pixel_window(nside: int, lmax: int) -> np.ndarray:
    """HEALPix pixel window w_ell, (lmax+1,): pixel_window_exact for nside
    <= 128, else the exact nside-128 table (lmax 383) interpolated at
    l * 128 / nside (the window is close to a function of l / nside alone;
    the rescaling errs by under 1% at l <= 2 nside)."""
    if nside <= 128:
        return pixel_window_exact(nside, lmax)
    base_n, base_lmax = 128, 383
    w128 = pixel_window_exact(base_n, base_lmax)
    x = np.arange(lmax + 1, dtype=np.float64) * base_n / nside
    return np.interp(x, np.arange(base_lmax + 1, dtype=np.float64), w128)


def _pixwin_cache_path(nside: int, lmax: int, ratio: int) -> str:
    root = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    d = os.path.join(root, "commander_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"pixwin_n{nside}_l{lmax}_r{ratio}.npy")


@functools.lru_cache(maxsize=None)
def pixel_window_exact(nside: int, lmax: int, ratio: int = 8) -> np.ndarray:
    """Exact HEALPix pixel window by sub-pixel quadrature:
        w_l^2 = 4 pi / (npix (2l+1)) sum_{m,p} |<Y_lm>_p|^2,
    <Y_lm>_p the mean of Y_lm over pixel p by the midpoint rule on its
    ratio^2 children at nside * ratio (relative error O((l / (nside
    ratio))^2), ~1e-3 at l = 3 nside). One azimuthal quadrant of each ring
    is summed (HEALPix's 4-fold symmetry), and per ring the sum over pixels
    goes through the small Gram matrix of the children's phases. The
    shipped table or the disk cache is read where it holds (nside, lmax,
    ratio); a new table is written to the cache."""
    from ..sphere import healpix
    from ..sphere.wigner import wigner_d_table_fast

    name = f"pixwin_n{nside}_l{lmax}_r{ratio}.npy"
    for cand in (os.path.join(_DATA, name),
                 _pixwin_cache_path(nside, lmax, ratio)):
        if os.path.exists(cand):
            w = np.load(cand)
            if w.shape == (lmax + 1,):
                return w

    g = healpix.ring_geometry(nside)
    fac = ratio * ratio
    r2n = healpix.ring2nest_table(nside)
    n2r = healpix.nest2ring_table(nside * ratio)
    th_hi, ph_hi = healpix.pix2ang_ring(nside * ratio)
    eps = np.concatenate([[1.0], 2.0 * np.ones(lmax)])
    m = np.arange(lmax + 1)
    acc = np.zeros(lmax + 1)
    for ring in range(g.nring):
        nq = max(int(g.nphi[ring]) // 4, 1)
        p_lo = g.offset[ring] + np.arange(nq)
        child = r2n[p_lo][:, None] * fac + np.arange(fac)[None, :]
        cr = n2r[child]                         # (nq, fac) hi-res RING pix
        th, ph = th_hi[cr], ph_hi[cr]
        uth, tidx = np.unique(th, return_inverse=True)
        tidx = tidx.reshape(th.shape)
        # lambda_lm(theta) = sqrt((2l+1)/4pi) d^l_{m0}(theta); the sqrt
        # factor goes into the final normalization
        d = wigner_d_table_fast(lmax, lmax, 0,
                                np.cos(uth / 2.0), np.sin(uth / 2.0))
        phase = np.exp(1j * m[None, None, :] * ph[..., None])  # (nq,fac,nm)
        P = np.zeros((nq, len(uth), lmax + 1), np.complex128)
        np.add.at(P, (np.arange(nq)[:, None].repeat(fac, 1), tidx), phase)
        # sum_p |sum_t d_t P_pt|^2 = sum_{t,t'} d_t d_t' G_tt'
        G = np.einsum("ptm,pum->tum", P, np.conj(P)).real
        acc += 4.0 * np.einsum("m,tlm,ulm,tum->l", eps, d, d, G,
                               optimize=True) / (fac * fac)
    # |<Y>|^2 = (2l+1)/4pi |A|^2, so w^2 = sum / npix
    w = np.sqrt(np.maximum(acc / g.npix, 0.0))
    try:
        np.save(_pixwin_cache_path(nside, lmax, ratio), w)
    except OSError:
        pass
    return w
