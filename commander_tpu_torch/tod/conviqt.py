"""Sidelobe convolution (conviqt): beam x sky over all rotations (torch).

Counterpart of commander_tpu.tod.conviqt (comm_conviqt_mod.f90:
precompute_sky :207, interp :159). The convolved signal of a beam b rotated
to Euler angles (phi, theta, psi) is

  s(phi, theta, psi) = sum_{m'} e^{i m' psi} f_{m'}(theta, phi),
  f_{m'}(theta, phi) = sum_{lm} a_lm conj(b_{l m'}) d^l_{m,m'}(theta) e^{im phi}

one generalized-spin synthesis per beam azimuthal mode m', through the
table SHT's Legendre stage (sht._legendre_synth, a bmm over m) with Wigner-d
tables at mp = +-m' and the plan's ring stage. A sample's value is then a
pixel gather and a cos/sin(m' psi) sum. Real sky and real beam give
f_{-m'} = conj(f_{m'}), so only m' >= 0 maps are kept:
s_t = f_0(p_t) + 2 sum_{m'>0} [Re f cos(m' psi) - Im f sin(m' psi)].
The sidelobe plan needs no Legendre tables of its own (its ring stage and
its parity and triangle masks); a tableless plan serves.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..sphere import healpix
from ..sphere.sht import (SHTPlan, _gather_pix, _legendre_synth, _table,
                          ring_synthesis)
from ..sphere.wigner import _theta_halves, wigner_d_table_fast
from ..utils.device import resolve_device


@functools.lru_cache(maxsize=8)
def _conviqt_host(nside: int, lmax: int, mmax_beam: int):
    """Host float64 d^l_{m,+m'} and d^l_{m,-m'} tables, (nh, nl, nl) each,
    for m' = 0..mmax_beam (the m' = 0 pair is one array), by the
    recurrence vectorized over m (wigner_d_table_fast: wigner_d_table's
    numbers, which the JAX package's conviqt_tables takes)."""
    cth2, sth2 = _theta_halves(nside)
    out = []
    for mp in range(mmax_beam + 1):
        dp = wigner_d_table_fast(lmax, lmax, mp, cth2, sth2)
        out.append((dp, dp if mp == 0
                    else wigner_d_table_fast(lmax, lmax, -mp, cth2, sth2)))
    return out


def conviqt_tables(nside: int, lmax: int, mmax_beam: int,
                   dtype=torch.float64, device=None) -> list:
    """Wigner-d tables d^l_{m,+-m'} for m' = 0..mmax_beam on the northern
    rings, on `device` (None: the CUDA card) in the SHT tables' m-major
    layout: a list over m' of (d_pos, d_neg) tensors (nl, nh, nl); at m' = 0
    d_neg is d_pos."""
    device = resolve_device(device)
    dtype = torch.float32 if dtype in ("float32", torch.float32) \
        else torch.float64
    out = []
    for dp, dn in _conviqt_host(nside, lmax, mmax_beam):
        tp = _table(dp, dtype, device)
        out.append((tp, tp if dn is dp else _table(dn, dtype, device)))
    return out


def conviqt_precompute(plan: SHTPlan, tables, alm: torch.Tensor,
                       blm: torch.Tensor) -> torch.Tensor:
    """f_{m'} maps for m' = 0..M.

    alm: (nl, nm) sky; blm: (nl, M+1) beam coefficients b_{l m'} (m' >= 0).
    Returns (M+1, 2, npix): [Re f_{m'}, Im f_{m'}] per beam mode
    (precompute_sky, comm_conviqt_mod.f90:207)."""
    mpos = torch.ones(plan.mmax + 1, dtype=plan.rdtype, device=plan.device)
    mpos[:1] = 0.0
    alm = alm.to(plan.cdtype)
    maps = []
    for mp, (d_pos, d_neg) in enumerate(tables):
        bc = blm[:, mp].conj().to(plan.cdtype)[:, None]
        # the positive-m coefficients through the d^l_{m,+m'} table
        Fp = _legendre_synth(plan, alm * bc, d_pos, d_neg)
        # the negative-m part: C_{-m} = (-1)^m' conj(a_lm) conj(b) d^l_{m,-m'}
        Fn = _legendre_synth(plan, alm.conj() * bc * (-1.0) ** mp, d_neg,
                             d_pos)
        f = ring_synthesis(plan, Fp) \
            + ring_synthesis(plan, Fn.conj() * mpos).conj()
        maps.append(torch.stack([_gather_pix(plan, f.real.to(plan.rdtype)),
                                 _gather_pix(plan, f.imag.to(plan.rdtype))]))
    return torch.stack(maps)


def conviqt_interp(fmaps: torch.Tensor, pix: torch.Tensor,
                   psi: torch.Tensor) -> torch.Tensor:
    """The sidelobe signal at the samples: a gather and the azimuthal
    Fourier sum (interp, comm_conviqt_mod.f90:159). fmaps: (M+1, 2, npix);
    pix / psi: (..., Nt). Returns (..., Nt) in fmaps' dtype."""
    s = fmaps[0, 0][pix]
    for mp in range(1, fmaps.shape[0]):
        ang = mp * psi
        s = s + 2.0 * (fmaps[mp, 0][pix] * torch.cos(ang)
                       - fmaps[mp, 1][pix] * torch.sin(ang))
    return s


def conviqt_interp_dets(sl_fmaps: torch.Tensor, pix: torch.Tensor,
                        psi: torch.Tensor) -> torch.Tensor:
    """conviqt_interp per detector: sl_fmaps (Nd, M+1, 2, npix_sl), pix /
    psi (Ns, Nd, Nt) -> (Ns, Nd, Nt) (the JAX package's vmap over the
    detector axis)."""
    return torch.stack([conviqt_interp(sl_fmaps[d], pix[:, d], psi[:, d])
                        for d in range(sl_fmaps.shape[0])], dim=1)


def degrade_table(nside_hi: int, nside_lo: int) -> np.ndarray:
    """(npix_hi,) int32: the RING pixel at nside_lo holding each nside_hi
    pixel centre (the reference's ind2sl mapping, comm_tod_mod.f90:312)."""
    if nside_hi == nside_lo:
        return np.arange(12 * nside_hi * nside_hi, dtype=np.int32)
    vec = np.asarray(healpix.pix2vec_ring(nside_hi))
    th = np.arccos(np.clip(vec[:, 2], -1.0, 1.0))
    ph = np.mod(np.arctan2(vec[:, 1], vec[:, 0]), 2.0 * np.pi)
    return np.asarray(healpix.ang2pix_ring(nside_lo, th, ph), np.int32)


def build_sl_fmaps(plan: SHTPlan, tables, alm_T: torch.Tensor,
                   blms: torch.Tensor) -> torch.Tensor:
    """Per-detector f-maps of the current band sky: alm_T (nl, nm) the band
    temperature alm at the sidelobe plan's lmax, blms (Nd, nl, M+1) the
    detectors' sidelobe beams. Returns (Nd, M+1, 2, npix_sl), the
    per-iteration rebuild of the reference's slconv operators
    (comm_tod_LFI_mod.f90:431-446)."""
    return torch.stack([conviqt_precompute(plan, tables, alm_T, blms[d])
                        for d in range(blms.shape[0])])


def sl_fmaps_for_band(plan_sl: SHTPlan, tables, blms: torch.Tensor,
                      alm_T: torch.Tensor) -> torch.Tensor:
    """A band's f-maps from its beam-convolved temperature alms alm_T
    (nl, nm): cut or zero-padded to the sidelobe plan's (nl_sl, nl_sl), then
    build_sl_fmaps with the detectors' beams blms (run._sl_fmaps_for_band,
    run.py:1307-1322)."""
    nl_sl = plan_sl.lmax + 1
    nl = min(nl_sl, alm_T.shape[0])
    a = torch.zeros((nl_sl, nl_sl), dtype=alm_T.dtype, device=alm_T.device)
    a[:nl, :nl] = alm_T[:nl, :nl]
    return build_sl_fmaps(plan_sl, tables, a, blms)
