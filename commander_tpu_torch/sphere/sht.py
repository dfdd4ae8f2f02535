"""Batched spin-0 spherical-harmonic transforms on HEALPix grids (torch).

Counterpart of commander_tpu.sphere.sht, tableless only: the Legendre stage
is always the on-the-fly recurrence (sht_otf, cuda_sht). Layouts are the
reference's: alm a[..., l, m] rectangular complex (m >= 0, zero above the
triangle), maps (..., npix) in RING order. The alm inner product is
<a,b> = sum_l [a_l0 b_l0 + 2 sum_{m>0} Re(a conj(b))]; alm2map_adjoint is
the exact adjoint of alm2map under it.

Ring Fourier stage: the 2 nside + 1 equatorial-belt rings all have
nphi = 4 nside and go through one power-of-2 FFT plus a phase twist; the
2 (nside - 1) polar-cap rings go through grouped power-of-2 Bluestein
chirp-z transforms. Pixel <-> padded-ring layout uses the plan's one-shot
index gathers (pad_src/pad_valid, pix_idx).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils.device import resolve_device
from . import healpix
from .sht_otf import (LegendreOTF, adjoint_from_ring_spectra, alm2map_otf,
                      legendre_otf, map2alm_otf)


@dataclasses.dataclass
class SHTPlan:
    nside: int
    lmax: int
    mmax: int
    rdtype: torch.dtype
    cdtype: torch.dtype
    pix_idx: torch.Tensor      # (npix,) int64 into flattened (nring, pmax)
    pad_src: torch.Tensor      # (nring*pmax,) int64 into the map, clamped
    pad_valid: torch.Tensor    # (nring*pmax,) rdtype 0/1 mask
    ring_weight: torch.Tensor  # (nring,) quadrature weight per pixel of each ring
    otf0: LegendreOTF          # spin-0 on-the-fly recurrence
    # cap rings grouped by convolution length: ((i0, i1, Ls_k, La_k), ...)
    cap_groups: tuple
    belt_phase: torch.Tensor   # (nbelt, nm) e^{i m phi0_r}
    cap_sA: tuple              # per group (grows, nm)
    cap_sVh: tuple             # per group (grows, Ls_k)
    cap_sB: tuple              # per group (grows, 4*i1)
    cap_aA: tuple              # per group (grows, 4*i1)
    cap_aVh: tuple             # per group (grows, La_k)
    cap_aB: tuple              # per group (grows, nm)

    @property
    def device(self) -> torch.device:
        return self.ring_weight.device

    @property
    def nh(self) -> int:
        return 2 * self.nside

    @property
    def nring(self) -> int:
        return 4 * self.nside - 1

    @property
    def npix(self) -> int:
        return 12 * self.nside * self.nside

    @property
    def pmax(self) -> int:
        return 4 * self.nside

    @property
    def ncap(self) -> int:
        return self.nside - 1

    @property
    def nbelt(self) -> int:
        return 2 * self.nside + 1

    def to(self, device) -> "SHTPlan":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, LegendreOTF)):
                v = v.to(device)
            elif isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
                v = tuple(t.to(device) for t in v)
            kw[f.name] = v
        return SHTPlan(**kw)


def _chirp_powers(n: np.ndarray, k2: np.ndarray) -> np.ndarray:
    """exp(i*pi*k2/n) computed with k2 reduced mod 2n in exact ints."""
    red = np.mod(k2, 2 * n)
    return np.exp(1j * np.pi * red / n)


@functools.lru_cache(maxsize=None)
def _plan_host(nside: int, lmax: int, mmax: int):
    """Host float64/complex128 plan arrays (cached per resolution)."""
    g = healpix.ring_geometry(nside)
    nring, pmax, nm = g.nring, 4 * nside, mmax + 1
    m = np.arange(nm, dtype=np.int64)[None, :]

    ring_of = healpix.ring_index_of_pix(nside).astype(np.int64)
    pinring = healpix.pix_in_ring_of_pix(nside).astype(np.int64)
    pix_idx = ring_of * pmax + pinring
    pad_src = np.zeros(nring * pmax, dtype=np.int64)
    pad_valid = np.zeros(nring * pmax, dtype=np.float64)
    rr = np.repeat(np.arange(nring), pmax)
    pp = np.tile(np.arange(pmax), nring)
    ok = pp < g.nphi[rr]
    pad_src[ok] = g.offset[rr[ok]] + pp[ok]
    pad_valid[ok] = 1.0
    w = healpix.ring_weights(nside)

    nc = nside - 1
    nbelt = 2 * nside + 1
    belt_phase = np.exp(1j * g.phi0[nc: nc + nbelt, None] * m)
    groups = []
    sA, sVh, sB, aA, aVh, aB = [], [], [], [], [], []
    i0 = 0
    while i0 < nc:
        # smallest power-of-2 length with L >= nm + nphi - 1 = mmax + 4 i
        L = 1 << int(np.ceil(np.log2(mmax + 4 * (i0 + 1))))
        i1 = min(nc, (L - mmax) // 4)
        gp = 4 * i1
        rows = np.arange(i0, i1)
        nphi_c = (4 * (rows + 1)).astype(np.int64)[:, None]
        phi0_c = np.pi / nphi_c
        pc = np.arange(gp, dtype=np.int64)[None, :]
        groups.append((i0, i1, L, L))
        sA.append(np.exp(1j * phi0_c * m) * _chirp_powers(nphi_c, m * m))
        sB.append(np.where(pc < nphi_c, _chirp_powers(nphi_c, pc * pc), 0.0))
        jc = np.arange(mmax + gp, dtype=np.int64)[None, :] - mmax
        vcpad = np.zeros((len(rows), L), dtype=np.complex128)
        vcpad[:, : mmax + gp] = _chirp_powers(nphi_c, -(jc * jc))
        sVh.append(np.fft.fft(vcpad, axis=-1))
        aA.append(np.where(pc < nphi_c, _chirp_powers(nphi_c, -(pc * pc)),
                           0.0))
        aB.append(np.exp(-1j * phi0_c * m) * _chirp_powers(nphi_c, -(m * m)))
        jca = np.arange(gp + mmax, dtype=np.int64)[None, :] - (gp - 1)
        vcapad = np.zeros((len(rows), L), dtype=np.complex128)
        vcapad[:, : gp + mmax] = _chirp_powers(nphi_c, jca * jca)
        aVh.append(np.fft.fft(vcapad, axis=-1))
        i0 = i1
    return (pix_idx, pad_src, pad_valid, w, tuple(groups), belt_phase,
            sA, sVh, sB, aA, aVh, aB)


def get_plan(nside: int, lmax: int, mmax: int | None = None,
             dtype=torch.float64, device=None, tables: bool = False,
             otf_chunk: int = 64) -> SHTPlan:
    """Build the spin-0 tableless SHT plan for one resolution on `device`
    (None: the CUDA card).

    The Legendre stage is always on the fly in this port; tables=True (the
    precomputed Lambda table path of the reference) is not ported yet."""
    if tables:
        raise NotImplementedError(
            "the Legendre-table SHT path is not ported; use tables=False")
    if nside < 2:
        raise NotImplementedError(
            "nside 1 needs the whole-sphere Bluestein path, not ported")
    if mmax is None:
        mmax = lmax
    device = resolve_device(device)
    dtype = torch.float32 if dtype in ("float32", torch.float32) \
        else torch.float64
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    (pix_idx, pad_src, pad_valid, w, groups, belt_phase,
     sA, sVh, sB, aA, aVh, aB) = _plan_host(nside, lmax, mmax)
    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    devc = lambda a: torch.as_tensor(np.asarray(a), dtype=cdtype,
                                     device=device)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    return SHTPlan(
        nside=nside, lmax=lmax, mmax=mmax, rdtype=dtype, cdtype=cdtype,
        pix_idx=idx(pix_idx), pad_src=idx(pad_src), pad_valid=dev(pad_valid),
        ring_weight=dev(w),
        otf0=legendre_otf(nside, lmax, 0, dtype=dtype,
                          chunk=min(otf_chunk, lmax + 1), mmax=mmax,
                          device=device),
        cap_groups=groups, belt_phase=devc(belt_phase),
        cap_sA=tuple(devc(x) for x in sA), cap_sVh=tuple(devc(x) for x in sVh),
        cap_sB=tuple(devc(x) for x in sB), cap_aA=tuple(devc(x) for x in aA),
        cap_aVh=tuple(devc(x) for x in aVh), cap_aB=tuple(devc(x) for x in aB))


# ---------------------------------------------------------------------------
# Ring Fourier stage
# ---------------------------------------------------------------------------

def _cap_planes(plan: SHTPlan, X: torch.Tensor) -> torch.Tensor:
    """(..., nring, k) -> (..., 2, ncap, k): north caps and the flipped
    south caps (north ring i+1 and its mirror share nphi and phi0)."""
    nc, nb = plan.ncap, plan.nbelt
    return torch.stack([X[..., :nc, :],
                        torch.flip(X[..., nc + nb:, :], dims=(-2,))], dim=-3)


def _join_rings(plan: SHTPlan, caps: torch.Tensor,
                belt: torch.Tensor) -> torch.Tensor:
    return torch.cat([caps[..., 0, :, :], belt,
                      torch.flip(caps[..., 1, :, :], dims=(-2,))], dim=-2)


def ring_synthesis(plan: SHTPlan, G: torch.Tensor) -> torch.Tensor:
    """f[..., r, p] = sum_{m=0..mmax} G[..., r, m] e^{i m phi_{rp}} (complex),
    padded to (..., nring, pmax) with zeros at p >= nphi_r."""
    nc, nbelt, fourN = plan.ncap, plan.nbelt, plan.pmax
    # belt: alias-fold m modulo 4 nside, then an inverse DFT of length 4 nside
    H = G[..., nc: nc + nbelt, :] * plan.belt_phase
    nm = H.shape[-1]
    pad = (-nm) % fourN
    if pad:
        H = torch.nn.functional.pad(H, (0, pad))
    if H.shape[-1] > fourN:
        H = H.reshape(*H.shape[:-1], -1, fourN).sum(dim=-2)
    fb = torch.fft.ifft(H, n=fourN, dim=-1) * fourN
    # caps: grouped short Bluesteins over (north, south-flipped) planes
    Gc = _cap_planes(plan, G)
    outs = []
    for k, (i0, i1, Ls_k, _) in enumerate(plan.cap_groups):
        gp = 4 * i1
        U = torch.fft.fft(Gc[..., :, i0:i1, :] * plan.cap_sA[k], n=Ls_k,
                          dim=-1)
        w = torch.fft.ifft(U * plan.cap_sVh[k], n=Ls_k, dim=-1)
        fk = w[..., plan.mmax: plan.mmax + gp] * plan.cap_sB[k]
        outs.append(torch.nn.functional.pad(fk, (0, fourN - gp)))
    return _join_rings(plan, torch.cat(outs, dim=-2), fb)


def ring_analysis(plan: SHTPlan, f: torch.Tensor) -> torch.Tensor:
    """F[..., r, m] = sum_{p<nphi_r} f[..., r, p] e^{-i m phi_{rp}}."""
    nc, nbelt, fourN, nm = plan.ncap, plan.nbelt, plan.pmax, plan.mmax + 1
    # belt: F_m = e^{-im phi0} * DFTbin(m mod 4 nside)
    bins = torch.fft.fft(f[..., nc: nc + nbelt, :], n=fourN, dim=-1)
    reps = -(-nm // fourN)
    if reps > 1:
        bins = bins.repeat(*([1] * (bins.ndim - 1)), reps)
    Fb = bins[..., :nm] * plan.belt_phase.conj()
    fcap = _cap_planes(plan, f)
    outs = []
    for k, (i0, i1, _, La_k) in enumerate(plan.cap_groups):
        gp = 4 * i1
        U = torch.fft.fft(fcap[..., :, i0:i1, :gp] * plan.cap_aA[k], n=La_k,
                          dim=-1)
        w = torch.fft.ifft(U * plan.cap_aVh[k], n=La_k, dim=-1)
        outs.append(w[..., gp - 1: gp - 1 + nm] * plan.cap_aB[k])
    return _join_rings(plan, torch.cat(outs, dim=-2), Fb)


def _pad_to_rings(plan: SHTPlan, maps: torch.Tensor) -> torch.Tensor:
    """(..., npix) -> (..., nring, pmax) with zeros in invalid slots (one
    index gather; the same numbers as the reference's per-ring copies)."""
    flat = maps[..., plan.pad_src] * plan.pad_valid.to(maps.dtype)
    return flat.reshape(*maps.shape[:-1], plan.nring, plan.pmax)


def _gather_pix(plan: SHTPlan, fpad: torch.Tensor) -> torch.Tensor:
    """(..., nring, pmax) -> (..., npix)."""
    return fpad.reshape(*fpad.shape[:-2], -1)[..., plan.pix_idx]


# ---------------------------------------------------------------------------
# Public transforms — spin 0
# ---------------------------------------------------------------------------

def alm2map(plan: SHTPlan, alm: torch.Tensor) -> torch.Tensor:
    """Y: alm (..., lmax+1, mmax+1) complex -> map (..., npix) real."""
    return alm2map_otf(plan, plan.otf0, alm)


def alm2map_adjoint(plan: SHTPlan, maps: torch.Tensor) -> torch.Tensor:
    """Yt: exact adjoint of alm2map under the epsilon-weighted alm metric."""
    fpad = _pad_to_rings(plan, maps).to(plan.cdtype)
    return adjoint_from_ring_spectra(plan, plan.otf0,
                                     ring_analysis(plan, fpad))


def map2alm(plan: SHTPlan, maps: torch.Tensor) -> torch.Tensor:
    """YtW: quadrature analysis, alm ~= map2alm(alm2map(alm))."""
    return map2alm_otf(plan, plan.otf0, maps)
