"""Batched spin-0 and spin-2 spherical-harmonic transforms on HEALPix grids
(torch).

Counterpart of commander_tpu.sphere.sht, tableless only: the Legendre stage
is always the on-the-fly recurrence (sht_otf, cuda_sht). Layouts are the
reference's: alm a[..., l, m] rectangular complex (m >= 0, zero above the
triangle), maps (..., npix) in RING order. The alm inner product is
<a,b> = sum_l [a_l0 b_l0 + 2 sum_{m>0} Re(a conj(b))]; alm2map_adjoint is
the exact adjoint of alm2map under it, alm2map_spin2_adjoint and
alm2map_teb_adjoint of their transforms.

Spin 2 (HEALPix convention): Q + iU = sum_lm [-(E + iB)]_lm (+2)Y_lm with m
over both signs. With lam+ = sqrt((2l+1)/4pi) d^l_{m,-2} (plan.otf_p2) and
lam- = sqrt((2l+1)/4pi) d^l_{m,+2} (plan.otf_m2) the ring spectra are
Sp = sum_l cp lam+, Sm = sum_l cm lam-, cp = -(E+iB), cm = -(E-iB), and the
mirrored south rings take the opposite-spin recurrence with the (-1)^(l+m)
fold. Each Legendre call goes through sht_otf.synth_legendre_otf /
adjoint_legendre_otf, so on a CUDA tensor it is the hand-written kernels at
mp = -2 and +2.

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
from .alm import eps_weights
from .sht_otf import (LegendreOTF, adjoint_from_ring_spectra,
                      adjoint_legendre_otf, alm2map_otf, full_rings,
                      legendre_otf, map2alm_otf, spin2_maps_from_spectra,
                      synth_legendre_otf)


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
    lmmask: torch.Tensor       # (nl, nm) 1 on m <= l
    # spin-2 recurrences (spin2=True plans): otf_p2 holds d^l_{m,-2} and
    # otf_m2 holds d^l_{m,+2}, named after the lam+ / lam- they generate
    otf_p2: LegendreOTF | None = None
    otf_m2: LegendreOTF | None = None

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
             spin2: bool = False, dtype=torch.float64, device=None,
             tables: bool = False, otf_chunk: int = 64) -> SHTPlan:
    """Build the tableless SHT plan for one resolution on `device` (None:
    the CUDA card); spin2=True adds the two spin-2 recurrences.

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
    otf = lambda mp: legendre_otf(nside, lmax, mp, dtype=dtype,
                                  chunk=min(otf_chunk, lmax + 1), mmax=mmax,
                                  device=device)
    return SHTPlan(
        nside=nside, lmax=lmax, mmax=mmax, rdtype=dtype, cdtype=cdtype,
        pix_idx=idx(pix_idx), pad_src=idx(pad_src), pad_valid=dev(pad_valid),
        ring_weight=dev(w),
        otf0=otf(0), otf_p2=otf(-2) if spin2 else None,
        otf_m2=otf(2) if spin2 else None,
        lmmask=dev(np.tril(np.ones((lmax + 1, mmax + 1)))),
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


def map2alm_iter(plan: SHTPlan, maps: torch.Tensor,
                 iters: int = 3) -> torch.Tensor:
    """Jacobi-refined analysis: alm_{k+1} = alm_k + YtW(m - Y alm_k)."""
    a = map2alm(plan, maps)
    for _ in range(iters):
        a = a + map2alm(plan, maps - alm2map(plan, a))
    return a


def map_smooth_weighted(plan: SHTPlan, maps: torch.Tensor) -> torch.Tensor:
    """Y YtW roundtrip: the map band-limited to the plan's lmax."""
    return alm2map(plan, map2alm(plan, maps))


def smooth_map(plan: SHTPlan, maps: torch.Tensor, fwhm_arcmin: float,
               iters: int = 0) -> torch.Tensor:
    """Gaussian-smooth a map in harmonic space."""
    from ..instrument.beam import gaussian_bl

    bl = torch.as_tensor(gaussian_bl(fwhm_arcmin, plan.lmax),
                         dtype=plan.rdtype, device=plan.device)
    a = map2alm_iter(plan, maps, iters) if iters else map2alm(plan, maps)
    return alm2map(plan, a * bl[:, None])


# ---------------------------------------------------------------------------
# Spin-2 Legendre stage: two calls of the spin-0-shaped stage per direction
# ---------------------------------------------------------------------------

def _need_spin2(plan: SHTPlan):
    if plan.otf_p2 is None or plan.otf_m2 is None:
        raise ValueError("plan built without spin2=True")


def _legendre_synth_spin2_otf(plan: SHTPlan, cp: torch.Tensor,
                              cm: torch.Tensor):
    """(cp, cm) (..., nl, nm) -> full-ring spectra (Sp, Sm) (..., nring, nm).

    [cp, cm] go as one batch through the lam+ recurrence and once more
    through lam-: the north rows of Sp and the (-1)^(l+m)-folded south rows
    of Sm come out of the first call, the north rows of Sm and the south
    rows of Sp out of the second (the south streams take the opposite-spin
    recurrence). The other half of each call's output is dropped: the sums
    behind it are needed all the same (F_n and F_s are sum and difference
    of one even-l and one odd-l sum)."""
    cp = (cp * plan.lmmask).to(plan.cdtype)
    cm = (cm * plan.lmmask).to(plan.cdtype)
    both = torch.stack([cp, cm])                     # (2, ..., nl, nm)
    Np2, Sp2 = synth_legendre_otf(plan.otf_p2, both, plan.nh)
    Nm2, Sm2 = synth_legendre_otf(plan.otf_m2, both, plan.nh)
    return full_rings(Np2[0], Sm2[0]), full_rings(Nm2[1], Sp2[1])


def _legendre_adjoint_spin2_otf(plan: SHTPlan, Gp: torch.Tensor,
                                K: torch.Tensor):
    """Transpose of _legendre_synth_spin2_otf: ring spectra (Gp, K)
    (..., nring, nm) -> (Up, Um) (..., nl, nm). Zero batch entries keep the
    north and south contributions apart, which the adjoint stage would
    otherwise add into one output."""
    nh = plan.nh

    def split(X):
        X_s = torch.flip(X[..., nh:, :], dims=(-2,))
        # the equator has no southern mirror: one zero row pads to nh rows
        return X[..., :nh, :], torch.nn.functional.pad(
            X_s, (0, 0, 0, nh - X_s.shape[-2]))

    Gp_n, Gp_s = split(Gp)
    K_n, K_s = split(K)
    z = torch.zeros_like(Gp_n)
    A = adjoint_legendre_otf(plan.otf_p2, torch.stack([Gp_n, z]),
                             torch.stack([z, K_s]))
    B = adjoint_legendre_otf(plan.otf_m2, torch.stack([K_n, z]),
                             torch.stack([z, Gp_s]))
    return (A[0] + B[1]) * plan.lmmask, (B[0] + A[1]) * plan.lmmask


# ---------------------------------------------------------------------------
# Public transforms — spin 2 (polarization)
# ---------------------------------------------------------------------------

def alm2map_spin2(plan: SHTPlan, alm_E: torch.Tensor, alm_B: torch.Tensor):
    """(E, B) alms (..., nl, nm) -> (Q, U) maps (..., npix)."""
    _need_spin2(plan)
    cp = -(alm_E + 1j * alm_B).to(plan.cdtype)       # coefficient of +2Y
    cm = -(alm_E - 1j * alm_B).to(plan.cdtype)       # coefficient of -2Y
    Sp, Sm = _legendre_synth_spin2_otf(plan, cp, cm)
    return spin2_maps_from_spectra(plan, Sp.to(plan.cdtype),
                                   Sm.to(plan.cdtype))


def _spin2_ring_spectra(plan: SHTPlan, Q, U, weight=None):
    """G+ = ring_analysis(P) and K = ring_analysis(conj(P)), P = Q + iU,
    optionally weighted per ring."""
    P = torch.complex(Q.to(plan.rdtype), U.to(plan.rdtype))
    fpad = _pad_to_rings(plan, P)
    if weight is not None:
        fpad = fpad * weight[:, None]
    return ring_analysis(plan, fpad), ring_analysis(plan, fpad.conj())


def alm2map_spin2_adjoint(plan: SHTPlan, Q: torch.Tensor, U: torch.Tensor):
    """Exact adjoint of alm2map_spin2 under the epsilon-weighted alm metric:
    with U+ = lam+^T G+ and U- = lam-^T K (m >= 1 only),
    E_hat = -(U+ + U-)/eps_m, B_hat = i (U+ - U-)/eps_m."""
    _need_spin2(plan)
    Gp, K = _spin2_ring_spectra(plan, Q, U)
    Up, Um = _legendre_adjoint_spin2_otf(plan, Gp, K)
    Um[..., 0] = 0.0
    eps = eps_weights(plan.mmax + 1, plan.rdtype, plan.device)
    return -(Up + Um) / eps, 1j * (Up - Um) / eps


def map2alm_spin2(plan: SHTPlan, Q: torch.Tensor, U: torch.Tensor):
    """Quadrature-weighted spin-2 analysis (YtW for polarization): the
    (+2)a_lm and (-2)a_lm estimates hold for every m >= 0."""
    _need_spin2(plan)
    Gp, K = _spin2_ring_spectra(plan, Q, U, plan.ring_weight)
    a_p2, a_m2 = _legendre_adjoint_spin2_otf(plan, Gp, K)
    return -(a_p2 + a_m2) / 2.0, 1j * (a_p2 - a_m2) / 2.0


def alm2map_teb(plan: SHTPlan, alm: torch.Tensor) -> torch.Tensor:
    """(..., 3, nl, nm) [T,E,B] alms -> (..., 3, npix) [T,Q,U] maps: spin 0
    for T, spin 2 for (E, B)."""
    T = alm2map(plan, alm[..., 0, :, :])
    Q, U = alm2map_spin2(plan, alm[..., 1, :, :], alm[..., 2, :, :])
    return torch.stack([T, Q, U], dim=-2)


def alm2map_teb_adjoint(plan: SHTPlan, maps: torch.Tensor) -> torch.Tensor:
    """Adjoint of alm2map_teb: (..., 3, npix) -> (..., 3, nl, nm)."""
    T = alm2map_adjoint(plan, maps[..., 0, :])
    E, B = alm2map_spin2_adjoint(plan, maps[..., 1, :], maps[..., 2, :])
    return torch.stack([T.to(plan.cdtype), E, B], dim=-3)


def map2alm_teb(plan: SHTPlan, maps: torch.Tensor) -> torch.Tensor:
    """Quadrature analysis [T,Q,U] -> [T,E,B] (YtW, polarized)."""
    T = map2alm(plan, maps[..., 0, :])
    E, B = map2alm_spin2(plan, maps[..., 1, :], maps[..., 2, :])
    return torch.stack([T.to(plan.cdtype), E, B], dim=-3)


def flop_count(plan: SHTPlan, spin2: bool = False) -> dict:
    """Estimated FLOPs of one synthesis with this plan, by stage (the
    adjoint costs the same by symmetry)."""
    nl, nm = plan.lmax + 1, plan.mmax + 1
    # Legendre: (nh rings x nl x nm) multiply-adds, re and im, both
    # hemispheres folded into one pass; spin 2 runs two recurrences
    leg = 2.0 * 2.0 * 2.0 * plan.nh * nl * nm * (2.0 if spin2 else 1.0)
    # ring stage: belt inverse FFT and the grouped cap Bluesteins (an fft
    # and an ifft over north and south planes), 5 N log2 N per complex FFT
    fft = 5.0 * plan.nbelt * plan.pmax * np.log2(plan.pmax)
    for i0, i1, Ls, _ in plan.cap_groups:
        fft += 2.0 * 5.0 * 2 * (i1 - i0) * Ls * np.log2(Ls)
    if spin2:
        fft *= 2.0
    return {"legendre": leg, "ring_fft": fft, "total": leg + fft}
