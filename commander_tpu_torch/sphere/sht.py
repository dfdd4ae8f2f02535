"""Batched spin-0 and spin-2 spherical-harmonic transforms on HEALPix grids
(torch).

Counterpart of commander_tpu.sphere.sht. The Legendre stage is the
on-the-fly recurrence (sht_otf, cuda_sht) by default; a plan built with
tables=True holds the Legendre tables instead (spin_lambda_north, the JAX
package's table path) and contracts them with one batched matrix product
over m (torch.bmm, cuBLAS on the card, TF32 off). Layouts are the
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

Table path: lam0 (spin 0) and, with spin2, lam_p2 = N_l d^l_{m,-2} and
lam_m2 = N_l d^l_{m,+2} on the nh northern rings, stored m-major as
(nm, nh, nl) so that each contraction sum_l st[..., l, m] lam[r, l, m] is
one bmm; the real and imaginary parts of the alms and their parity-folded
copies (the south rings, lambda(pi - theta) = (-1)^(l+m) lambda'(theta))
are stacked into the product's columns, so one pass over a table serves
both hemispheres. The port does not pick tables by itself as the JAX
package's tables=None does: every path keeps the hand-written kernels, and
tables=True is a request that raises, stating the bytes, where the tables
do not fit in the device's free memory.

Ring Fourier stage: the 2 nside + 1 equatorial-belt rings all have
nphi = 4 nside and go through one power-of-2 FFT plus a phase twist; the
2 (nside - 1) polar-cap rings go through grouped power-of-2 Bluestein
chirp-z transforms. At nside 1 (no cap rings) every ring goes through one
whole-sphere Bluestein transform. Pixel <-> padded-ring layout uses the
plan's one-shot index gathers (pad_src/pad_valid, pix_idx).
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from ..utils.device import resolve_device
from . import healpix
from .alm import eps_weights
from .wigner import spin_lambda_north
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
    otf0: LegendreOTF | None   # spin-0 on-the-fly recurrence (None: tables)
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
    # table plans (tables=True): the Legendre tables m-major (nm, nh, nl),
    # lam0 = N_l d^l_{m,0}, lam_p2 = N_l d^l_{m,-2}, lam_m2 = N_l d^l_{m,+2}
    lam0: torch.Tensor | None = None
    lam_p2: torch.Tensor | None = None
    lam_m2: torch.Tensor | None = None
    parity: torch.Tensor | None = None   # (nl, nm) (-1)^(l+m) on m <= l
    # whole-sphere Bluestein ring stage (nside 1, where no ring is a cap):
    # synthesis f_p = sum_m G_m e^{im phi_p}, analysis its conjugate twin
    synth_A: torch.Tensor | None = None  # (nring, nm) e^{im phi0} w^{m^2}
    synth_Vh: torch.Tensor | None = None  # (nring, Ls) FFT of the chirp
    synth_B: torch.Tensor | None = None  # (nring, pmax) w^{p^2}, 0 off ring
    ana_A: torch.Tensor | None = None    # (nring, pmax) w^{-p^2}
    ana_Vh: torch.Tensor | None = None   # (nring, La)
    ana_B: torch.Tensor | None = None    # (nring, nm) e^{-im phi0} w^{-m^2}
    Ls: int = 0
    La: int = 0

    @property
    def device(self) -> torch.device:
        return self.ring_weight.device

    @property
    def split(self) -> bool:
        """Whether the ring stage splits belt and caps (nside > 1)."""
        return self.nside > 1

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


def _bluestein_host(nside: int, mmax: int):
    """The whole-sphere Bluestein tables (every ring in one chirp-z
    transform; the JAX plan's synth_* / ana_* arrays)."""
    from scipy.fft import next_fast_len

    g = healpix.ring_geometry(nside)
    nring, pmax = g.nring, 4 * nside
    nphi = g.nphi.astype(np.int64)[:, None]
    m = np.arange(mmax + 1, dtype=np.int64)[None, :]
    p = np.arange(pmax, dtype=np.int64)[None, :]
    Ls = next_fast_len(pmax + 2 * mmax + 1, real=False)
    sA = np.exp(1j * g.phi0[:, None] * m) * _chirp_powers(nphi, m * m)
    sB = np.where(p < nphi, _chirp_powers(nphi, p * p), 0.0)
    # shifted chirp v[j] = w^{-j^2}, j = idx - mmax, idx = 0..mmax+pmax-1
    j = np.arange(mmax + pmax, dtype=np.int64)[None, :] - mmax
    vpad = np.zeros((nring, Ls), dtype=np.complex128)
    vpad[:, : mmax + pmax] = _chirp_powers(nphi, -(j * j))
    La = next_fast_len(2 * pmax + mmax, real=False)
    aA = np.where(p < nphi, _chirp_powers(nphi, -(p * p)), 0.0)
    aB = np.exp(-1j * g.phi0[:, None] * m) * _chirp_powers(nphi, -(m * m))
    ja = np.arange(pmax + mmax, dtype=np.int64)[None, :] - (pmax - 1)
    vapad = np.zeros((nring, La), dtype=np.complex128)
    vapad[:, : pmax + mmax] = _chirp_powers(nphi, ja * ja)
    return (sA, np.fft.fft(vpad, axis=-1), sB, aA, np.fft.fft(vapad, axis=-1),
            aB, Ls, La)


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
    belt_phase = np.exp(1j * g.phi0[nc: nc + nbelt, None] * m) \
        if nc > 0 else None
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


def table_bytes(nside: int, lmax: int, mmax: int | None = None,
                spin2: bool = False, dtype=torch.float64) -> int:
    """Bytes of a plan's Legendre tables on the device: (nh, nl, nm) per
    table, three with spin2."""
    mmax = lmax if mmax is None else mmax
    item = 4 if dtype in ("float32", torch.float32) else 8
    return 2 * nside * (lmax + 1) * (mmax + 1) * item * (3 if spin2 else 1)


def free_bytes(device: torch.device) -> int:
    """Free memory of `device`: the card's (torch.cuda.mem_get_info), or
    the host's MemAvailable for the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    with open("/proc/meminfo") as fh:
        for ln in fh:
            if ln.startswith("MemAvailable:"):
                return int(ln.split()[1]) * 1024
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _table(lam: np.ndarray, dtype, device) -> torch.Tensor:
    """(nh, nl, nm) host table -> the plan's m-major (nm, nh, nl) layout,
    laid out on the device (a strided copy there, not on the host: for a
    moment the device holds the table twice)."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    t = torch.as_tensor(lam.astype(np_dt, copy=False)).to(device)
    return t.permute(2, 0, 1).contiguous()


def get_plan(nside: int, lmax: int, mmax: int | None = None,
             spin2: bool = False, dtype=torch.float64, device=None,
             tables: bool = False, otf_chunk: int = 64) -> SHTPlan:
    """Build the SHT plan for one resolution on `device` (None: the CUDA
    card); spin2=True adds the spin-2 stage.

    tables=False (the default): the on-the-fly recurrence, the kernels on
    the card. tables=True: the Legendre tables (lam0, and lam_p2 / lam_m2
    with spin2) built on the host and moved to the device; it raises,
    stating the bytes, where they and one table's layout copy exceed the
    device's free memory (the JAX package's 2 GiB TPU-runtime guard and its
    COMMANDER_TPU_ALLOW_BIG_TABLES do not apply here). The float64 host tables of the last resolution stay
    in spin_lambda_north's cache (a float32 and a float64 plan of one
    resolution share one recurrence); spin_lambda_north.cache_clear() frees
    them."""
    if mmax is None:
        mmax = lmax
    device = resolve_device(device)
    dtype = torch.float32 if dtype in ("float32", torch.float32) \
        else torch.float64
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    if tables:
        # the tables, and one more table's bytes while the last is laid out
        need = table_bytes(nside, lmax, mmax, spin2, dtype) \
            + table_bytes(nside, lmax, mmax, False, dtype)
        free = free_bytes(device)
        if need > free:
            raise ValueError(
                f"the Legendre tables of nside {nside} / lmax {lmax} / mmax "
                f"{mmax}{' with spin 2' if spin2 else ''} need {need} bytes "
                f"({need / 2 ** 30:.2f} GiB, one table's layout copy "
                f"included) on {device}, which has {free} bytes free: use "
                f"tables=False (the on-the-fly recurrence)")
    (pix_idx, pad_src, pad_valid, w, groups, belt_phase,
     sA, sVh, sB, aA, aVh, aB) = _plan_host(nside, lmax, mmax)
    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    devc = lambda a: torch.as_tensor(np.asarray(a), dtype=cdtype,
                                     device=device)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    otf = lambda mp: legendre_otf(nside, lmax, mp, dtype=dtype,
                                  chunk=min(otf_chunk, lmax + 1), mmax=mmax,
                                  device=device)
    ll = np.arange(lmax + 1)[:, None]
    tri = np.tril(np.ones((lmax + 1, mmax + 1)))
    kw = {}
    if tables:
        kw["lam0"] = _table(spin_lambda_north(nside, lmax, 0, mmax)[0],
                            dtype, device)
        if spin2:
            lp, lm = spin_lambda_north(nside, lmax, 2, mmax)
            kw["lam_p2"], kw["lam_m2"] = (_table(lp, dtype, device),
                                          _table(lm, dtype, device))
    else:
        kw["otf0"] = otf(0)
        if spin2:
            kw["otf_p2"], kw["otf_m2"] = otf(-2), otf(2)
    if nside == 1:
        bA, bVh, bB, cA, cVh, cB, Ls, La = _bluestein_host(nside, mmax)
        kw.update(synth_A=devc(bA), synth_Vh=devc(bVh), synth_B=devc(bB),
                  ana_A=devc(cA), ana_Vh=devc(cVh), ana_B=devc(cB), Ls=Ls,
                  La=La)
    return SHTPlan(
        nside=nside, lmax=lmax, mmax=mmax, rdtype=dtype, cdtype=cdtype,
        pix_idx=idx(pix_idx), pad_src=idx(pad_src), pad_valid=dev(pad_valid),
        ring_weight=dev(w), otf0=kw.pop("otf0", None), lmmask=dev(tri),
        parity=dev((-1.0) ** (ll + np.arange(mmax + 1)[None, :]) * tri),
        cap_groups=groups,
        belt_phase=None if belt_phase is None else devc(belt_phase),
        cap_sA=tuple(devc(x) for x in sA), cap_sVh=tuple(devc(x) for x in sVh),
        cap_sB=tuple(devc(x) for x in sB), cap_aA=tuple(devc(x) for x in aA),
        cap_aVh=tuple(devc(x) for x in aVh), cap_aB=tuple(devc(x) for x in aB),
        **kw)


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


def _ring_synthesis_bluestein(plan: SHTPlan, G: torch.Tensor
                              ) -> torch.Tensor:
    """Whole-sphere Bluestein synthesis (nside 1)."""
    U = torch.fft.fft(G * plan.synth_A, n=plan.Ls, dim=-1)
    w = torch.fft.ifft(U * plan.synth_Vh, n=plan.Ls, dim=-1)
    return w[..., plan.mmax: plan.mmax + plan.pmax] * plan.synth_B


def _ring_analysis_bluestein(plan: SHTPlan, f: torch.Tensor) -> torch.Tensor:
    """Whole-sphere Bluestein analysis (nside 1)."""
    U = torch.fft.fft(f * plan.ana_A, n=plan.La, dim=-1)
    w = torch.fft.ifft(U * plan.ana_Vh, n=plan.La, dim=-1)
    return w[..., plan.pmax - 1: plan.pmax + plan.mmax] * plan.ana_B


def ring_synthesis(plan: SHTPlan, G: torch.Tensor) -> torch.Tensor:
    """f[..., r, p] = sum_{m=0..mmax} G[..., r, m] e^{i m phi_{rp}} (complex),
    padded to (..., nring, pmax) with zeros at p >= nphi_r."""
    if not plan.split:
        return _ring_synthesis_bluestein(plan, G)
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
    if not plan.split:
        return _ring_analysis_bluestein(plan, f)
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
# Legendre stage of the table plans
# ---------------------------------------------------------------------------

def _recomplex(F4: torch.Tensor):
    """(..., 2k, r, m) real stack -> k complex tensors (..., r, m)."""
    return [torch.complex(F4[..., 2 * i, :, :], F4[..., 2 * i + 1, :, :])
            for i in range(F4.shape[-3] // 2)]


def _table_product(st: torch.Tensor, lam: torch.Tensor,
                   adjoint: bool) -> torch.Tensor:
    """st (..., k, l, m) -> (..., k, r, m) = sum_l st lam[m, r, l], or with
    adjoint st (..., k, r, m) -> (..., k, l, m) = sum_r st lam[m, r, l]: one
    bmm over m with every leading entry a column (the JAX package's
    einsum "...klm,rlm->...krm" and its transpose)."""
    lead, n_in, nm = st.shape[:-2], st.shape[-2], st.shape[-1]
    x = st.reshape(-1, n_in, nm).permute(2, 1, 0)        # (nm, n_in, N)
    y = torch.bmm(lam.transpose(1, 2) if adjoint else lam, x.to(lam.dtype))
    return y.permute(2, 1, 0).reshape(*lead, y.shape[1], nm)


def _legendre_synth(plan: SHTPlan, alm: torch.Tensor, lam: torch.Tensor,
                    lam_south: torch.Tensor) -> torch.Tensor:
    """alm (..., nl, nm) complex -> F (..., nring, nm) complex.

    North rings use table `lam`, south rings `lam_south` with the parity
    sign folded into the alms. When both are one table, (re, im) of the
    alms and of their folded copy are the columns of one product: one pass
    over the table."""
    alm = alm * plan.lmmask
    ap = alm * plan.parity
    if lam is lam_south:
        st = torch.stack([alm.real, alm.imag, ap.real, ap.imag], dim=-3)
        Fn, Fs = _recomplex(_table_product(st, lam, False))
    else:
        Fn, = _recomplex(_table_product(
            torch.stack([alm.real, alm.imag], dim=-3), lam, False))
        Fs, = _recomplex(_table_product(
            torch.stack([ap.real, ap.imag], dim=-3), lam_south, False))
    return full_rings(Fn, Fs)


def _south_rows(plan: SHTPlan, F: torch.Tensor) -> torch.Tensor:
    """South-ring rows of F flipped to theta_0..theta_{nh-2} order and
    zero-padded to nh rows (to share the north table's product)."""
    Fs = torch.flip(F[..., plan.nh:, :], dims=(-2,))
    return torch.nn.functional.pad(Fs, (0, 0, 0, 1))


def _legendre_adjoint(plan: SHTPlan, F: torch.Tensor, lam: torch.Tensor,
                      lam_south: torch.Tensor) -> torch.Tensor:
    """F (..., nring, nm) complex -> alm (..., nl, nm) complex, the
    transpose of _legendre_synth."""
    Fn = F[..., : plan.nh, :]
    if lam is lam_south:
        Fs = _south_rows(plan, F)
        st = torch.stack([Fn.real, Fn.imag, Fs.real, Fs.imag], dim=-3)
        an, as_ = _recomplex(_table_product(st, lam, True))
    else:
        Fs = torch.flip(F[..., plan.nh:, :], dims=(-2,))
        an, = _recomplex(_table_product(
            torch.stack([Fn.real, Fn.imag], dim=-3), lam, True))
        as_, = _recomplex(_table_product(
            torch.stack([Fs.real, Fs.imag], dim=-3),
            lam_south[:, : plan.nh - 1], True))
    return (an + as_ * plan.parity) * plan.lmmask


def _legendre_synth_spin2(plan: SHTPlan, cp: torch.Tensor, cm: torch.Tensor):
    """Spin-2 Legendre synthesis on the tables: one pass over each of the
    two tables serves the north rows of one stream and the parity-folded
    south rows of the other. Returns the full-ring spectra (Sp, Sm)."""
    cp, cm = cp * plan.lmmask, cm * plan.lmmask
    cpp, cmp_ = cp * plan.parity, cm * plan.parity
    st_p2 = torch.stack([cp.real, cp.imag, cmp_.real, cmp_.imag], dim=-3)
    st_m2 = torch.stack([cm.real, cm.imag, cpp.real, cpp.imag], dim=-3)
    Sp_n, Sm_s = _recomplex(_table_product(st_p2, plan.lam_p2, False))
    Sm_n, Sp_s = _recomplex(_table_product(st_m2, plan.lam_m2, False))
    return full_rings(Sp_n, Sp_s), full_rings(Sm_n, Sm_s)


def _legendre_adjoint_spin2(plan: SHTPlan, Gp: torch.Tensor, K: torch.Tensor):
    """Transpose of _legendre_synth_spin2: (Up, Um) = (adj(Gp; p2, m2),
    adj(K; m2, p2)) with one pass over each table."""
    Gp_n, Gp_s = Gp[..., : plan.nh, :], _south_rows(plan, Gp)
    K_n, K_s = K[..., : plan.nh, :], _south_rows(plan, K)
    st_p2 = torch.stack([Gp_n.real, Gp_n.imag, K_s.real, K_s.imag], dim=-3)
    st_m2 = torch.stack([K_n.real, K_n.imag, Gp_s.real, Gp_s.imag], dim=-3)
    Up_n, Um_s = _recomplex(_table_product(st_p2, plan.lam_p2, True))
    Um_n, Up_s = _recomplex(_table_product(st_m2, plan.lam_m2, True))
    return ((Up_n + Up_s * plan.parity) * plan.lmmask,
            (Um_n + Um_s * plan.parity) * plan.lmmask)


# ---------------------------------------------------------------------------
# Public transforms — spin 0
# ---------------------------------------------------------------------------

def alm2map(plan: SHTPlan, alm: torch.Tensor) -> torch.Tensor:
    """Y: alm (..., lmax+1, mmax+1) complex -> map (..., npix) real."""
    if plan.lam0 is None:
        return alm2map_otf(plan, plan.otf0, alm)
    F = _legendre_synth(plan, alm.to(plan.cdtype), plan.lam0, plan.lam0)
    eps = eps_weights(plan.mmax + 1, plan.rdtype, plan.device)
    return _gather_pix(plan, ring_synthesis(plan, F * eps).real.to(
        plan.rdtype))


def alm2map_adjoint(plan: SHTPlan, maps: torch.Tensor) -> torch.Tensor:
    """Yt: exact adjoint of alm2map under the epsilon-weighted alm metric."""
    fpad = _pad_to_rings(plan, maps).to(plan.cdtype)
    F = ring_analysis(plan, fpad)
    if plan.lam0 is None:
        return adjoint_from_ring_spectra(plan, plan.otf0, F)
    return _legendre_adjoint(plan, F, plan.lam0, plan.lam0)


def map2alm(plan: SHTPlan, maps: torch.Tensor) -> torch.Tensor:
    """YtW: quadrature analysis, alm ~= map2alm(alm2map(alm))."""
    if plan.lam0 is None:
        return map2alm_otf(plan, plan.otf0, maps)
    fpad = _pad_to_rings(plan, maps) * plan.ring_weight[:, None]
    F = ring_analysis(plan, fpad.to(plan.cdtype))
    return _legendre_adjoint(plan, F, plan.lam0, plan.lam0)


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
    if (plan.otf_p2 is None or plan.otf_m2 is None) and plan.lam_p2 is None:
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
    Sp, Sm = (_legendre_synth_spin2_otf if plan.lam_p2 is None
              else _legendre_synth_spin2)(plan, cp, cm)
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
    Up, Um = (_legendre_adjoint_spin2_otf if plan.lam_p2 is None
              else _legendre_adjoint_spin2)(plan, Gp, K)
    Um[..., 0] = 0.0
    eps = eps_weights(plan.mmax + 1, plan.rdtype, plan.device)
    return -(Up + Um) / eps, 1j * (Up - Um) / eps


def map2alm_spin2(plan: SHTPlan, Q: torch.Tensor, U: torch.Tensor):
    """Quadrature-weighted spin-2 analysis (YtW for polarization): the
    (+2)a_lm and (-2)a_lm estimates hold for every m >= 0."""
    _need_spin2(plan)
    Gp, K = _spin2_ring_spectra(plan, Q, U, plan.ring_weight)
    a_p2, a_m2 = (_legendre_adjoint_spin2_otf if plan.lam_p2 is None
                  else _legendre_adjoint_spin2)(plan, Gp, K)
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
    adjoint costs the same by symmetry; a table plan's products do the
    same multiply-adds as the recurrence's)."""
    nl, nm = plan.lmax + 1, plan.mmax + 1
    # Legendre: (nh rings x nl x nm) multiply-adds, re and im, both
    # hemispheres folded into one pass; spin 2 runs two recurrences
    leg = 2.0 * 2.0 * 2.0 * plan.nh * nl * nm * (2.0 if spin2 else 1.0)
    # ring stage: belt inverse FFT and the grouped cap Bluesteins (an fft
    # and an ifft over north and south planes), 5 N log2 N per complex FFT
    fft = 5.0 * plan.nbelt * plan.pmax * np.log2(plan.pmax)
    for i0, i1, Ls, _ in plan.cap_groups:
        fft += 2.0 * 5.0 * 2 * (i1 - i0) * Ls * np.log2(Ls)
    if not plan.split:      # the whole-sphere Bluestein plan (nside 1)
        fft = 2.0 * 5.0 * plan.nring * plan.Ls * np.log2(plan.Ls)
    if spin2:
        fft *= 2.0
    return {"legendre": leg, "ring_fft": fft, "total": leg + fft}
