"""On-the-fly SHT (spin 0 and spin 2): chunked Legendre recurrence (torch).

Counterpart of commander_tpu.sphere.sht_otf. The Legendre functions
lambda_lm(theta_r) = sqrt((2l+1)/4pi) d^l_{m,mp}(theta_r) on the nh = 2 nside
northern rings are regenerated by the scaled three-term recurrence instead of
being stored (the table would be 33 GB at nside 1024 / lmax 2000).

float32 safety: the recurrence carries a per-(ring, m) block exponent in
units of 2^_SCALE_POW; values are emitted only while the exponent is in
{0, -1, -2}.

The Legendre stage dispatches on the tensor's device (cuda_sht): a CUDA
tensor goes to the hand-written kernels, a CPU tensor to the plain chunked
recurrence below (synth_legendre_chunked / adjoint_legendre_chunked), which
is also the kernels' plain version.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import healpix
from ..utils.device import resolve_device
from .alm import eps_weights

_SCALE_POW = 30  # rescale granularity 2^30 (f32-safe)


@dataclasses.dataclass
class LegendreOTF:
    """Recurrence data for d^l_{m,mp} on the northern rings."""
    seed_mant: torch.Tensor   # (nh, nm) seed mantissa at l0(m) = max(m, |mp|)
    seed_exp: torch.Tensor    # (nh, nm) int32 block exponent (<= 0)
    A: torch.Tensor           # (nl, nm) recurrence alpha = A*x + Bc
    Bc: torch.Tensor          # (nl, nm)
    beta: torch.Tensor        # (nl, nm)
    x: torch.Tensor           # (nh,) cos(theta)
    norm: torch.Tensor        # (nl,) sqrt((2l+1)/4pi)
    parity_m: torch.Tensor    # (nm,) (-1)^m
    m_vals: torch.Tensor      # (nm,) int64 m of each column
    nside: int
    lmax: int
    mmax: int
    mp: int
    chunk: int

    def to(self, device) -> "LegendreOTF":
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if isinstance(v, torch.Tensor):
                kw[k] = v.to(device)
        return LegendreOTF(**kw)


def _seed_log(nside: int, mp: int, mmax: int):
    """log |d^l0_{m,mp}(theta_r)| and its sign at the seeding ell
    l0 = max(m, |mp|), on the nh northern rings: two (nh, nm) arrays."""
    from scipy.special import gammaln

    nm = mmax + 1
    th = healpix.ring_geometry(nside).theta[: 2 * nside]
    cth2, sth2 = np.cos(th / 2.0), np.sin(th / 2.0)
    m = np.arange(nm, dtype=np.float64)[None, :]
    amp = abs(mp)

    with np.errstate(divide="ignore"):
        lc, ls = np.log(cth2)[:, None], np.log(sth2)[:, None]
    hi = m >= amp
    logc_hi = 0.5 * (gammaln(2 * m + 1) - gammaln(m + mp + 1)
                     - gammaln(m - mp + 1))
    logv_hi = logc_hi + (m + mp) * lc + (m - mp) * ls
    sign_hi = np.broadcast_to((-1.0) ** (m - mp), logv_hi.shape)
    logc_lo = 0.5 * (gammaln(2 * amp + 1) - gammaln(amp + m + 1)
                     - gammaln(amp - m + 1))
    if mp > 0:
        logv_lo = logc_lo + (mp + m) * lc + (mp - m) * ls
        sign_lo = np.ones_like(logv_hi)
    else:
        logv_lo = logc_lo + (amp - m) * lc + (amp + m) * ls
        sign_lo = np.broadcast_to((-1.0) ** (amp + m), logv_hi.shape)
    return np.where(hi, logv_hi, logv_lo), np.where(hi, sign_hi, sign_lo)


def _split_seed(logv: np.ndarray, sign: np.ndarray):
    """Seed value sign * e^logv as (float64 mantissa, int32 block exponent
    in units of 2^_SCALE_POW); exponent -128 means "never emit"."""
    lbig = _SCALE_POW * np.log(2.0)
    # mantissa normalized into (2^-30, 1]: representable seeds sit at exp 0
    seed_exp = np.minimum(np.ceil(logv / lbig), 0.0)
    seed_mant = sign * np.exp(logv - seed_exp * lbig)
    bad = ~np.isfinite(logv)
    seed_mant[bad] = 0.0
    seed_exp[bad] = -128.0
    return seed_mant, seed_exp.astype(np.int32)


def _rec_coeffs(lmax: int, mp: int, mmax: int):
    """(A, Bc, beta), each (nl, nm): d_{l+1} = (A x + Bc) d_l - beta d_{l-1}
    for the unnormalized d^l_{m,mp}; zero where undefined."""
    m = np.arange(mmax + 1, dtype=np.float64)[None, :]
    ell = np.arange(lmax + 1, dtype=np.float64)[:, None]
    wl1 = np.sqrt(np.maximum(((ell + 1) ** 2 - m**2)
                             * ((ell + 1) ** 2 - mp**2), 0.0)) / (ell + 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        wl = np.where(ell > 0,
                      np.sqrt(np.maximum((ell**2 - m**2) * (ell**2 - mp**2),
                                         0.0)) / np.maximum(ell, 1), 0.0)
        A = (2 * ell + 1) / wl1
        Bc = -(2 * ell + 1) * (m * mp) / np.maximum(ell * (ell + 1), 1) / wl1
        beta = wl / wl1
    for arr in (A, Bc, beta):
        arr[~np.isfinite(arr)] = 0.0
    return A, Bc, beta


def ell_norm(ell) -> np.ndarray:
    """sqrt((2l+1)/4pi)."""
    return np.sqrt((2 * np.asarray(ell, dtype=np.float64) + 1) / (4 * np.pi))


@functools.lru_cache(maxsize=None)
def _otf_host(nside: int, lmax: int, mp: int, mmax: int):
    """Host float64 recurrence data (the numpy half of legendre_otf)."""
    seed_mant, seed_exp = _split_seed(*_seed_log(nside, mp, mmax))
    A, Bc, beta = _rec_coeffs(lmax, mp, mmax)
    return (seed_mant, seed_exp, A, Bc, beta,
            healpix.ring_geometry(nside).z[: 2 * nside],
            ell_norm(np.arange(lmax + 1)))


def legendre_otf(nside: int, lmax: int, mp: int, dtype=torch.float32,
                 chunk: int = 64, mmax: int | None = None,
                 device=None) -> LegendreOTF:
    """Recurrence data on `device` (None: the CUDA card)."""
    if mmax is None:
        mmax = lmax
    device = resolve_device(device)
    seed_mant, seed_exp, A, Bc, beta, x, norm = _otf_host(nside, lmax, mp,
                                                          mmax)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    nm = mmax + 1
    return LegendreOTF(
        seed_mant=t(seed_mant),
        seed_exp=torch.as_tensor(seed_exp, device=device),
        A=t(A), Bc=t(Bc), beta=t(beta), x=t(x), norm=t(norm),
        parity_m=t((-1.0) ** np.arange(nm)),
        m_vals=torch.arange(nm, device=device),
        nside=nside, lmax=lmax, mmax=mmax, mp=mp, chunk=chunk)


def _rec_step(otf: LegendreOTF, carry, l: int):
    """One l-step of the scaled recurrence; emits the normalized lambda row
    (nh, nm) at l and advances the carry to l+1."""
    dt = otf.seed_mant.dtype
    big = 2.0 ** _SCALE_POW
    bigi = 2.0 ** -_SCALE_POW
    prev, prev_e, cur, cur_e = carry
    start = torch.clamp(otf.m_vals, min=abs(otf.mp)) == l
    cur = torch.where(start, otf.seed_mant, cur)
    cur_e = torch.where(start, otf.seed_exp, cur_e)
    prev = torch.where(start, torch.zeros_like(prev), prev)
    prev_e = torch.where(start, torch.zeros_like(prev_e), prev_e)
    zero = torch.zeros((), dtype=dt, device=cur.device)
    emit = torch.where(cur_e == 0, cur,
                       torch.where(cur_e == -1, cur * bigi,
                                   torch.where(cur_e == -2,
                                               cur * (bigi * bigi), zero)))
    if l > otf.lmax:
        emit = torch.zeros_like(emit)
        lc = otf.lmax
    else:
        emit = emit * otf.norm[l]
        lc = l
    # recurrence l -> l+1
    alpha = otf.A[lc] * otf.x[:, None] + otf.Bc[lc]
    de = prev_e - cur_e
    one = torch.ones((), dtype=dt, device=cur.device)
    sc = torch.where(de == 0, one, torch.where(de <= -1, one * bigi,
                                               one * big))
    sc = torch.where(de <= -2, zero, sc)
    new = alpha * cur - otf.beta[lc] * prev * sc
    grow = torch.abs(new) > big
    new = torch.where(grow, new * bigi, new)
    cur_scaled = torch.where(grow, cur * bigi, cur)
    # the divided cur carries the incremented exponent too, else the
    # beta*prev term is double-scaled on the step after a rescale (~1e8
    # mode amplification at nside 512 when this was wrong)
    new_e = cur_e + grow.to(cur_e.dtype)
    return (cur_scaled, new_e, new, new_e), emit


def _init_rec_carry(otf: LegendreOTF):
    z = torch.zeros_like(otf.seed_mant)
    zi = torch.zeros_like(otf.seed_exp)
    return (z, zi, z, zi - 128)


def _lam_chunk(otf: LegendreOTF, carry, l0: int):
    """Run the recurrence over ells l0..l0+L-1: (carry, lam (L, nh, nm))."""
    rows = []
    for l in range(l0, l0 + otf.chunk):
        carry, emit = _rec_step(otf, carry, l)
        rows.append(emit)
    return carry, torch.stack(rows)


def _even_weights(otf: LegendreOTF, l0: int) -> torch.Tensor:
    """(L, nm) weight of the even-(l+m) subspace for ells l0..l0+L-1."""
    ls = torch.arange(l0, l0 + otf.chunk, device=otf.parity_m.device)
    sign_l = (1 - 2 * (ls % 2)).to(otf.parity_m.dtype)
    return 0.5 * (1.0 + sign_l[:, None] * otf.parity_m[None, :])


def _contract(a: torch.Tensor, lam: torch.Tensor, eq: str) -> torch.Tensor:
    """Complex x real einsum done as two real einsums (torch.einsum needs
    one dtype)."""
    return torch.complex(torch.einsum(eq, a.real.contiguous(), lam),
                         torch.einsum(eq, a.imag.contiguous(), lam))


def synth_legendre_chunked(otf: LegendreOTF, alm: torch.Tensor, nh: int):
    """alm (..., nl, nm) complex -> (F_n, F_s) (..., nh, nm) in otf's dtype.

    F_n = sum_l lambda_lm a_lm, F_s = sum_l (-1)^(l+m) lambda_lm a_lm. A
    Python loop over l-chunks: each chunk regenerates a (L, nh, nm) Lambda
    block and contracts it with the alm chunk, split by (l+m) parity."""
    L = otf.chunk
    nl = otf.lmax + 1
    cdt = torch.complex128 if otf.seed_mant.dtype == torch.float64 \
        else torch.complex64
    alm = alm.to(cdt)
    carry = _init_rec_carry(otf)
    Fe = Fo = None
    for l0 in range(0, nl, L):
        carry, lam = _lam_chunk(otf, carry, l0)
        a_c = alm[..., l0:l0 + L, :]
        nlc = a_c.shape[-2]
        even = _even_weights(otf, l0)[:nlc]
        lam = lam[:nlc]
        fe = _contract(a_c * even, lam, "...lm,lrm->...rm")
        fo = _contract(a_c * (1.0 - even), lam, "...lm,lrm->...rm")
        Fe = fe if Fe is None else Fe + fe
        Fo = fo if Fo is None else Fo + fo
    return Fe + Fo, Fe - Fo


def adjoint_legendre_chunked(otf: LegendreOTF, F_n: torch.Tensor,
                             F_s: torch.Tensor) -> torch.Tensor:
    """(F_n, F_s) (..., nh, nm) -> alm (..., nl, nm): the exact transpose
    a_lm = sum_r lambda_lm(r) [F_n + (-1)^(l+m) F_s]."""
    L = otf.chunk
    nl = otf.lmax + 1
    cdt = torch.complex128 if otf.seed_mant.dtype == torch.float64 \
        else torch.complex64
    Ge = (F_n + F_s).to(cdt)      # couples to even (l+m) terms
    Go = (F_n - F_s).to(cdt)
    carry = _init_rec_carry(otf)
    parts = []
    for l0 in range(0, nl, L):
        carry, lam = _lam_chunk(otf, carry, l0)
        even = _even_weights(otf, l0)
        a_e = _contract(Ge, lam, "...rm,lrm->...lm") * even
        a_o = _contract(Go, lam, "...rm,lrm->...lm") * (1.0 - even)
        parts.append(a_e + a_o)
    return torch.cat(parts, dim=-2)[..., :nl, :]


def synth_legendre_otf(otf: LegendreOTF, alm: torch.Tensor, nh: int):
    """Legendre synthesis, dispatched on alm's device (cuda_sht); a strided
    view (one Stokes row of a batch, say) is copied to a dense tensor."""
    from .cuda_sht import synth_legendre
    return synth_legendre(otf, alm.contiguous(), nh)


def adjoint_legendre_otf(otf: LegendreOTF, F_n: torch.Tensor,
                         F_s: torch.Tensor) -> torch.Tensor:
    """Legendre adjoint, dispatched on the spectra's device (cuda_sht)."""
    from .cuda_sht import adjoint_legendre
    return adjoint_legendre(otf, F_n.contiguous(), F_s.contiguous())


def full_rings(north: torch.Tensor, south_half: torch.Tensor):
    """(..., nh, nm) north rows and the mirrored south rows, equator first
    -> (..., 2 nh - 1, nm) full-ring spectra (the equator has no mirror)."""
    south = torch.flip(south_half[..., : north.shape[-2] - 1, :], dims=(-2,))
    return torch.cat([north, south], dim=-2)


def synth_spin2_otf(otf_p: LegendreOTF, otf_m: LegendreOTF,
                    cp: torch.Tensor, cm: torch.Tensor, nh: int):
    """Spin-2 Legendre stage, both recurrences in one chunk loop (plain
    torch, any device).

    cp = -(E+iB), cm = -(E-iB) (..., nl, nm). Returns the full-ring spectra
    (Sp, Sm) (..., nring, nm) of the +2 and -2 harmonics:
      Sp_north = sum_l cp lam+,  Sp_south = sum_l cp (-1)^(l+m) lam-
      Sm_north = sum_l cm lam-,  Sm_south = sum_l cm (-1)^(l+m) lam+
    with lam+ from otf_p (the mp = -2 recurrence) and lam- from otf_m
    (mp = +2). The second route to the spectra that
    sht._legendre_synth_spin2_otf composes from two synth_legendre_otf calls.
    """
    L = otf_p.chunk
    nl = otf_p.lmax + 1
    cdt = torch.complex128 if otf_p.seed_mant.dtype == torch.float64 \
        else torch.complex64
    c2 = torch.stack([cp, cm]).to(cdt)               # (2, ..., nl, nm)
    rec_p, rec_m = _init_rec_carry(otf_p), _init_rec_carry(otf_m)
    acc = None
    for l0 in range(0, nl, L):
        rec_p, lam_p = _lam_chunk(otf_p, rec_p, l0)
        rec_m, lam_m = _lam_chunk(otf_m, rec_m, l0)
        c_c = c2[..., l0:l0 + L, :]
        nlc = c_c.shape[-2]
        even = _even_weights(otf_p, l0)[:nlc]
        ce, co = c_c * even, c_c * (1.0 - even)
        # even/odd sums against both recurrences: (Ep, Op, Em, Om)
        terms = [_contract(c, lam[:nlc], "...lm,lrm->...rm")
                 for lam in (lam_p, lam_m) for c in (ce, co)]
        acc = terms if acc is None else [a + t for a, t in zip(acc, terms)]
    Ep, Op, Em, Om = acc
    Sp = full_rings(Ep[0] + Op[0], Em[0] - Om[0])
    Sm = full_rings(Em[1] + Om[1], Ep[1] - Op[1])
    return Sp, Sm


# ---------------------------------------------------------------------------
# Public transforms
# ---------------------------------------------------------------------------

def spin2_maps_from_spectra(plan, Sp: torch.Tensor, Sm: torch.Tensor):
    """(Q, U) from the +2 / -2 ring spectra:
    P(p) = sum_{m>=0} Sp_m e^{im phi} + sum_{m>=1} conj(Sm_m) e^{-im phi},
    Q = Re P, U = Im P (the tail shared by both spin-2 synthesis routes)."""
    from .sht import _gather_pix, ring_synthesis

    Sm = Sm.clone()
    Sm[..., 0] = 0.0
    P = ring_synthesis(plan, Sp) + ring_synthesis(plan, Sm).conj()
    return (_gather_pix(plan, P.real.to(plan.rdtype)),
            _gather_pix(plan, P.imag.to(plan.rdtype)))


def alm2map_spin2_otf(plan, otf_p: LegendreOTF, otf_m: LegendreOTF,
                      alm_E: torch.Tensor, alm_B: torch.Tensor):
    """Spin-2 synthesis through synth_spin2_otf: same semantics as
    sht.alm2map_spin2, (E, B) alms -> (Q, U) maps."""
    cp = -(alm_E + 1j * alm_B).to(plan.cdtype)
    cm = -(alm_E - 1j * alm_B).to(plan.cdtype)
    Sp, Sm = synth_spin2_otf(otf_p, otf_m, cp, cm, plan.nh)
    return spin2_maps_from_spectra(plan, Sp.to(plan.cdtype),
                                   Sm.to(plan.cdtype))


def alm2map_otf(plan, otf: LegendreOTF, alm: torch.Tensor) -> torch.Tensor:
    """Y without tables: same semantics as sht.alm2map."""
    from .sht import _gather_pix, ring_synthesis

    alm = alm.to(plan.cdtype)
    F_n, F_s = synth_legendre_otf(otf, alm, plan.nh)
    south = torch.flip(F_s[..., : plan.nh - 1, :], dims=(-2,))
    F = torch.cat([F_n, south], dim=-2)
    eps = eps_weights(plan.mmax + 1, plan.rdtype, plan.device)
    f = ring_synthesis(plan, F * eps)
    return _gather_pix(plan, f.real.to(plan.rdtype))


def adjoint_from_ring_spectra(plan, otf: LegendreOTF,
                              F: torch.Tensor) -> torch.Tensor:
    """Legendre-adjoint of full-ring spectra F (..., nring, nm) on the fly
    (the tail shared by Yt and YtW)."""
    F_n = F[..., : plan.nh, :]
    F_s = torch.flip(F[..., plan.nh:, :], dims=(-2,))
    # the equator has no southern mirror: one zero row pads F_s to nh rows
    F_s = torch.nn.functional.pad(F_s, (0, 0, 0, plan.nh - F_s.shape[-2]))
    return adjoint_legendre_otf(otf, F_n, F_s)


def map2alm_otf(plan, otf: LegendreOTF, maps: torch.Tensor) -> torch.Tensor:
    """YtW without tables: same semantics as sht.map2alm."""
    from .sht import _pad_to_rings, ring_analysis

    fpad = _pad_to_rings(plan, maps) * plan.ring_weight[:, None]
    F = ring_analysis(plan, fpad.to(plan.cdtype))
    return adjoint_from_ring_spectra(plan, otf, F)
