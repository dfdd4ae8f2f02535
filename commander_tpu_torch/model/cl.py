"""Angular power-spectrum (C_ell) prior models and their conditional draws.

Counterpart of commander_tpu.model.cl: per-component C_ell models {none,
binned, power_law, power_law_gauss, exp, gauss}, the S^1/2 / S^-1/2 alm
multiplies (diagonal in Stokes, or TE-coupled), and the conditional C_ell
Gibbs draws: binned inverse gamma, the TE-coupled binned inverse Wishart,
and the functional models' amplitude. Cl arrays are (nmaps, lmax+1) in C_ell
(not D_ell); S^1/2 multiplies alm[..., s, l, m] by sqrt(Cl[s, l]).

Every sampler takes a torch.Generator or its variates ready-made (normal
and Gamma(shape, 1) draws of the documented shapes), so that a run can be
held to another implementation's draws. The Cl bin-file reader and the
sigma_l writer of the reference belong to the file layer and are not here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sphere.alm import eps_weights


@dataclasses.dataclass(frozen=True)
class ClModelConfig:
    """Static config for one component's C_ell model."""
    kind: str = "none"   # none | binned | power_law | power_law_gauss | exp | gauss
    lmax: int = 0
    lmin_amp: int = 0           # ells below lmin get S = 0
    nmaps: int = 1
    bin_starts: tuple = ()      # inclusive bin starts, e.g. (0, 2, 10, ...)
    ell_pivot: int = 50         # functional kinds: pivot of (ell/pivot)
    # binned model: per-bin per-Stokes sample flags (nbins, <= 3) from a bin
    # file's stat column; empty = sample every bin
    sample_bins: tuple = ()


FUNCTIONAL_KINDS = ("power_law", "power_law_gauss", "exp", "gauss")


def bin_index_table(cfg: ClModelConfig) -> np.ndarray:
    """(lmax+1,) int: bin id of each ell (binned model)."""
    starts = np.asarray(cfg.bin_starts, dtype=np.int64)
    ells = np.arange(cfg.lmax + 1)
    return np.searchsorted(starts, ells, side="right") - 1


def cl_eval(cfg: ClModelConfig, params: dict) -> torch.Tensor:
    """Cl (..., nmaps, lmax+1) from the model's parameters.

    none:    params['cl_fix'] as it is.
    binned:  params['cl_bins'] (..., nmaps, nbins), broadcast per ell.
    functional kinds, params['amp'], params['beta'] (nmaps,), as D_l shapes
    with Cl = 2 pi D_l / (l (l+1)) and D_0 = D_1:
      power_law        D_l = amp (l/pivot)^beta
      power_law_gauss  power_law x max(exp(-l(l+1) sigma_90'^2), 1e-10)
      exp              D_l = amp exp(-beta l/pivot)
      gauss            D_l = amp max(exp(-l(l+1) sigma(beta)^2), 1e-10),
                       beta a FWHM in arcmin."""
    if cfg.kind == "none":
        return params["cl_fix"]
    if cfg.kind == "binned":
        b = params["cl_bins"]
        idx = torch.as_tensor(bin_index_table(cfg), device=b.device)
        return b[..., idx]
    if cfg.kind not in FUNCTIONAL_KINDS:
        raise ValueError(cfg.kind)
    amp = params["amp"][:, None]
    beta = params["beta"][:, None]
    ell = torch.arange(cfg.lmax + 1, dtype=amp.dtype, device=amp.device)
    x = torch.clamp(ell, min=1.0) / cfg.ell_pivot
    llp1 = ell * (ell + 1.0)
    arcmin_sigma = np.pi / 180.0 / 60.0 / np.sqrt(8.0 * np.log(2.0))
    if cfg.kind == "power_law":
        shape = x ** beta
    elif cfg.kind == "power_law_gauss":
        shape = x ** beta * torch.clamp(
            torch.exp(-llp1 * (90.0 * arcmin_sigma) ** 2), min=1e-10)
    elif cfg.kind == "exp":
        shape = torch.exp(-beta * x)
    else:
        shape = torch.clamp(torch.exp(-llp1 * (beta * arcmin_sigma) ** 2),
                            min=1e-10)
    dl = amp * shape
    dl = torch.cat([dl[:, 1:2], dl[:, 1:]], dim=1)
    return 2.0 * np.pi * dl / torch.clamp(llp1, min=1.0)


def fixed_cl_from_config(kind: str, amp, beta, lpivot: int, lmax: int,
                         nmaps: int) -> np.ndarray:
    """Numpy Cl (nmaps, lmax+1) of a fixed functional prior with per-Stokes
    (amp, beta); the E and B rows are zero below l = 2. (The reference
    never resamples the functional kinds: they are static priors.)"""
    cfg = ClModelConfig(kind=kind, lmax=lmax, nmaps=nmaps,
                        ell_pivot=max(int(lpivot), 1))
    t = lambda v: torch.as_tensor(np.broadcast_to(
        np.asarray(v, np.float64), (nmaps,)).copy())
    cl = cl_eval(cfg, {"amp": t(amp), "beta": t(beta)}).numpy()
    if nmaps > 1:
        cl[1:, :2] = 0.0
    return cl


def _sqrt_or_zero(cl: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(cl, min=0.0))


def apply_sqrtS(cl: torch.Tensor, alm: torch.Tensor) -> torch.Tensor:
    """S^1/2 a: multiply alm[..., s, l, m] by sqrt(Cl[s, l])."""
    return alm * _sqrt_or_zero(cl)[..., :, :, None]


def apply_sqrtInvS(cl: torch.Tensor, alm: torch.Tensor) -> torch.Tensor:
    """S^-1/2 a, with 0 where Cl == 0."""
    s = _sqrt_or_zero(cl)
    inv = torch.where(s > 0, 1.0 / torch.clamp(s, min=1e-300),
                      torch.zeros_like(s))
    return alm * inv[..., :, :, None]


def sigma_ell(alm: torch.Tensor, lmax: int) -> torch.Tensor:
    """Empirical sigma_l = 1/(2l+1) sum_m eps_m |a_lm|^2:
    (..., nmaps, lmax+1, mmax+1) -> (..., nmaps, lmax+1)."""
    nm = alm.shape[-1]
    rdt = alm.real.dtype
    eps = eps_weights(nm, rdt, alm.device)
    power = torch.sum(eps * alm.real ** 2 + eps * alm.imag ** 2, dim=-1)
    ell = torch.arange(lmax + 1, dtype=rdt, device=alm.device)
    return power / (2.0 * ell + 1.0)


def sigma_ell_spectra(alm: torch.Tensor, lmax: int) -> torch.Tensor:
    """Empirical auto and cross spectra, alm (nmaps, lmax+1, mmax+1) ->
    (nspec, lmax+1): TT alone for nmaps = 1; TT, TE, TB, EE, EB, BB for
    nmaps = 3 (the upper triangle, row by row)."""
    nmaps, nm = alm.shape[-3], alm.shape[-1]
    rdt = alm.real.dtype
    eps = eps_weights(nm, rdt, alm.device)
    ell = torch.arange(lmax + 1, dtype=rdt, device=alm.device)
    rows = [torch.sum(eps * (alm[..., i, :, :]
                             * alm[..., j, :, :].conj()).real, dim=-1)
            / (2.0 * ell + 1.0)
            for i in range(nmaps) for j in range(i, nmaps)]
    return torch.stack(rows, dim=0)


def _bin_membership(cfg: ClModelConfig, dtype, device) -> torch.Tensor:
    """(lmax+1, nbins) 0/1 membership of each ell in each bin. Per-bin sums
    are products with it, not index_add_: its float atomics on CUDA make a
    seeded chain's bits vary from run to run."""
    idx = torch.as_tensor(bin_index_table(cfg), device=device)
    return torch.nn.functional.one_hot(idx, len(cfg.bin_starts)).to(dtype)


def _gamma_draws(shape: torch.Tensor, generator, gamma, like: torch.Tensor):
    """The Gamma(shape, 1) variates of a sampler: `gamma` as passed in, else
    drawn from `generator`."""
    if gamma is None:
        if generator is None:
            raise ValueError("pass either gamma draws or a generator")
        gamma = gamma_marsaglia_tsang(generator, shape.contiguous())
    return torch.as_tensor(gamma).to(device=like.device, dtype=like.dtype)


def gamma_marsaglia_tsang(generator: torch.Generator,
                          shape: torch.Tensor) -> torch.Tensor:
    """Gamma(shape, 1) draws from `generator` (Marsaglia & Tsang 2000):
    d = a - 1/3, c = 1/sqrt(9d); x ~ N(0,1), v = (1 + c x)^3, accept when
    log u < x^2/2 + d - d v + d log v. Shapes below 1 use the boost
    Gamma(a) = Gamma(a + 1) U^(1/a). torch's own gamma sampler takes no
    generator, so this keeps every draw of a step on one seeded stream."""
    a = shape
    boost = a < 1.0
    d = torch.where(boost, a + 1.0, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        x = torch.randn(a.shape, generator=generator, dtype=a.dtype,
                        device=a.device)
        u = torch.rand(a.shape, generator=generator, dtype=a.dtype,
                       device=a.device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-300)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    if bool(boost.any()):
        u = torch.rand(a.shape, generator=generator, dtype=a.dtype,
                       device=a.device)
        out = torch.where(boost, out * u ** (1.0 / a), out)
    return out


def sample_cl_binned_invgamma(cfg: ClModelConfig, alm: torch.Tensor,
                              generator: torch.Generator | None = None,
                              gamma: torch.Tensor | None = None,
                              alpha0: float = -1.0, beta0: float = 0.0,
                              prev_bins: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Conditional draw of binned Cl | alm via inverse-gamma per bin:
      P(C_b | a) = InvGamma(alpha0 + n_b/2, beta0 + s_b/2),
      n_b = sum_{l in b} (2l+1),  s_b = sum_{l,m in b} eps_m |a_lm|^2.
    The Gamma(shape_b) variates come ready-made in `gamma` (nmaps, nbins)
    or are drawn from `generator`. With cfg.sample_bins and prev_bins, only
    the flagged bins are redrawn. Returns (nmaps, nbins)."""
    nbins = len(cfg.bin_starts)
    sig = sigma_ell(alm, cfg.lmax)                   # (nmaps, lmax+1)
    ell = torch.arange(cfg.lmax + 1, dtype=sig.dtype, device=sig.device)
    wl = 2.0 * ell + 1.0
    S = sig.shape[0]
    member = _bin_membership(cfg, sig.dtype, sig.device)
    ssum = (wl * sig) @ member
    nmodes = wl @ member
    shape = torch.clamp(alpha0 + nmodes / 2.0, min=0.5)
    g = _gamma_draws(shape[None, :].expand(S, nbins), generator, gamma, sig)
    draw = (beta0 + ssum / 2.0) / g
    if cfg.sample_bins and prev_bins is not None:
        sb = np.asarray(cfg.sample_bins, bool)           # (nbins, <= 3)
        m = np.zeros((S, nbins), bool)
        ns = min(S, sb.shape[1])
        m[:ns] = sb.T[:ns]
        draw = torch.where(torch.as_tensor(m, device=sig.device), draw,
                           prev_bins.to(draw))
    return draw


def sample_cl_prior(cfg: ClModelConfig, nmaps: int, alpha0: float,
                    beta0: float, generator: torch.Generator | None = None,
                    gamma: torch.Tensor | None = None,
                    dtype=torch.float64, device=None) -> torch.Tensor:
    """Forward draw C_b ~ InvGamma(alpha0, beta0) per bin; gamma (nmaps,
    nbins) optional. The draws lie on `device` (None: the generator's, or
    gamma's)."""
    if device is None:
        device = generator.device if generator is not None \
            else torch.as_tensor(gamma).device
    shape = torch.full((nmaps, len(cfg.bin_starts)), alpha0, dtype=dtype,
                       device=device)
    return beta0 / _gamma_draws(shape, generator, gamma, shape)


def _wishart_bartlett(scale_chol: torch.Tensor, nu, p: int,
                      generator: torch.Generator | None = None,
                      normal: torch.Tensor | None = None,
                      gamma: torch.Tensor | None = None) -> torch.Tensor:
    """W ~ Wishart(scale, nu) by Bartlett's decomposition; scale_chol =
    chol(scale) (..., p, p), nu a number or (...,).

    The lower-triangular factor has sqrt(chi2(nu - i)) on its diagonal and
    N(0, 1) below it. Variates: gamma (..., p) ~ Gamma((nu - i)/2, 1) (the
    chi2 is twice it) and normal (..., p(p-1)/2) in row-major order of the
    strict lower triangle, passed in or drawn from `generator`."""
    dt, dev = scale_chol.dtype, scale_chol.device
    batch = scale_chol.shape[:-2]
    df = torch.as_tensor(nu, dtype=dt, device=dev)[..., None] \
        - torch.arange(p, dtype=dt, device=dev)
    c2 = 2.0 * _gamma_draws((df / 2.0).expand(batch + (p,)), generator,
                            gamma, scale_chol)
    tril = torch.tril_indices(p, p, -1, device=dev)
    if normal is None:
        normal = torch.randn(batch + (tril.shape[1],), generator=generator,
                             dtype=dt, device=dev)
    A = torch.diag_embed(torch.sqrt(c2))
    A[..., tril[0], tril[1]] = torch.as_tensor(normal).to(A)
    LA = scale_chol @ A
    return LA @ LA.transpose(-1, -2)


def sample_cl_binned_invwishart_TE(cfg: ClModelConfig, alm: torch.Tensor,
                                   generator: torch.Generator | None = None,
                                   draws: dict | None = None):
    """TE-coupled binned C_ell draw: per bin a 2x2 (T, E) inverse-Wishart
    block, C | a ~ IW(S_b, nu = n_b - 3) under the flat prior, and a scalar
    inverse gamma for B. alm: (3, nl, nm) [T, E, B].

    draws: optional {normal (nbins, 1), gamma_w (nbins, 2), gamma_b
    (nbins,)}, the variates of _wishart_bartlett and of the B draw. Returns
    (cl_te (nbins, 2, 2), cl_b (nbins,))."""
    draws = draws or {}
    rdt, dev = alm.real.dtype, alm.device
    eps = eps_weights(alm.shape[-1], rdt, dev)
    member = _bin_membership(cfg, rdt, dev)              # (nl, nbins)
    te = alm[:2]
    # per-ell 2x2 scatter: S_l[X,Y] = sum_m eps Re(a_X conj(a_Y))
    prod = torch.sum(eps * (te[:, None] * te[None, :].conj()).real, dim=-1)
    S_b = torch.einsum("xyl,lb->bxy", prod, member)
    ell = torch.arange(cfg.lmax + 1, dtype=rdt, device=dev)
    wl = 2.0 * ell + 1.0
    nmodes = wl @ member
    eye = torch.eye(2, dtype=rdt, device=dev)
    nu = torch.clamp(nmodes - 3.0, min=2.1)
    inv_chol = torch.linalg.cholesky(torch.linalg.inv(S_b + 1e-12 * eye))
    W = _wishart_bartlett(inv_chol, nu, 2, generator,
                          draws.get("normal"), draws.get("gamma_w"))
    cl_te = torch.linalg.inv(W + 1e-30 * eye)
    sB = (wl * sigma_ell(alm[2:3], cfg.lmax)[0]) @ member
    g = _gamma_draws(torch.clamp((nmodes - 2.0) / 2.0, min=0.5), generator,
                     draws.get("gamma_b"), sB)
    return cl_te, (sB / 2.0) / g


def sqrt_psd(mat: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD matrix square root by eigh (negative eigenvalues
    clipped), batched over leading dims. The SYMMETRIC root (not Cholesky)
    keeps the CG operator S^1/2 A^T N^-1 A S^1/2 self-adjoint."""
    w, v = torch.linalg.eigh(mat)
    w = torch.sqrt(torch.clamp(w, min=0.0))
    return torch.einsum("...ij,...j,...kj->...ik", v, w, v)


def full_cl_matrix(cl_te: torch.Tensor, cl_b: torch.Tensor,
                   bin_idx) -> torch.Tensor:
    """The (nl, 3, 3) Stokes covariance from per-bin TE blocks and B
    scalars (the output of sample_cl_binned_invwishart_TE)."""
    bin_idx = torch.as_tensor(bin_idx, device=cl_b.device)
    out = torch.zeros((bin_idx.shape[0], 3, 3), dtype=cl_b.dtype,
                      device=cl_b.device)
    out[:, :2, :2] = cl_te[bin_idx]
    out[:, 2, 2] = cl_b[bin_idx]
    return out


def apply_sqrtS_TE(cl_te: torch.Tensor, cl_b: torch.Tensor, bin_idx,
                   alm: torch.Tensor) -> torch.Tensor:
    """S^1/2 with T-E coupling: alm (3, nl, nm) -> L_l @ alm with L_l =
    chol(C_l(2x2)) on (T, E) and sqrt(Cl_B) on B."""
    bin_idx = torch.as_tensor(bin_idx, device=cl_b.device)
    eye = torch.eye(2, dtype=cl_te.dtype, device=cl_te.device)
    L_l = torch.linalg.cholesky(cl_te + 1e-30 * eye)[bin_idx]  # (nl, 2, 2)
    te = torch.einsum("lxy,ylm->xlm", L_l.to(alm.dtype), alm[:2])
    b = alm[2:] * _sqrt_or_zero(cl_b[bin_idx])[None, :, None]
    return torch.cat([te, b], dim=0)


def sample_cl_powerlaw_amp(cfg: ClModelConfig, alm: torch.Tensor,
                           beta: torch.Tensor, lmin: int = 2,
                           generator: torch.Generator | None = None,
                           gamma: torch.Tensor | None = None) -> torch.Tensor:
    """Conditional amplitude draw of the functional models: with Cl = amp
    g_l(beta), P(amp | a) is inverse gamma with shape (sum_l (2l+1) - 2)/2
    and scale sum_lm eps |a_lm|^2 / g_l / 2 over l >= lmin. gamma (nmaps,)
    optional. Returns (nmaps,) draws."""
    sig = sigma_ell(alm, cfg.lmax)                   # (nmaps, nl)
    ell = torch.arange(cfg.lmax + 1, dtype=sig.dtype, device=sig.device)
    x = torch.clamp(ell, min=1.0) / cfg.ell_pivot
    beta = beta.to(sig)[:, None]
    if cfg.kind == "power_law":
        shape_l = x ** beta
    elif cfg.kind == "exp":
        shape_l = torch.exp(beta * x)
    else:
        shape_l = torch.exp(-0.5 * (x * beta) ** 2)
    g_l = 2.0 * np.pi * shape_l / torch.clamp(ell * (ell + 1.0), min=1.0)
    wl = (2.0 * ell + 1.0) * (ell >= lmin)
    scale = torch.sum(wl * sig / torch.clamp(g_l, min=1e-300), dim=-1) / 2.0
    sh = torch.clamp((torch.sum(wl) - 2.0) / 2.0, min=0.5)
    return scale / _gamma_draws(sh.expand(scale.shape), generator, gamma,
                                scale)


def wishart_dof_check(cfg: ClModelConfig) -> np.ndarray:
    """Modes per bin (for positive-definiteness checks)."""
    idx = bin_index_table(cfg)
    wl = 2 * np.arange(cfg.lmax + 1) + 1
    return np.bincount(idx, weights=wl, minlength=len(cfg.bin_starts))
