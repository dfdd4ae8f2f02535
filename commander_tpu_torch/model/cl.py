"""Binned angular power-spectrum prior and its conditional Gibbs draw.

Counterpart of commander_tpu.model.cl for the binned C_ell model: Cl arrays
are (nmaps, lmax+1) in C_ell; S^1/2 multiplies alm[..., s, l, m] by
sqrt(Cl[s, l]); the conditional draw is the diagonal-Stokes inverse-gamma
reduction of the reference's inverse-Wishart.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sphere.alm import eps_weights


@dataclasses.dataclass(frozen=True)
class ClModelConfig:
    """Static config for one component's C_ell model."""
    kind: str = "binned"        # the only model this port has
    lmax: int = 0
    nmaps: int = 1
    bin_starts: tuple = ()      # inclusive bin starts, e.g. (0, 2, 10, ...)


def bin_index_table(cfg: ClModelConfig) -> np.ndarray:
    """(lmax+1,) int: bin id of each ell (binned model)."""
    starts = np.asarray(cfg.bin_starts, dtype=np.int64)
    ells = np.arange(cfg.lmax + 1)
    return np.searchsorted(starts, ells, side="right") - 1


def cl_eval(cfg: ClModelConfig, params: dict) -> torch.Tensor:
    """Cl (nmaps, lmax+1) from the binned parameters params['cl_bins']
    (..., nmaps, nbins), broadcast per ell."""
    if cfg.kind != "binned":
        raise NotImplementedError(f"Cl model {cfg.kind!r} is not ported")
    b = params["cl_bins"]
    idx = torch.as_tensor(bin_index_table(cfg), device=b.device)
    return b[..., idx]


def apply_sqrtS(cl: torch.Tensor, alm: torch.Tensor) -> torch.Tensor:
    """S^1/2 a: multiply alm[..., s, l, m] by sqrt(Cl[s, l])."""
    return alm * torch.sqrt(torch.clamp(cl, min=0.0))[..., :, :, None]


def sigma_ell(alm: torch.Tensor, lmax: int) -> torch.Tensor:
    """Empirical sigma_l = 1/(2l+1) sum_m eps_m |a_lm|^2:
    (..., nmaps, lmax+1, mmax+1) -> (..., nmaps, lmax+1)."""
    nm = alm.shape[-1]
    rdt = alm.real.dtype
    eps = eps_weights(nm, rdt, alm.device)
    power = torch.sum(eps * alm.real ** 2 + eps * alm.imag ** 2, dim=-1)
    ell = torch.arange(lmax + 1, dtype=rdt, device=alm.device)
    return power / (2.0 * ell + 1.0)


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
                              alpha0: float = -1.0, beta0: float = 0.0
                              ) -> torch.Tensor:
    """Conditional draw of binned Cl | alm via inverse-gamma per bin:
      P(C_b | a) = InvGamma(alpha0 + n_b/2, beta0 + s_b/2),
      n_b = sum_{l in b} (2l+1),  s_b = sum_{l,m in b} eps_m |a_lm|^2.
    The Gamma(shape_b) variates come ready-made in `gamma` (nmaps, nbins)
    or are drawn from `generator`. Returns (nmaps, nbins)."""
    idx = torch.as_tensor(bin_index_table(cfg), device=alm.device)
    nbins = len(cfg.bin_starts)
    sig = sigma_ell(alm, cfg.lmax)                   # (nmaps, lmax+1)
    ell = torch.arange(cfg.lmax + 1, dtype=sig.dtype, device=sig.device)
    wl = 2.0 * ell + 1.0
    S = sig.shape[0]
    # per-bin sums as a product with the (lmax+1, nbins) bin membership, not
    # index_add_: its float atomics on CUDA make a seeded chain's bits vary
    # from run to run
    member = torch.nn.functional.one_hot(idx, nbins).to(sig.dtype)
    ssum = (wl * sig) @ member
    nmodes = wl @ member
    shape = torch.clamp(alpha0 + nmodes / 2.0, min=0.5)
    if gamma is None:
        if generator is None:
            raise ValueError("pass either gamma draws or a generator")
        gamma = gamma_marsaglia_tsang(generator,
                                      shape[None, :].expand(S, nbins)
                                      .contiguous())
    return (beta0 + ssum / 2.0) / gamma.to(device=sig.device, dtype=sig.dtype)
