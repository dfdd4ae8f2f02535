"""The Gibbs step: amplitude draw, then binned C_ell draw (torch).

Counterpart of commander_tpu.sampling.gibbs for one chain, all components
binned and one joint CG (the reference's cl_cfgs=(), groups=(), diagonal
preconditioner, posterior draws rather than 'optimize'). Per step:
  1. amplitude draw  a ~ P(a | d, Cl)   [CG, sampling/amplitude.py]
  2. C_ell draw      Cl ~ P(Cl | a)      [inverse-gamma, model/cl.py]
Randomness comes from an explicit torch.Generator; the draws may instead be
passed in ready-made (draws={eta1, eta2, gamma}) so that a run can be held
to the reference's own draws.
"""
from __future__ import annotations

import dataclasses

import torch

from ..model.cl import ClModelConfig, cl_eval, sample_cl_binned_invgamma
from ..utils.device import resolve_device
from . import amplitude as amp


@dataclasses.dataclass
class GibbsState:
    """Per-chain sampler state (the generator is passed separately)."""
    a: torch.Tensor          # (C, S, nl, nm) complex component amplitudes
    cl_bins: torch.Tensor    # (C, S, nbins) binned power parameters
    it: int = 0              # iteration counter
    cg_iters: int = 0        # diagnostics: last CG iteration count
    cg_relres: float = 0.0   # diagnostics: last CG relative residual

    def to(self, device) -> "GibbsState":
        return dataclasses.replace(self, a=self.a.to(device),
                                   cl_bins=self.cl_bins.to(device))


@dataclasses.dataclass(frozen=True)
class GibbsConfig:
    """Static configuration of the Gibbs step."""
    cl_cfg: ClModelConfig
    cg_tol: float = 1e-7
    cg_maxiter: int = 300
    sample_cl: bool = True
    # InvGamma(alpha0, beta0) hyperprior on binned C_b; (-1, 0) is flat
    cl_alpha0: float = -1.0
    cl_beta0: float = 0.0


def init_state(ncomp, nmaps, lmax, nbins, cl0=1.0, dtype=torch.float64,
               device=None) -> GibbsState:
    device = resolve_device(device)
    nl = lmax + 1
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    return GibbsState(
        a=torch.zeros((ncomp, nmaps, nl, nl), dtype=cdt, device=device),
        cl_bins=torch.full((ncomp, nmaps, nbins), cl0, dtype=dtype,
                           device=device))


def eval_cl_all(cfg: GibbsConfig, base_sys, cl_bins) -> torch.Tensor:
    """Per-component prior spectra (C, S, nl) from the binned parameters."""
    return cl_eval(cfg.cl_cfg, {"cl_bins": cl_bins})


def sample_cl_all(cfg: GibbsConfig, a, cl_bins,
                  generator: torch.Generator | None = None,
                  gamma: torch.Tensor | None = None) -> torch.Tensor:
    """C_ell step for every component; gamma (C, S, nbins) optional."""
    if not cfg.sample_cl:
        return cl_bins
    rows = [sample_cl_binned_invgamma(
        cfg.cl_cfg, a[c], generator=generator,
        gamma=None if gamma is None else gamma[c],
        alpha0=cfg.cl_alpha0, beta0=cfg.cl_beta0)
        for c in range(a.shape[0])]
    return torch.stack(rows)


def gibbs_step(cfg: GibbsConfig, base_sys: amp.AmplitudeSystem, plan,
               state: GibbsState, generator: torch.Generator | None = None,
               draws: dict | None = None) -> GibbsState:
    """One Gibbs iteration. draws: optional {eta1, eta2, gamma} used in
    place of the generator's draws (see compute_rhs and sample_cl_all)."""
    draws = draws or {}
    cl = eval_cl_all(cfg, base_sys, state.cl_bins)
    sys = dataclasses.replace(base_sys, cl=cl)
    a, res = amp.sample_amplitudes(
        sys, plan, generator=generator, eta1=draws.get("eta1"),
        eta2=draws.get("eta2"), tol=cfg.cg_tol, maxiter=cfg.cg_maxiter)
    cl_bins = sample_cl_all(cfg, a, state.cl_bins, generator,
                            draws.get("gamma"))
    return GibbsState(a=a, cl_bins=cl_bins, it=state.it + 1,
                      cg_iters=res.iters, cg_relres=res.rel_res)
