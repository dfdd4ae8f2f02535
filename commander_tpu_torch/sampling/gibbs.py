"""The Gibbs step: amplitude draw, then binned C_ell draw (torch).

Counterpart of commander_tpu.sampling.gibbs for one chain and one joint CG
with the diagonal preconditioner (the reference's groups=(), no template or
point-source rows). Per step:
  1. amplitude draw  a ~ P(a | d, Cl)   [CG, sampling/amplitude.py]
  2. C_ell draw      Cl ~ P(Cl | a)      [inverse-gamma, model/cl.py]
With cfg.optimize the step takes the Wiener mean and the maximum-likelihood
C_b instead of draws. With cfg.cl_cfgs each component follows its own model:
binned ones are resampled, functional and fixed ones stay at base_sys.cl.
Randomness comes from an explicit torch.Generator; the draws may instead be
passed in ready-made (draws={eta1, eta2, gamma}) so that a run can be held
to the reference's own draws.
"""
from __future__ import annotations

import dataclasses

import torch

from ..model.cl import (ClModelConfig, _bin_membership, cl_eval,
                        sample_cl_binned_invgamma, sigma_ell)
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
    # Wiener-mean amplitudes (no fluctuation terms) and the ML C_ell update
    # in place of posterior draws
    optimize: bool = False
    # per-component C_ell model: when non-empty, component c's prior follows
    # cl_cfgs[c]. 'binned' components keep their slice of state.cl_bins
    # (their own bin_starts, padded to the shared nbins axis) and are
    # resampled; the other kinds are fixed priors taken from base_sys.cl
    cl_cfgs: tuple = ()
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
    """Per-component prior spectra (C, S, nl): binned components from their
    cl_bins slice, the others fixed at base_sys.cl."""
    if not cfg.cl_cfgs:
        return cl_eval(cfg.cl_cfg, {"cl_bins": cl_bins})
    rows = []
    for c, cc in enumerate(cfg.cl_cfgs):
        if cc.kind == "binned":
            nb = len(cc.bin_starts)
            rows.append(cl_eval(cc, {"cl_bins": cl_bins[c, :, :nb]}))
        else:
            rows.append(base_sys.cl[c])
    return torch.stack(rows)


def _ml_cl_bins(cl_cfg: ClModelConfig, a: torch.Tensor) -> torch.Tensor:
    """ML binned update C_b = s_b / n_b (the flat prior's mode), for
    optimize; a (..., S, nl, nm) -> (..., S, nbins)."""
    sig = sigma_ell(a, cl_cfg.lmax)
    ell = torch.arange(cl_cfg.lmax + 1, dtype=sig.dtype, device=sig.device)
    wl = 2.0 * ell + 1.0
    member = _bin_membership(cl_cfg, sig.dtype, sig.device)
    return ((wl * sig) @ member) / torch.clamp(wl @ member, min=1.0)


def sample_cl_all(cfg: GibbsConfig, a, cl_bins,
                  generator: torch.Generator | None = None,
                  gamma: torch.Tensor | None = None) -> torch.Tensor:
    """C_ell step for every component, by its model; gamma (C, S, nbins)
    optional (a component with fewer bins reads the head of its row)."""
    if not cfg.sample_cl:
        return cl_bins
    cfgs = cfg.cl_cfgs or (cfg.cl_cfg,) * a.shape[0]
    new_bins = cl_bins.clone()
    for c, cc in enumerate(cfgs):
        if cc.kind != "binned":
            continue                     # fixed prior: never resampled
        nb = len(cc.bin_starts)
        if cfg.optimize:
            draw = _ml_cl_bins(cc, a[c])
        else:
            draw = sample_cl_binned_invgamma(
                cc, a[c], generator=generator,
                gamma=None if gamma is None else gamma[c, :, :nb],
                alpha0=cfg.cl_alpha0, beta0=cfg.cl_beta0,
                prev_bins=cl_bins[c, :, :nb] if cfg.cl_cfgs else None)
        new_bins[c, :, :nb] = draw
    return new_bins


def gibbs_step(cfg: GibbsConfig, base_sys: amp.AmplitudeSystem, plan,
               state: GibbsState, generator: torch.Generator | None = None,
               draws: dict | None = None) -> GibbsState:
    """One Gibbs iteration. draws: optional {eta1, eta2, gamma} used in
    place of the generator's draws (see compute_rhs and sample_cl_all)."""
    draws = draws or {}
    cl = eval_cl_all(cfg, base_sys, state.cl_bins)
    if base_sys.ell_mask is not None:
        cl = cl * base_sys.ell_mask
    sys = dataclasses.replace(base_sys, cl=cl)
    if cfg.optimize:
        a, res = amp.sample_amplitudes(sys, plan, tol=cfg.cg_tol,
                                       maxiter=cfg.cg_maxiter)
    else:
        a, res = amp.sample_amplitudes(
            sys, plan, generator=generator, eta1=draws.get("eta1"),
            eta2=draws.get("eta2"), tol=cfg.cg_tol, maxiter=cfg.cg_maxiter)
    cl_bins = sample_cl_all(cfg, a, state.cl_bins, generator,
                            draws.get("gamma"))
    return GibbsState(a=a, cl_bins=cl_bins, it=state.it + 1,
                      cg_iters=res.iters, cg_relres=res.rel_res)


def run_chain(cfg: GibbsConfig, base_sys, plan, state: GibbsState,
              niter: int, generator: torch.Generator | None = None
              ) -> tuple[GibbsState, dict]:
    """niter Gibbs iterations; returns the final state and the history
    {cl_bins (niter, C, S, nbins), cg_iters (niter,), cg_relres (niter,)}."""
    bins, iters, relres = [], [], []
    for _ in range(niter):
        state = gibbs_step(cfg, base_sys, plan, state, generator)
        bins.append(state.cl_bins)
        iters.append(state.cg_iters)
        relres.append(state.cg_relres)
    hist = {"cl_bins": torch.stack(bins) if bins else state.cl_bins[:0],
            "cg_iters": torch.as_tensor(iters),
            "cg_relres": torch.as_tensor(relres)}
    return state, hist
