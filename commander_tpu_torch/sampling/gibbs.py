"""The Gibbs step: amplitude draw, then binned C_ell draw (torch).

Counterpart of commander_tpu.sampling.gibbs for one chain, with the
reference's preconditioners (cfg.cg_precond, cfg.cg_lmax_precond) and its
CG sampling groups (cfg.groups: a sweep of per-group solves,
sampling/groups.py, in place of the one joint draw). Per step:
  1. amplitude draw  a ~ P(a | d, Cl)   [CG, sampling/amplitude.py]; with
                     template or point-source rows (ts, ps) the joint draw
                     (a, t, p) [sampling/joint.py], which takes the diagonal
                     preconditioner only, as the JAX package's does: another
                     cg_precond or cg_lmax_precond is refused there
  2. C_ell draw      Cl ~ P(Cl | a)      [inverse-gamma, model/cl.py]
With cfg.optimize the step takes the Wiener mean and the maximum-likelihood
C_b instead of draws. With cfg.cl_cfgs each component follows its own model:
binned ones are resampled, functional and fixed ones stay at base_sys.cl.
Randomness comes from an explicit torch.Generator; the draws may instead be
passed in ready-made (draws={eta1, eta2, gamma}, and eta_t, eta_p for the
joint rows) so that a run can be held to the reference's own draws.
"""
from __future__ import annotations

import dataclasses

import torch

from ..model.cl import (ClModelConfig, _bin_membership, cl_eval,
                        sample_cl_binned_invgamma, sigma_ell)
from ..utils.device import resolve_device
from . import amplitude as amp
from . import joint


@dataclasses.dataclass
class GibbsState:
    """Per-chain sampler state (the generator is passed separately)."""
    a: torch.Tensor          # (C, S, nl, nm) complex component amplitudes
    cl_bins: torch.Tensor    # (C, S, nbins) binned power parameters
    it: int = 0              # iteration counter
    cg_iters: int = 0        # diagnostics: last CG iteration count
    cg_relres: float = 0.0   # diagnostics: last CG relative residual
    # the joint system's linear amplitudes (None where the model has none)
    t: torch.Tensor | None = None   # template / md amplitudes (T,)
    p: torch.Tensor | None = None   # point-source amplitudes (nsrc,)

    def to(self, device) -> "GibbsState":
        opt = lambda x: None if x is None else x.to(device)
        return dataclasses.replace(self, a=self.a.to(device),
                                   cl_bins=self.cl_bins.to(device),
                                   t=opt(self.t), p=opt(self.p))


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
    # CG_PRECOND_TYPE ("diagonal" or "pseudoinv") and CG_LMAX_PRECOND (>= 0:
    # the dense low-ell block up to that ell, over the diagonal one)
    cg_precond: str = "diagonal"
    cg_lmax_precond: int = -1
    # CG sampling groups (groups.SampGroup, define_cg_samp_groups): when
    # non-empty the amplitude step is a Gibbs sweep of per-group
    # conditional solves (commander.f90:211-221) instead of one joint draw
    groups: tuple = ()


def init_state(ncomp, nmaps, lmax, nbins, cl0=1.0, dtype=torch.float64,
               device=None, ntemp=0, nsrc=0) -> GibbsState:
    """Zero amplitudes (and ntemp template, nsrc source amplitudes, zeros,
    where nonzero), every binned C_b at cl0."""
    device = resolve_device(device)
    nl = lmax + 1
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device) \
        if n else None
    return GibbsState(
        a=torch.zeros((ncomp, nmaps, nl, nl), dtype=cdt, device=device),
        cl_bins=torch.full((ncomp, nmaps, nbins), cl0, dtype=dtype,
                           device=device), t=zeros(ntemp), p=zeros(nsrc))


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
               draws: dict | None = None, ts=None, ps=None,
               cg_dump=None) -> GibbsState:
    """One Gibbs iteration. draws: optional {eta1, eta2, gamma} used in
    place of the generator's draws (see compute_rhs and sample_cl_all), and
    eta_t, eta_p with the joint rows (joint.compute_rhs_joint); with
    cfg.groups, "groups": one such dict per group. ts / ps: optional
    joint.TemplateSet / PtsrcSet: the amplitude step then solves the joint
    [diffuse alms | template amps | source amps] system, and the state
    carries t and p. cg_dump: optional (N, fn): without rows and groups the
    amplitudes are drawn by amplitude.sample_amplitudes_chunked, which calls
    fn(cg iteration, amplitudes) every N CG iterations
    (OUTPUT_EVERY_NTH_CG_ITERATION, run.py:1580-1604)."""
    draws = draws or {}
    cl = eval_cl_all(cfg, base_sys, state.cl_bins)
    if base_sys.ell_mask is not None:
        cl = cl * base_sys.ell_mask
    sys = dataclasses.replace(base_sys, cl=cl)
    t_new, p_new = state.t, state.p
    fluct = {} if cfg.optimize else dict(generator=generator, **{
        k: draws.get(k) for k in ("eta1", "eta2")})
    if cfg.groups:
        from . import groups as groups_mod
        a, t_new, p_new, res = groups_mod.sample_amplitudes_grouped(
            cfg.groups, sys, plan, state.a, state.t, state.p, ts, ps,
            generator=generator, draws=draws.get("groups"), tol=cfg.cg_tol,
            optimize=cfg.optimize, precond=cfg.cg_precond,
            lowl_lmax=cfg.cg_lmax_precond)
        if res is None:
            res = amp.CGResult(x=None, iters=0, rel_res=0.0, converged=True)
    elif cg_dump is not None:
        a, res = amp.sample_amplitudes_chunked(
            sys, plan, tol=cfg.cg_tol, maxiter=cfg.cg_maxiter,
            precond=cfg.cg_precond, dump_every=cg_dump[0],
            dump_fn=cg_dump[1], **fluct)
    elif ts is not None or ps is not None:
        if cfg.cg_precond != "diagonal" or cfg.cg_lmax_precond != -1:
            raise ValueError(
                f"the joint system with template or source rows takes the "
                f"diagonal preconditioner only (as the JAX package's "
                f"sample_joint does), not cg_precond={cfg.cg_precond!r}, "
                f"cg_lmax_precond={cfg.cg_lmax_precond}")
        if not cfg.optimize:
            fluct.update(eta_t=draws.get("eta_t"), eta_p=draws.get("eta_p"))
        x, res = joint.sample_joint(sys, plan, ts, ps, tol=cfg.cg_tol,
                                    maxiter=cfg.cg_maxiter, **fluct)
        a, t_new, p_new = x.a, x.t, x.p
    else:
        a, res = amp.sample_amplitudes(
            sys, plan, tol=cfg.cg_tol, maxiter=cfg.cg_maxiter,
            precond=cfg.cg_precond, lowl_lmax=cfg.cg_lmax_precond, **fluct)
    cl_bins = sample_cl_all(cfg, a, state.cl_bins, generator,
                            draws.get("gamma"))
    return GibbsState(a=a, cl_bins=cl_bins, it=state.it + 1,
                      cg_iters=res.iters, cg_relres=res.rel_res, t=t_new,
                      p=p_new)


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
