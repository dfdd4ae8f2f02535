"""Metropolis-Hastings moves: the joint alm-C_ell rescaling (torch).

Counterpart of the part of commander_tpu.sampling.mh that run()'s host loop
reaches: sample_joint_alm_cl (mh.py:28-55; the reference's
sample_joint_alm_Cl, comm_signal_mod.f90:554-680), the resampling mode's
move (RESAMPLE_CMB) that proposes C_ell' per bin and rescales the
component's alms deterministically by sqrt(C'/C), accepting on the data
likelihood (the prior terms cancel by construction of the proposal). The
bandpass-shift moves of the same module belong to the host TOD branch, which
is not ported (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from ..model.cl import bin_index_table
from ..utils.device import rand, randn
from .chisq import compute_chisq


def sample_joint_alm_cl(cfg, sys, plan, a: torch.Tensor,
                        cl_bins: torch.Tensor, comp: int,
                        step_size: float = 0.05,
                        generator: torch.Generator | None = None,
                        draws: dict | None = None):
    """One joint (alm, C_ell) MH move for component `comp`: per bin a
    log-normal step C' = C exp(eps), the alms scaled by sqrt(C'/C) per ell,
    accepted on -1/2 (chi^2' - chi^2) + sum(eps) (the log-normal proposal's
    asymmetry). cfg: the component's binned ClModelConfig. draws: optional
    {"eps": (S, nbins) unit normals, "u": a uniform} used in place of the
    generator's. Returns (a', cl_bins', accepted) with accepted a 0-d bool
    tensor (nothing is read back to the host)."""
    rdt, dev = a.real.dtype, a.device
    shape = tuple(cl_bins.shape[-2:])
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the draws")
        draws = {"eps": randn(shape, generator, rdt, dev),
                 "u": rand((), generator, rdt, dev)}
    eps = step_size * torch.as_tensor(draws["eps"], device=dev).to(rdt)
    cl_new = cl_bins.clone()
    cl_new[comp] = cl_bins[comp] * torch.exp(eps)
    idx = torch.as_tensor(bin_index_table(cfg), device=dev)
    scale = torch.sqrt(torch.exp(eps)[..., idx])              # (S, nl)
    a_new = a.clone()
    a_new[comp] = a[comp] * scale[..., :, None].to(a.dtype)
    chi2_old, _, _ = compute_chisq(sys, plan, a)
    chi2_new, _, _ = compute_chisq(sys, plan, a_new)
    ln_r = -0.5 * (chi2_new - chi2_old) + torch.sum(eps)
    accept = torch.log(torch.as_tensor(draws["u"], device=dev).to(rdt)) \
        < ln_r
    return (torch.where(accept, a_new, a),
            torch.where(accept, cl_new, cl_bins), accept)
