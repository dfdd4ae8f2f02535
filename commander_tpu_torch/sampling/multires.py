"""Multi-resolution CG: bands grouped by (nside, lmax), shared components
(torch).

Counterpart of commander_tpu.sampling.multires. The reference keeps every
band at its own resolution and loops the bands inside cr_matmulA, with lmax
projection masks between the component and the band band-limits. Here the
bands are grouped by (nside, lmax); each group is one batched
AmplitudeSystem with its own SHT plan; the component alms live at the
common component lmax and are truncated to each group's band-limit before
its synthesis and padded back after its adjoint. One operator application
runs every group's transforms in turn, each through its own plan: the
kernels' coefficient packs are cached per plan (cuda_sht), so both groups'
packs sit on the card at once and the wrappers keep no state sized by one
plan.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Sequence

import numpy as np
import torch

from ..model.cl import apply_sqrtS
from ..ops.cg import CGResult, pcg
from ..sphere.alm import alm_dot, random_alm_white, real_m0, triangle_mask
from ..utils.device import randn
from . import amplitude as amp


@dataclasses.dataclass
class MultiSystem:
    """Per-resolution-group systems and the shared component-space prior."""
    groups: tuple            # tuple[AmplitudeSystem], band-stacked per group
    cl: torch.Tensor         # (C, S, nl) at the component lmax
    tri: torch.Tensor        # (nl, nm)


def build_multi_system(group_systems: Sequence[amp.AmplitudeSystem],
                       cl) -> MultiSystem:
    """The groups' systems and the prior cl (C, S, nl), on the first
    group's device and in its dtype."""
    like = group_systems[0].data
    cl = torch.as_tensor(cl, device=like.device).to(like.dtype)
    nl = cl.shape[-1]
    tri = torch.as_tensor(triangle_mask(nl, nl), dtype=like.dtype,
                          device=like.device)
    return MultiSystem(groups=tuple(group_systems), cl=cl, tri=tri)


def _sqrtS(ms: MultiSystem, u: torch.Tensor) -> torch.Tensor:
    return real_m0(apply_sqrtS(ms.cl, u) * ms.tri)


def _truncate(a: torch.Tensor, nl_g: int) -> torch.Tensor:
    return a[..., :nl_g, :nl_g]


def _pad_back(r_g: torch.Tensor, nl: int) -> torch.Tensor:
    pad = nl - r_g.shape[-1]
    return torch.nn.functional.pad(r_g, (0, pad, 0, pad))


def apply_A_multi(ms: MultiSystem, plans: Sequence, u: torch.Tensor):
    """(1 + S^1/2 sum_g A_g^T N_g^-1 A_g S^1/2) u."""
    a = _sqrtS(ms, u)
    nl = a.shape[-1]
    r = torch.zeros_like(a)
    for sys_g, plan_g in zip(ms.groups, plans):
        a_g = _truncate(a, plan_g.lmax + 1)
        m = amp._synth(plan_g, amp._project_bands(sys_g, plan_g, a_g))
        r_b = amp._synth_T(plan_g, amp.apply_invN(sys_g, m))
        r = r + _pad_back(amp._project_bands_T(sys_g, plan_g, r_b), nl)
    return u + _sqrtS(ms, r)


def compute_rhs_multi(ms: MultiSystem, plans: Sequence,
                      generator: torch.Generator | None = None,
                      eta1: Sequence[torch.Tensor] | None = None,
                      eta2: torch.Tensor | None = None) -> torch.Tensor:
    """S^1/2 sum_g A_g^T N_g^-1 d_g, plus the fluctuation terms S^1/2 sum_g
    A_g^T N_g^-1/2 eta1_g + eta2 when a generator is given or the draws are
    passed in: eta1 one (B_g, S, P_g) N(0, 1) map per group in group order,
    eta2 (C, S, nl, nm) a white alm draw (random_alm_white), masked to the
    triangle here. A generator draws them in that order."""
    fluct = generator is not None or eta1 is not None
    C, S, nl = ms.cl.shape
    r = None
    for g, (sys_g, plan_g) in enumerate(zip(ms.groups, plans)):
        w = amp.apply_invN(sys_g, sys_g.data)
        if fluct:
            e = eta1[g] if eta1 is not None else randn(
                sys_g.data.shape, generator, sys_g.data.dtype,
                sys_g.data.device)
            w = w + amp.apply_sqrt_invN(sys_g, e.to(w))
        r_b = amp._synth_T(plan_g, w)
        contrib = _pad_back(amp._project_bands_T(sys_g, plan_g, r_b), nl)
        r = contrib if r is None else r + contrib
    rhs = _sqrtS(ms, r)
    if fluct:
        if eta2 is None:
            eta2 = random_alm_white(generator, (C, S, nl, nl),
                                    ms.cl.dtype, ms.cl.device)
        rhs = real_m0(rhs + eta2.to(rhs) * ms.tri)
    return rhs


def build_preconditioner_multi(ms: MultiSystem, plans: Sequence):
    """The per-(Stokes, ell) C x C blocks M = I + S^1/2 G S^1/2 with G
    summed over the groups (each up to its own band-limit), as the
    reference's updateDiffPrecond_diagonal sums over bands, N^-1 by its
    harmonic mean kappa_b = sum_p invN_bp / (4 pi). Built and inverted in
    float64 after Jacobi equilibration, then cast to the system's dtype, as
    amplitude.build_preconditioner does: five components on three bands
    leave G of rank 3 and M = I + a huge rank-3 part, whose float32 inverse
    loses the directions held by the priors. Returns apply(r)."""
    f64 = lambda x: x.to(torch.float64)
    C, S, nl = ms.cl.shape
    G = torch.zeros((S, nl, C, C), dtype=torch.float64, device=ms.cl.device)
    for sys_g, plan_g in zip(ms.groups, plans):
        kappa = torch.sum(sys_g.inv_rms2, dim=-1, dtype=torch.float64) \
            / (4.0 * np.pi)                                  # (B, S)
        fb = torch.einsum("bcs,bsl->bcsl", f64(sys_g.F), f64(sys_g.bl))
        Gg = torch.einsum("bcsl,bdsl,bs->slcd", fb, fb, kappa)
        G[:, :plan_g.lmax + 1] += Gg
    S_half = torch.sqrt(torch.clamp(f64(ms.cl), min=0.0)).permute(1, 2, 0)
    M = torch.eye(C, dtype=G.dtype, device=G.device) \
        + S_half[..., :, None] * G * S_half[..., None, :]
    E = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1),
                                     min=1e-30))
    Mn = M * E[..., :, None] * E[..., None, :]
    # M >= I is never singular: inv_ex leaves out the host-side check
    M_inv = (torch.linalg.inv_ex(Mn).inverse * E[..., :, None]
             * E[..., None, :]).to(ms.cl.dtype)

    def apply(r):
        return torch.einsum("slcd,dslm->cslm", M_inv.to(r.dtype), r)

    return apply


def sample_amplitudes_multi(ms: MultiSystem, plans: Sequence,
                            generator: torch.Generator | None = None,
                            eta1=None, eta2=None, x0=None, tol: float = 1e-8,
                            maxiter: int = 300
                            ) -> tuple[torch.Tensor, CGResult]:
    """Draw a ~ P(a | d, Cl) over every group (the Wiener mean without a
    generator or draws) by preconditioned CG. Returns (a, CGResult)."""
    rhs = compute_rhs_multi(ms, plans, generator, eta1, eta2)
    M_inv = build_preconditioner_multi(ms, plans)
    res = pcg(partial(apply_A_multi, ms, plans), rhs, x0=x0, M_inv=M_inv,
              dot=alm_dot, tol=tol, maxiter=maxiter)
    return _sqrtS(ms, res.x), res
