"""One whole Gibbs iteration: amplitudes, C_ell, spectral indices, with the
mixing matrix rebuilt from the current indices inside the step (torch).

Counterpart of commander_tpu.sampling.tpu_gibbs for the common production
shape (scalar spectral indices, full-sky inversion sampling, one
resolution):

    1. F(theta) mixing rebuild       (model/mixing.py, float64 quadrature)
    2. a ~ P(a | d, Cl, theta)       (sampling/gibbs.gibbs_step)
    3. Cl ~ P(Cl | a)                (the same call)
    4. theta_cj ~ P(theta | a, d)    (specind.sample_specind_fullsky, one
                                      grid per (component, parameter), in
                                      slot order, each conditioned on the
                                      draws before it)
    5. F(theta) rebuild for the next iteration.

theta stays a device tensor from one step to the next and F is rebuilt from
it on the device: the index phase reads nothing back to the host (the CG of
step 2 reads its residual norm once per iteration, as before).

Per slot the index phase runs three syntheses through the Legendre
synthesis kernel and none through the adjoint: the residual without the
slot's component (batch B), the component's amplitude map (batch 1) and,
when beam_consistent, its per-band beamed maps (batch B). A synthesis is one
wrapper call for S = 1 and three for S = 3 (spin 0, and spin 2 at mp -2 and
+2).

With template and point-source rows (ts, ps: joint.TemplateSet /
PtsrcSet) step 2 draws the joint (a, t, p) and the index phase subtracts
their maps (joint.extra_sky, made once per step) from every slot's
residual: the md, ptsrc and template signals are "other components" of the
index conditionals (tpu_gibbs.py:127-160). They add no transform.

Not ported: the reference's band-sequential synth_bands_seq / residual_seq,
which exist for a memory limit this card does not have (the batched
amplitude._synth is used throughout).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..model.mixing import DiffuseComponent, mixing_matrix
from . import amplitude as amp
from . import chisq
from . import gibbs as gibbs_mod
from . import joint
from . import specind as si

# the synthesis of the index phase's amplitude maps: that of the residual
# they are compared with
_amp_synth = amp._synth


@dataclasses.dataclass(frozen=True)
class IndexSlot:
    """Static config of one sampled spectral parameter (comp ci, slot j)."""
    ci: int
    which: int
    cfg: si.SpecIndConfig


def make_index_slots(comps: Sequence[DiffuseComponent], pcfgs=None,
                     ngrid: int = 64):
    """One IndexSlot per sampled parameter of every component with free
    parameters, with grid ranges from the parameter configs or +-50% around
    the defaults. pcfgs: optional per-component objects with an `.indices`
    mapping {name: {low, high, prior_mean, prior_rms, lnl_type}} (nu_p is
    given in GHz)."""
    slots = []
    for ci, c in enumerate(comps):
        for j, t0 in enumerate(c.theta0):
            if c.sed in ("cmb", "md", "template", "line"):
                continue
            lo = hi = pm = pr = None
            lnl = "chisq"
            if pcfgs is not None:
                info = list(pcfgs[ci].indices.values())[j] \
                    if j < len(pcfgs[ci].indices) else {}
                u = 1e9 if list(pcfgs[ci].indices.keys())[j] == "nu_p" \
                    else 1.0
                lo = None if info.get("low") is None else info["low"] * u
                hi = None if info.get("high") is None else info["high"] * u
                pm = None if info.get("prior_mean") is None \
                    else info["prior_mean"] * u
                pr = info.get("prior_rms")
                pr = pr * u if pr else None
                lnl = str(info.get("lnl_type") or "chisq")
            if lo is None or hi is None:
                lo = t0 - 0.5 * abs(t0) - 0.1
                hi = t0 + 0.5 * abs(t0) + 0.1
            slots.append(IndexSlot(ci=ci, which=j, cfg=si.SpecIndConfig(
                grid_min=float(lo), grid_max=float(hi), ngrid=ngrid,
                prior_mean=pm, prior_std=pr, lnl_type=lnl)))
    return tuple(slots)


def theta_tuple(comps, slots, thetas):
    """Per-component parameter tuples: the slots' entries of the flat
    `thetas` vector (0-d views, no copy to the host), the defaults
    elsewhere."""
    where = {(s.ci, s.which): i for i, s in enumerate(slots)}
    return [tuple(thetas[where[ci, j]] if (ci, j) in where else t0
                  for j, t0 in enumerate(c.theta0))
            for ci, c in enumerate(comps)]


def system_at(base_sys: amp.AmplitudeSystem, comps, bps, slots, thetas
              ) -> amp.AmplitudeSystem:
    """base_sys with F rebuilt from `thetas` on its device, the same for
    every Stokes parameter, in the data dtype."""
    F = mixing_matrix(comps, bps, thetas=theta_tuple(comps, slots, thetas),
                      device=base_sys.data.device)
    F = F[..., None].repeat(1, 1, base_sys.data.shape[1])
    return dataclasses.replace(base_sys, F=F.to(base_sys.data.dtype))


def sample_indices(comps, bps, slots, sys: amp.AmplitudeSystem, plan,
                   a: torch.Tensor, thetas: torch.Tensor,
                   generator: torch.Generator | None = None, u=None,
                   beam_consistent: bool = False,
                   extra_sky: torch.Tensor | None = None) -> torch.Tensor:
    """The index phase of the step: one full-sky draw per slot given the
    amplitudes a, sequential in slot order; returns the new theta vector.
    u: optional (nslot,) uniforms used in place of the generator's.
    extra_sky: optional (B, S, P) signal of the non-diffuse rows, taken out
    of every residual."""
    u = si._uniform((len(slots),), sys.data, generator, u)
    th = thetas
    for i, slot in enumerate(slots):
        sys_i = system_at(sys, comps, bps, slots, th)
        res = chisq.compute_residual(sys_i, plan, a, exclude=slot.ci)
        if extra_sky is not None:
            res = res - extra_sky
        amp_pix = _amp_synth(plan, a[slot.ci])
        # beam-consistent lnL: the component through each band's b_l, so
        # that the model has the data's resolution (B more syntheses)
        amp_band = None
        if beam_consistent:
            amp_band = _amp_synth(plan,
                                  a[slot.ci][None] * sys_i.bl[..., None])
        t_new = si.sample_specind_fullsky(
            comps[slot.ci], bps, slot.cfg, res, amp_pix, sys_i.inv_rms2,
            theta_tuple(comps, slots, th)[slot.ci], which=slot.which,
            amp_band=amp_band, u=u[i])
        th = th.clone()
        th[i] = t_new.to(th.dtype)
    return th


def full_gibbs_step(gcfg: gibbs_mod.GibbsConfig, comps, bps, slots,
                    base_sys: amp.AmplitudeSystem, plan,
                    state: gibbs_mod.GibbsState, thetas: torch.Tensor,
                    generator: torch.Generator | None = None,
                    beam_consistent: bool = False, draws: dict | None = None,
                    ts=None, ps=None):
    """One Gibbs iteration. thetas: flat (nslot,) parameter vector on the
    system's device (order = `slots`). Returns (new_state, new_thetas,
    sys_with_new_F).

    draws: optional {eta1, eta2, gamma, u}: the amplitude and C_ell draws
    of gibbs_step and the (nslot,) uniforms of the index inversions, used in
    place of the generator's (and eta_t, eta_p with ts / ps). ts / ps:
    optional joint.TemplateSet / PtsrcSet rows of the amplitude system."""
    draws = draws or {}
    sys = system_at(base_sys, comps, bps, slots, thetas)
    state = gibbs_mod.gibbs_step(gcfg, sys, plan, state, generator,
                                 draws=draws, ts=ts, ps=ps)
    extra = joint.extra_sky(ts, ps, state.t, state.p,
                            base_sys.data.shape[-1])
    th = sample_indices(comps, bps, slots, sys, plan, state.a, thetas,
                        generator, draws.get("u"), beam_consistent, extra)
    # the next iteration's operator
    return state, th, system_at(base_sys, comps, bps, slots, th)
