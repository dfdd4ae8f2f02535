"""Residuals and chi-square diagnostics (torch).

Counterpart of commander_tpu.sampling.chisq: per-band model sky maps, the
residual and the chi-square of a set of component amplitudes against an
AmplitudeSystem: the run's own self-check. With the joint system's template
and source rows (ts, ps and their amplitudes t, p) the model sky is the full
one, diffuse plus templates plus sources (run.py's _full_sky).
"""
from __future__ import annotations

import torch

from . import joint
from .amplitude import (AmplitudeSystem, _forward_pixmix, _project_bands,
                        _synth)

# With pixel mixing (sys.F_pix) the port's model sky is the CG operator's
# own forward map, amplitude._forward_pixmix: the residuals, the chi^2, the
# gains and the MH moves see the sky the amplitudes were drawn for. The JAX
# package projects with the pixel mean F there (chisq.py:17-25; a declared
# divergence, ROADMAP queue 3 item 10). True gives the reference's form
# (the parity tests set it).
_REFERENCE_FORM = False


def sky_signal(sys: AmplitudeSystem, plan, a: torch.Tensor,
               exclude: int | None = None) -> torch.Tensor:
    """Per-band model sky maps sum_c B_b F_bc Y a_c -> (B, S, P), with
    F_bc(p) where the system has pixel mixing; exclude optionally leaves one
    component out."""
    if exclude is not None:
        a = a.clone()
        a[exclude] = 0.0
    if sys.F_pix is not None and not _REFERENCE_FORM:
        return _forward_pixmix(sys, plan, a)
    return _synth(plan, _project_bands(sys, plan, a))


def full_sky(sys: AmplitudeSystem, plan, a: torch.Tensor, ts=None, ps=None,
             t=None, p=None) -> torch.Tensor:
    """The diffuse sky plus the template and source maps of amplitudes t, p
    (where the model has them) -> (B, S, P)."""
    sky = sky_signal(sys, plan, a)
    extra = joint.extra_sky(ts, ps, t, p, sky.shape[-1])
    return sky if extra is None else sky + extra


def compute_residual(sys: AmplitudeSystem, plan, a: torch.Tensor,
                     exclude: int | None = None, ts=None, ps=None, t=None,
                     p=None) -> torch.Tensor:
    """data - model (optionally without one diffuse component's signal); the
    model includes the template and source rows where they are given."""
    r = sys.data - sky_signal(sys, plan, a, exclude=exclude)
    extra = joint.extra_sky(ts, ps, t, p, r.shape[-1])
    return r if extra is None else r - extra


def compute_chisq(sys: AmplitudeSystem, plan, a: torch.Tensor, ts=None,
                  ps=None, t=None, p=None):
    """(chisq_total, chisq_map (B, S, P), ndof): the diagonal chi-square
    sum r^2 / rms^2 over the unmasked pixels, and their count, of the full
    model."""
    r = compute_residual(sys, plan, a, ts=ts, ps=ps, t=t, p=p)
    cmap = r ** 2 * sys.inv_rms2
    return torch.sum(cmap), cmap, torch.sum(sys.inv_rms2 > 0)
