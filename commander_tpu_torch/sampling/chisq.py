"""Residuals and chi-square diagnostics (torch).

Counterpart of commander_tpu.sampling.chisq: per-band model sky maps, the
residual and the chi-square of a set of component amplitudes against an
AmplitudeSystem: the run's own self-check.
"""
from __future__ import annotations

import torch

from .amplitude import AmplitudeSystem, _project_bands, _synth


def sky_signal(sys: AmplitudeSystem, plan, a: torch.Tensor,
               exclude: int | None = None) -> torch.Tensor:
    """Per-band model sky maps sum_c B_b F_bc Y a_c -> (B, S, P); exclude
    optionally leaves one component out."""
    if exclude is not None:
        a = a.clone()
        a[exclude] = 0.0
    return _synth(plan, _project_bands(sys, plan, a))


def compute_residual(sys: AmplitudeSystem, plan, a: torch.Tensor,
                     exclude: int | None = None) -> torch.Tensor:
    """data - model (optionally without one component's signal)."""
    return sys.data - sky_signal(sys, plan, a, exclude=exclude)


def compute_chisq(sys: AmplitudeSystem, plan, a: torch.Tensor):
    """(chisq_total, chisq_map (B, S, P), ndof): the diagonal chi-square
    sum r^2 / rms^2 over the unmasked pixels, and their count."""
    r = compute_residual(sys, plan, a)
    cmap = r ** 2 * sys.inv_rms2
    return torch.sum(cmap), cmap, torch.sum(sys.inv_rms2 > 0)
