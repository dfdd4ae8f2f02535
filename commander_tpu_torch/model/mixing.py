"""Mixing matrix: component SEDs band-integrated per band (host float64).

Counterpart of commander_tpu.model.mixing for full-sky spectral parameters:
F[b, c] = sum_k w_bk S_c(nu_bk; theta_c) * unit_c.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..instrument.bandpass import Bandpass
from .seds import SED_REGISTRY, thermo_to_rj


@dataclasses.dataclass(frozen=True)
class DiffuseComponent:
    """Static configuration of one diffuse sky component."""
    name: str
    sed: str                 # key into SED_REGISTRY
    nu_ref: float            # reference frequency [Hz]
    theta0: tuple = ()       # spectral parameters
    unit: str = "uK_RJ"      # 'uK_cmb' (cmb comp) or 'uK_RJ' (foregrounds)


def mixing_element(comp: DiffuseComponent, bp: Bandpass) -> float:
    """F[b,c]: band response of unit component amplitude, in band units."""
    nu, w = bp.weights()
    sed_fn = SED_REGISTRY[comp.sed]
    if comp.sed == "cmb":
        vals = sed_fn(nu)
    else:
        vals = sed_fn(nu, comp.nu_ref, *comp.theta0)
    if comp.unit == "uK_RJ" or comp.sed == "cmb":
        unit_fac = 1.0
    elif comp.unit == "uK_cmb":
        unit_fac = thermo_to_rj(comp.nu_ref)
    else:
        raise ValueError(f"unsupported component unit {comp.unit}")
    return float(np.sum(w * vals) * unit_fac)


def mixing_matrix(comps: Sequence[DiffuseComponent],
                  bps: Sequence[Bandpass]) -> np.ndarray:
    """(nband, ncomp) float64 mixing matrix."""
    return np.array([[mixing_element(c, bp) for c in comps] for bp in bps])
