"""Bandpass model: quadrature nodes and unit-normalized weights (host numpy).

Counterpart of commander_tpu.instrument.bandpass (Bandpass, delta_bandpass)
without bandpass shifts: the band average of a uK_RJ spectral shape S is
F = sum_k w_k S(nu_k).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..model.seds import thermo_to_rj

_UNIT_SCALE = {"uK_cmb": 1.0, "mK_cmb": 1e-3, "K_cmb": 1e-6, "uK_RJ": 1.0}


@dataclasses.dataclass(frozen=True)
class Bandpass:
    """One band's bandpass as quadrature nodes.

    nu: (nnode,) frequencies [Hz]; tau: (nnode,) raw RJ transmission;
    unit: output unit of the band map."""
    nu: np.ndarray
    tau: np.ndarray
    unit: str = "uK_cmb"

    def weights(self):
        """(nu, w) with w normalized so that the band's 1-unit reference
        spectrum integrates to 1 (trapezoid quadrature; one node for a
        delta bandpass)."""
        nu = np.asarray(self.nu, np.float64)
        if nu.size == 1:
            base = np.ones((1,))
        else:
            dnu = np.gradient(nu)
            dnu[0] *= 0.5
            dnu[-1] *= 0.5
            base = np.asarray(self.tau, np.float64) * dnu
        scale = _UNIT_SCALE.get(self.unit)
        if scale is None:
            raise ValueError(f"unsupported band unit {self.unit}")
        if self.unit == "uK_RJ":
            norm = np.sum(base)
        else:
            norm = np.sum(base * thermo_to_rj(nu)) / scale
        return nu, base / norm


def delta_bandpass(nu0: float, unit: str = "uK_cmb") -> Bandpass:
    """Delta-function bandpass at nu0 (reference profile type 'delta')."""
    return Bandpass(nu=np.array([nu0]), tau=np.array([1.0]), unit=unit)
