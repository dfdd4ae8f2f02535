"""SEDs of the slice's diffuse components (host numpy, float64).

Counterpart of commander_tpu.model.seds for cmb, power_law and MBB: each SED
is a function of frequency [Hz] and the component's spectral parameters,
returning the brightness-temperature (uK_RJ) response normalized so the
component amplitude is in its natural unit at its reference frequency.
"""
from __future__ import annotations

import numpy as np

from ..utils.constants import H_OVER_K, T_CMB


def x_of(nu):
    """Dimensionless h nu / k T_cmb (prescaled h/k, constants.H_OVER_K)."""
    return nu * (H_OVER_K / T_CMB)


def thermo_to_rj(nu):
    """dT_RJ / dT_cmb at frequency nu: x^2 e^x / (e^x - 1)^2."""
    x = x_of(nu)
    ex = np.exp(x)
    return x * x * ex / np.square(ex - 1.0)


def sed_cmb(nu, theta=()):
    """CMB: amplitude in uK_cmb, response in uK_RJ."""
    return thermo_to_rj(nu)


def sed_powlaw(nu, nu_ref, beta):
    """Power law (synchrotron): (nu/nu_ref)^beta."""
    return np.exp(beta * np.log(nu / nu_ref))


def sed_mbb(nu, nu_ref, beta, T_d):
    """Modified blackbody (thermal dust):
    (nu/nu0)^(beta+1) (exp(h nu0/k T)-1)/(exp(h nu/k T)-1)."""
    x0 = H_OVER_K * nu_ref / T_d
    x = H_OVER_K * nu / T_d
    return np.exp((beta + 1.0) * np.log(nu / nu_ref)) * np.expm1(x0) \
        / np.expm1(x)


SED_REGISTRY = {
    "cmb": sed_cmb,
    "power_law": sed_powlaw,
    "MBB": sed_mbb,
}
