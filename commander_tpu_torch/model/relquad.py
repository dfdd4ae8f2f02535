"""CMB relativistic (dipole-induced) quadrupole template (host numpy).

Copied from commander_tpu.model.relquad (the reference's
comm_cmb_relquad_comp_mod.f90): the kinematic quadrupole induced by the solar
dipole beta = v/c,
  dT_quad(n) = T_cmb q(x) [(beta . n)^2 - <(beta . n)^2>]
with the frequency factor q(x) = x (e^x + 1) / (2 (e^x - 1)), x = h nu /
(k T_cmb): a fixed per-band template in uK_cmb whose amplitude is known, or
sampled as a template row of the joint system (sampling/joint.py).
"""
from __future__ import annotations

import numpy as np

from ..sphere import healpix
from ..utils.constants import H_OVER_K, T_CMB

# Solar dipole (Planck 2018): amplitude 3362.08 uK toward (l, b) =
# (264.021, 48.253) deg galactic.
DIPOLE_AMP_UK = 3362.08
DIPOLE_DIR_GAL = (264.021, 48.253)


def dipole_unit_vector() -> np.ndarray:
    lon, lat = np.deg2rad(DIPOLE_DIR_GAL)
    return np.array([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)])


def relquad_template(nside: int, nu: float) -> np.ndarray:
    """(npix,) float64 uK_cmb template at band frequency nu [Hz] (pencil
    beam)."""
    beta_amp = DIPOLE_AMP_UK / (T_CMB * 1e6)
    n = healpix.pix2vec_ring(nside)
    bn = beta_amp * (n @ dipole_unit_vector())
    x = nu * (H_OVER_K / T_CMB)
    q = x * (np.exp(x) + 1.0) / (2.0 * np.expm1(x))
    # the monopole part of (b.n)^2 is subtracted: a pure quadrupole
    quad = bn**2 - np.mean(bn**2)
    return (T_CMB * 1e6) * q * quad


def solar_dipole_map(nside: int) -> np.ndarray:
    """(npix,) float64 uK_cmb solar dipole map."""
    n = healpix.pix2vec_ring(nside)
    return DIPOLE_AMP_UK * (n @ dipole_unit_vector())
