"""Gaussian harmonic beams (host numpy); counterpart of
commander_tpu.instrument.beam.gaussian_bl."""
from __future__ import annotations

import numpy as np


def gaussian_bl(fwhm_arcmin: float, lmax: int) -> np.ndarray:
    """Gaussian temperature b_ell, (lmax+1,)."""
    sigma = np.deg2rad(fwhm_arcmin / 60.0) / np.sqrt(8.0 * np.log(2.0))
    ell = np.arange(lmax + 1)
    return np.exp(-0.5 * ell * (ell + 1) * sigma**2)
