"""Bandpass model: profiles, unit conversions, band integration (torch).

Counterpart of commander_tpu.instrument.bandpass: a bandpass is a set of
quadrature nodes (nu_k, w_k) such that the band average of a uK_RJ spectral
shape S is F = sum_k w_k S(nu_k). The quadrature is evaluated directly, in
float64, on the device where the spectral parameters live, so that the
mixing matrix can be rebuilt inside a Gibbs step with no host round trip.

Two normalization families (the reference's profile types delta, LFI, WMAP,
HFI_cmb, PSM_LFI, HFI_submm, DIRBE differ only in these and in the output
unit): tau responding to RJ brightness temperature (radiometers), or to
specific intensity (bolometers), where the RJ-temperature response picks up
an extra nu^2. Bandpass shifts (additive_shift nu -> nu + delta, powlaw_tilt)
re-derive the weights from the stored raw profile.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..model.seds import thermo_to_rj
from ..utils.constants import C_LIGHT, H_OVER_K, K_BOLTZ, T_CMB
from ..utils.device import resolve_device

_UNIT_SCALE = {"uK_cmb": 1.0, "mK_cmb": 1e-3, "K_cmb": 1e-6,
               "uK_RJ": 1.0, "MJy/sr": 1.0}

_INTENSITY_PROFILES = ("HFI_cmb", "PSM_LFI", "HFI_submm", "DIRBE")


def a2t(nu):
    """uK_RJ -> uK_cmb conversion factor at nu: 1/thermo_to_rj."""
    return 1.0 / thermo_to_rj(nu)


def rj_to_MJysr(nu):
    """uK_RJ -> MJy/sr: 2 k nu^2 / c^2 * 1e-6 K/uK * 1e20 (MJy)."""
    return 2.0 * K_BOLTZ * (nu / C_LIGHT) ** 2 * 1e-6 * 1e20


@dataclasses.dataclass(frozen=True)
class Bandpass:
    """One detector/band bandpass as quadrature nodes.

    nu:  (nnode,) frequencies [Hz], host numpy
    tau: (nnode,) raw transmission profile (arbitrary normalization)
    unit: output unit of the band map ('uK_cmb', 'mK_cmb', 'K_cmb', 'uK_RJ',
          'MJy/sr')
    profile_type: the reference's profile family. It decides what the stored
          tau responds to: RJ brightness temperature (delta / tophat / LFI /
          WMAP / dame) or specific intensity (HFI_cmb / PSM_LFI / HFI_submm /
          DIRBE).
    """
    nu: np.ndarray
    tau: np.ndarray
    unit: str = "uK_cmb"
    profile_type: str = "tophat"
    # per device, made at first use there: float64 copies of (nu, tau), and
    # the unshifted (nu, w) (a Gibbs step rebuilds F from new spectral
    # indices many times at shift 0; other shifts are not kept)
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def nu_c(self) -> float:
        """Effective center frequency."""
        return float(np.sum(self.nu * self.tau) / np.sum(self.tau))

    def nodes(self, device=None):
        """(nu, tau) as float64 tensors on `device` (None: the CUDA card)."""
        key = str(resolve_device(device))
        if key not in self._on_device:
            self._on_device[key] = tuple(
                torch.as_tensor(np.asarray(a, np.float64), device=key)
                for a in (self.nu, self.tau))
        return self._on_device[key]

    def weights(self, delta=0.0, shift_model: str = "additive_shift",
                device=None):
        """Quadrature nodes and normalized weights after a bandpass shift.

        Returns (nu_eff, w), float64 tensors on `device` (None: delta's
        device when it is a tensor, else the CUDA card; the CPU only by
        name), with w such that the band
        response to a uK_RJ spectral shape S(nu) in the band's output unit
        is sum_k w_k S(nu_k). The RJ-temperature response is rho = tau
        (RJ-defined profiles) or tau (nu/nu_c)^2 (intensity-defined), and
        the band value in unit U is
            F = int rho S dnu / int rho T_ref,U dnu
        with T_ref,U the 1-U reference spectrum in uK_RJ:
          uK_cmb:  dT_RJ/dT_cmb
          uK_RJ:   1
          MJy/sr:  (nu_c/nu) / rj_to_MJysr(nu)   (IRAS color convention)
        Shift models:
          additive_shift: nu -> nu + delta
          powlaw_tilt:    tau -> tau * (nu/nu_c)^delta  (delta dimensionless)
        """
        if isinstance(delta, torch.Tensor):
            return self._weights(delta, shift_model,
                                 delta.device if device is None else device)
        device = resolve_device(device)
        if float(delta) != 0.0:
            return self._weights(delta, shift_model, device)
        # no shift: the same weights under either model
        key = ("w0", str(device))
        if key not in self._on_device:
            self._on_device[key] = self._weights(0.0, shift_model, device)
        return self._on_device[key]

    def _weights(self, delta, shift_model, device):
        nu, tau = self.nodes(device)
        if shift_model == "powlaw_tilt":
            tau = tau * (nu / self.nu_c) ** delta
        else:
            nu = nu + delta
        if self.profile_type in _INTENSITY_PROFILES:
            tau = tau * torch.square(nu / self.nu_c)
        if self.nu.size == 1:
            # delta bandpass: evaluated at the (shifted) center frequency
            base = torch.ones((1,), dtype=nu.dtype, device=nu.device)
        else:
            # trapezoid quadrature: centered differences, halved end nodes
            dnu = torch.cat([(nu[1:2] - nu[0:1]) * 0.5,
                             (nu[2:] - nu[:-2]) * 0.5,
                             (nu[-1:] - nu[-2:-1]) * 0.5])
            base = tau * dnu
        scale = _UNIT_SCALE.get(self.unit)
        if scale is None:
            raise ValueError(f"unknown band unit {self.unit}")
        if self.unit in ("uK_cmb", "mK_cmb", "K_cmb"):
            norm = torch.sum(base * thermo_to_rj(nu)) / scale
        elif self.unit == "uK_RJ":
            norm = torch.sum(base)
        else:   # MJy/sr: reference spectrum I(nu) = 1 MJy/sr (nu_c/nu)
            norm = torch.sum(base * (self.nu_c / nu) / rj_to_MJysr(nu))
        return nu, base / norm

    def integrate(self, sed_vals, delta=0.0, device=None):
        """Band-integrate SED values given at this band's nodes, on `device`
        (None: that of sed_vals when it is a tensor, else the CUDA card)."""
        if device is None and isinstance(sed_vals, torch.Tensor):
            device = sed_vals.device
        _, w = self.weights(delta, device=device)
        return torch.sum(w * torch.as_tensor(sed_vals).to(w), dim=-1)


def sz_thermo(nu):
    """Thermal SZ spectral shape in CMB-thermodynamic units:
    f(x) = x (e^x + 1)/(e^x - 1) - 4."""
    if not isinstance(nu, torch.Tensor):
        nu = torch.as_tensor(np.asarray(nu, np.float64))
    x = nu * (H_OVER_K / T_CMB)
    return x * (torch.exp(x) + 1.0) / torch.expm1(x) - 4.0


def band_sz_conversion(bp: Bandpass, device=None) -> float:
    """y_SZ -> band-map unit conversion: band response of the thermal SZ
    distortion spectrum T_cmb f_sz(nu) in the band's output unit, evaluated
    on `device` (None: the CUDA card)."""
    nu, w = bp.weights(0.0, device=device)
    # SZ signal in uK_RJ at each node: y * T_cmb[uK] * f_sz(nu) * dT_RJ/dT
    s_rj = (T_CMB * 1e6) * sz_thermo(nu) * thermo_to_rj(nu)
    return float(torch.sum(w * s_rj))


# per-profile-type relative trimming thresholds on tau
PROFILE_THRESHOLD = {"delta": 0.0, "LFI": 0.0, "WMAP": 0.0, "DIRBE": 0.0,
                     "HFI_cmb": 1e-7, "PSM_LFI": 1e-7, "HFI_submm": 1e-5,
                     "dame": 0.0}


def trim_profile(nu: np.ndarray, tau: np.ndarray, profile_type: str):
    """Drop nodes with tau below the profile type's relative threshold."""
    thr = PROFILE_THRESHOLD.get(profile_type, 0.0)
    if thr <= 0:
        return nu, tau
    keep = tau >= thr * tau.max()
    return nu[keep], tau[keep]


def delta_bandpass(nu0: float, unit: str = "uK_cmb") -> Bandpass:
    """Delta-function bandpass at nu0 (reference profile type 'delta')."""
    return Bandpass(nu=np.array([nu0]), tau=np.array([1.0]), unit=unit,
                    profile_type="delta")


def tophat_bandpass(nu0: float, frac_width: float = 0.2, n: int = 65,
                    unit: str = "uK_cmb") -> Bandpass:
    """Top-hat bandpass (a stand-in for LFI/WMAP radiometer profiles)."""
    nu = np.linspace(nu0 * (1 - frac_width / 2), nu0 * (1 + frac_width / 2), n)
    return Bandpass(nu=nu, tau=np.ones(n), unit=unit)


def band_unit_conversions(bp: Bandpass) -> float:
    """Scalar converting the band's unit to uK_RJ at band center."""
    nu_c = bp.nu_c
    if bp.unit == "uK_cmb":
        return float(thermo_to_rj(nu_c))
    if bp.unit == "uK_RJ":
        return 1.0
    if bp.unit == "MJy/sr":
        return 1.0 / float(rj_to_MJysr(nu_c))
    raise ValueError(f"no conversion for band unit {bp.unit}")
