"""Mixing-matrix evaluation: component SEDs band-integrated per band (torch).

Counterpart of commander_tpu.model.mixing: for component c with spectral
parameters theta (0-d tensors, floats or per-pixel maps),

    F[b, c](theta) = sum_k w_bk * S_c(nu_bk; theta) * unit_c

as a direct quadrature in float64 on the device where the parameters live, so
that a Gibbs step rebuilds F from its current theta vector on the card. The
caller casts the result to its data dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..instrument.bandpass import Bandpass
from ..utils.device import resolve_device
from .seds import SED_NPAR, SED_REGISTRY, thermo_to_rj

# largest (pixels, frequencies) SED block of a map-valued mixing element
MIX_CHUNK_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class DiffuseComponent:
    """Static configuration of one diffuse sky component."""
    name: str
    sed: str                 # key into SED_REGISTRY
    nu_ref: float            # reference frequency [Hz]
    polarized: bool = False
    theta0: tuple = ()       # default spectral parameters
    unit: str = "uK_RJ"      # 'uK_cmb' (cmb comp) or 'uK_RJ' (foregrounds)

    @property
    def npar(self) -> int:
        return SED_NPAR[self.sed]


def _device_of(device, *values):
    """`device` when given; else the device of the first tensor among values
    (nested one level); else the port's default (the CUDA card)."""
    if device is not None:
        return torch.device(device)
    for v in values:
        for t in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(t, torch.Tensor):
                return t.device
    return resolve_device(None)


def mixing_element(comp: DiffuseComponent, bp: Bandpass, theta=None,
                   delta=0.0, band_index: int | None = None, device=None):
    """F[b,c]: band response of unit component amplitude, in band units.

    theta: sequence of spectral parameters (floats, 0-d tensors or (npix,)
    maps; maps of more axes broadcast against the frequency axis added
    last); defaults to comp.theta0. Returns a 0-d or (npix,) float64 tensor
    on `device` (None: the device of theta or delta where one is a tensor,
    else the CUDA card; the CPU only by name).
    Line components (comp.sed == 'line'): theta holds the per-band line
    ratios; F is theta[band_index] directly (zero where absent).
    """
    if theta is None:
        theta = comp.theta0
    device = _device_of(device, theta, delta)
    if comp.sed == "line":
        if band_index is None:
            raise ValueError("line components need band_index")
        ratios = theta if isinstance(theta, torch.Tensor) else torch.stack(
            [torch.as_tensor(t, dtype=torch.float64, device=device)
             for t in theta])
        return ratios[band_index] if band_index < len(theta) \
            else 0.0 * ratios[0]
    nu, w = bp.weights(delta, device=device)
    sed_fn = SED_REGISTRY[comp.sed]
    # component amplitude unit -> uK_RJ at nu_ref
    if comp.unit == "uK_RJ" or comp.sed == "cmb":
        unit_fac = 1.0
    elif comp.unit == "uK_cmb":
        unit_fac = float(thermo_to_rj(comp.nu_ref))
    else:
        raise ValueError(f"unsupported component unit {comp.unit}")
    if comp.sed == "cmb":
        return torch.sum(w * sed_fn(nu), dim=-1) * unit_fac
    nd = [t.ndim for t in theta if isinstance(t, torch.Tensor)]
    # (P,) maps of theta with a bandpass of several frequencies: the SED is
    # (P, nfreq), so it goes MIX_CHUNK_BYTES at a time over the pixels (the
    # index samplers' (P, G) grids chunk their pixels themselves)
    P = max(t.shape[0] for t in theta if isinstance(t, torch.Tensor)
            and t.ndim == 1) if 1 in nd and max(nd) == 1 else 0
    step = max(1, MIX_CHUNK_BYTES // (8 * nu.shape[-1])) \
        if nu.shape[-1] > 1 else P
    if P <= step:
        th = [t[..., None] if isinstance(t, torch.Tensor) and t.ndim > 0
              else t for t in theta]
        return torch.sum(w * sed_fn(nu, comp.nu_ref, *th), dim=-1) \
            * unit_fac
    out = []
    for p0 in range(0, P, step):
        th = [t[..., p0:p0 + step, None]
              if isinstance(t, torch.Tensor) and t.ndim > 0 else t
              for t in theta]
        out.append(torch.sum(w * sed_fn(nu, comp.nu_ref, *th), dim=-1))
    return torch.cat(out, dim=-1) * unit_fac


def mixing_matrix(comps: Sequence[DiffuseComponent], bps: Sequence[Bandpass],
                  thetas=None, deltas=None, device=None) -> torch.Tensor:
    """Full mixing matrix F[b, c]: (nband, ncomp) float64 tensor on `device`
    (None: the device of the tensors among thetas and deltas, else the CUDA
    card; the CPU only by name).

    thetas: per-component parameter tuples (None -> defaults).
    deltas: per-band bandpass shifts (None -> 0).
    Only valid when all thetas are scalars; per-pixel thetas call
    mixing_element per component (shapes differ).
    """
    device = _device_of(device, *(thetas or ()), *(
        () if deltas is None else tuple(deltas)))
    rows = []
    for b, bp in enumerate(bps):
        d = 0.0 if deltas is None else deltas[b]
        rows.append(torch.stack([
            mixing_element(c, bp, None if thetas is None else thetas[i], d,
                           band_index=b, device=device)
            for i, c in enumerate(comps)]))
    return torch.stack(rows)
