"""Carry state from the JAX package into the port.

Each function takes one of the JAX package's objects as a dict of numpy
arrays and Python scalars (the caller does the np.asarray on the JAX side)
and returns the port's object, on `device` (None: the CUDA card). Nothing
here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .instrument.noise import DiagonalNoise, QUCovNoise
from .model.cl import FUNCTIONAL_KINDS, ClModelConfig
from .sampling.amplitude import AmplitudeSystem
from .sampling.gibbs import GibbsConfig, GibbsState
from .sphere.sht_otf import LegendreOTF
from .utils.device import resolve_device

_SYSTEM_FIELDS = ("F", "bl", "inv_rms2", "inv_rms", "cl", "data", "tri")
_OPTIONAL_SYSTEM_FIELDS = ("inv_qu", "sqrt_inv_qu", "sqrtS_mat", "ell_mask")


def _t(a, device, dtype=None):
    device = resolve_device(device)
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def amplitude_system(d: dict, device=None) -> AmplitudeSystem:
    """AmplitudeSystem fields {F, bl, inv_rms2, inv_rms, cl, data, tri} and,
    where present, {inv_qu, sqrt_inv_qu, sqrtS_mat, ell_mask}."""
    if d.get("F_pix") is not None:
        raise NotImplementedError("AmplitudeSystem.F_pix is not ported")
    kw = {k: _t(d[k], device) for k in _SYSTEM_FIELDS}
    kw.update({k: _t(d[k], device) for k in _OPTIONAL_SYSTEM_FIELDS
               if d.get(k) is not None})
    return AmplitudeSystem(**kw)


def diagonal_noise(d: dict, device=None) -> DiagonalNoise:
    """DiagonalNoise fields {rms, mask}."""
    return DiagonalNoise(rms=_t(d["rms"], device), mask=_t(d["mask"], device))


def qucov_noise(d: dict, device=None) -> QUCovNoise:
    """QUCovNoise fields {rms_T, inv_QU, sqrt_inv_QU, mask}."""
    return QUCovNoise(**{k: _t(d[k], device)
                         for k in ("rms_T", "inv_QU", "sqrt_inv_QU", "mask")})


def gibbs_state(d: dict, device=None) -> GibbsState:
    """GibbsState fields {a, cl_bins, it, cg_iters, cg_relres}; `key`, if
    present, is dropped (the port draws from a torch.Generator)."""
    for k in ("t", "p"):
        if d.get(k) is not None:
            raise NotImplementedError(f"GibbsState.{k} is not ported")
    return GibbsState(a=_t(d["a"], device), cl_bins=_t(d["cl_bins"], device),
                      it=int(d.get("it", 0)),
                      cg_iters=int(d.get("cg_iters", 0)),
                      cg_relres=float(d.get("cg_relres", 0.0)))


def legendre_otf(d: dict, nside: int, device=None) -> LegendreOTF:
    """LegendreOTF array fields plus its {lmax, mmax, mp, chunk} scalars
    (the JAX object does not carry nside, so it is passed in)."""
    arrays = ("seed_mant", "A", "Bc", "beta", "x", "norm", "parity_m")
    kw = {k: _t(d[k], device) for k in arrays}
    return LegendreOTF(seed_exp=_t(d["seed_exp"], device, torch.int32),
                       m_vals=_t(d["m_vals"], device, torch.int64),
                       nside=nside, lmax=int(d["lmax"]), mmax=int(d["mmax"]),
                       mp=int(d["mp"]), chunk=int(d["chunk"]), **kw)


def _refuse_unported(d: dict, defaults: dict, what: str):
    for k, v in defaults.items():
        if k in d and d[k] != v:
            raise NotImplementedError(f"{what}.{k}={d[k]!r} is not ported")


def cl_model_config(d: dict) -> ClModelConfig:
    """ClModelConfig scalars (dataclasses.asdict of the JAX config)."""
    if d["kind"] not in ("none", "binned") + FUNCTIONAL_KINDS:
        raise ValueError(f"unknown Cl model {d['kind']!r}")
    return ClModelConfig(
        kind=d["kind"], lmax=int(d["lmax"]),
        lmin_amp=int(d.get("lmin_amp", 0)), nmaps=int(d["nmaps"]),
        bin_starts=tuple(int(b) for b in d["bin_starts"]),
        ell_pivot=int(d.get("ell_pivot", 50)),
        sample_bins=tuple(tuple(bool(x) for x in row)
                          for row in d.get("sample_bins", ())))


def gibbs_config(d: dict) -> GibbsConfig:
    """GibbsConfig scalars (dataclasses.asdict of the JAX config; its cl_cfg
    and cl_cfgs arrive as nested dicts). Settings the port does not have
    must hold the reference's defaults."""
    _refuse_unported(d, {"cg_precond": "diagonal", "cg_lmax_precond": -1,
                         "groups": ()}, "GibbsConfig")
    return GibbsConfig(
        cl_cfg=cl_model_config(d["cl_cfg"]), cg_tol=float(d["cg_tol"]),
        cg_maxiter=int(d["cg_maxiter"]), sample_cl=bool(d["sample_cl"]),
        optimize=bool(d.get("optimize", False)),
        cl_cfgs=tuple(cl_model_config(c) for c in d.get("cl_cfgs", ())),
        cl_alpha0=float(d.get("cl_alpha0", -1.0)),
        cl_beta0=float(d.get("cl_beta0", 0.0)))
