"""Carry state from the JAX package into the port.

Each function takes one of the JAX package's objects as a dict of numpy
arrays and Python scalars (the caller does the np.asarray on the JAX side)
and returns the port's object, on `device`. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .model.cl import ClModelConfig
from .sampling.amplitude import AmplitudeSystem
from .sampling.gibbs import GibbsConfig, GibbsState
from .sphere.sht_otf import LegendreOTF

_SYSTEM_FIELDS = ("F", "bl", "inv_rms2", "inv_rms", "cl", "data", "tri")
_UNPORTED_SYSTEM_FIELDS = ("inv_qu", "sqrt_inv_qu", "F_pix", "sqrtS_mat",
                           "ell_mask")


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def amplitude_system(d: dict, device="cpu") -> AmplitudeSystem:
    """AmplitudeSystem fields {F, bl, inv_rms2, inv_rms, cl, data, tri}."""
    for k in _UNPORTED_SYSTEM_FIELDS:
        if d.get(k) is not None:
            raise NotImplementedError(f"AmplitudeSystem.{k} is not ported")
    return AmplitudeSystem(**{k: _t(d[k], device) for k in _SYSTEM_FIELDS})


def gibbs_state(d: dict, device="cpu") -> GibbsState:
    """GibbsState fields {a, cl_bins, it, cg_iters, cg_relres}; `key`, if
    present, is dropped (the port draws from a torch.Generator)."""
    for k in ("t", "p"):
        if d.get(k) is not None:
            raise NotImplementedError(f"GibbsState.{k} is not ported")
    return GibbsState(a=_t(d["a"], device), cl_bins=_t(d["cl_bins"], device),
                      it=int(d.get("it", 0)),
                      cg_iters=int(d.get("cg_iters", 0)),
                      cg_relres=float(d.get("cg_relres", 0.0)))


def legendre_otf(d: dict, nside: int, device="cpu") -> LegendreOTF:
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
    """ClModelConfig scalars (dataclasses.asdict of the JAX config); only
    the binned model without a bin-file sample mask is ported."""
    if d["kind"] != "binned":
        raise NotImplementedError(f"Cl model {d['kind']!r} is not ported")
    _refuse_unported(d, {"lmin_amp": 0, "sample_bins": ()}, "ClModelConfig")
    return ClModelConfig(kind="binned", lmax=int(d["lmax"]),
                         nmaps=int(d["nmaps"]),
                         bin_starts=tuple(int(b) for b in d["bin_starts"]))


def gibbs_config(d: dict) -> GibbsConfig:
    """GibbsConfig scalars (dataclasses.asdict of the JAX config; its
    cl_cfg arrives as a nested dict). Settings the port does not have must
    hold the reference's defaults."""
    _refuse_unported(d, {"optimize": False, "cl_cfgs": (),
                         "cg_precond": "diagonal", "cg_lmax_precond": -1,
                         "groups": ()}, "GibbsConfig")
    return GibbsConfig(
        cl_cfg=cl_model_config(d["cl_cfg"]), cg_tol=float(d["cg_tol"]),
        cg_maxiter=int(d["cg_maxiter"]), sample_cl=bool(d["sample_cl"]),
        cl_alpha0=float(d.get("cl_alpha0", -1.0)),
        cl_beta0=float(d.get("cl_beta0", 0.0)))
