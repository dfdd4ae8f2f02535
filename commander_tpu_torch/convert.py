"""Carry state from the JAX package into the port.

Each function takes one of the JAX package's objects as a dict of numpy
arrays and Python scalars (the caller does the np.asarray on the JAX side)
and returns the port's object, on `device` (None: the CUDA card). Nothing
here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .io.params import BandConfig, ComponentParamConfig, RunConfig
from .instrument.bandpass import _UNIT_SCALE, Bandpass
from .instrument.noise import DiagonalNoise, QUCovNoise
from .model.cl import FUNCTIONAL_KINDS, ClModelConfig
from .model.mixing import DiffuseComponent
from .model.seds import SED_REGISTRY
from .sampling.amplitude import PRECONDS, AmplitudeSystem
from .sampling.full_gibbs import IndexSlot
from .sampling.gibbs import GibbsConfig, GibbsState
from .sampling.joint import (JointState, PtsrcSet, TemplateSet,
                             make_ptsrc_set, templates_from_dense)
from .sampling.multires import MultiSystem
from .sampling.specind import SpecIndConfig
from .sphere.sht_otf import LegendreOTF
from .tod.differential import DiffTodBlock
from .tod.model import TodBlock, TodState
from .tod.process import TodConfig
from .utils.device import resolve_device

_SYSTEM_FIELDS = ("F", "bl", "inv_rms2", "inv_rms", "cl", "data", "tri")
_OPTIONAL_SYSTEM_FIELDS = ("inv_qu", "sqrt_inv_qu", "sqrtS_mat", "ell_mask",
                           "F_pix")


def _t(a, device, dtype=None):
    device = resolve_device(device)
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def amplitude_system(d: dict, device=None) -> AmplitudeSystem:
    """AmplitudeSystem fields {F, bl, inv_rms2, inv_rms, cl, data, tri} and,
    where present, {inv_qu, sqrt_inv_qu, sqrtS_mat, ell_mask, F_pix}."""
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
    """GibbsState fields {a, cl_bins, it, cg_iters, cg_relres} and, where
    the model has them, the joint rows' amplitudes {t, p}; `key`, if
    present, is dropped (the port draws from a torch.Generator)."""
    opt = lambda k: None if d.get(k) is None else _t(d[k], device)
    return GibbsState(a=_t(d["a"], device), cl_bins=_t(d["cl_bins"], device),
                      it=int(d.get("it", 0)),
                      cg_iters=int(d.get("cg_iters", 0)),
                      cg_relres=float(d.get("cg_relres", 0.0)),
                      t=opt("t"), p=opt("p"))


def template_set(d: dict, device=None) -> TemplateSet:
    """TemplateSet fields {maps (T, B, S, P), prior_mean, prior_istd}: the
    dense maps become the port's non-zero planes (joint.TemplateSet)."""
    maps = np.array(d["maps"])
    return templates_from_dense(
        maps, np.array(d["prior_mean"]), np.array(d["prior_istd"]),
        dtype=torch.float64 if maps.dtype == np.float64 else torch.float32,
        device=resolve_device(device))


def ptsrc_set(d: dict, npix: int, device=None) -> PtsrcSet:
    """PtsrcSet fields {pix, stamp, prior_mean, prior_istd} on maps of npix
    pixels (the JAX object does not carry it); the port sorts the stamps'
    scatter once here."""
    return make_ptsrc_set(np.array(d["pix"]), np.array(d["stamp"]), npix,
                          np.array(d["prior_mean"]),
                          np.array(d["prior_istd"]),
                          device=resolve_device(device))


def joint_state(d: dict, device=None) -> JointState:
    """JointState fields {a, t, p} (t, p None where absent)."""
    opt = lambda k: None if d.get(k) is None else _t(d[k], device)
    return JointState(a=_t(d["a"], device), t=opt("t"), p=opt("p"))


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
    and cl_cfgs arrive as nested dicts). CG sampling groups are not ported
    and must hold the reference's default (); a preconditioner name outside
    the port's is refused."""
    _refuse_unported(d, {"groups": ()}, "GibbsConfig")
    precond = str(d.get("cg_precond", "diagonal"))
    if precond not in PRECONDS:
        raise ValueError(f"GibbsConfig.cg_precond={precond!r}: the port has "
                         f"{sorted(PRECONDS)}")
    return GibbsConfig(
        cl_cfg=cl_model_config(d["cl_cfg"]), cg_tol=float(d["cg_tol"]),
        cg_maxiter=int(d["cg_maxiter"]), sample_cl=bool(d["sample_cl"]),
        optimize=bool(d.get("optimize", False)),
        cl_cfgs=tuple(cl_model_config(c) for c in d.get("cl_cfgs", ())),
        cl_alpha0=float(d.get("cl_alpha0", -1.0)),
        cl_beta0=float(d.get("cl_beta0", 0.0)), cg_precond=precond,
        cg_lmax_precond=int(d.get("cg_lmax_precond", -1)))


def diffuse_component(d: dict) -> DiffuseComponent:
    """DiffuseComponent fields (dataclasses.asdict of the JAX component). A
    SED family the port's registry lacks is refused."""
    if d["sed"] not in SED_REGISTRY:
        raise NotImplementedError(f"DiffuseComponent.sed={d['sed']!r} is "
                                  f"not ported")
    return DiffuseComponent(
        name=str(d["name"]), sed=str(d["sed"]), nu_ref=float(d["nu_ref"]),
        polarized=bool(d.get("polarized", False)),
        theta0=tuple(float(t) for t in d.get("theta0", ())),
        unit=str(d.get("unit", "uK_RJ")))


def bandpass(d: dict) -> Bandpass:
    """Bandpass fields {nu, tau, unit, profile_type}; the nodes stay host
    numpy (Bandpass.nodes moves them to a device at first use there)."""
    unit = str(d.get("unit", "uK_cmb"))
    if unit not in _UNIT_SCALE:
        raise NotImplementedError(f"Bandpass.unit={unit!r} is not ported")
    return Bandpass(nu=np.array(d["nu"], np.float64),
                    tau=np.array(d["tau"], np.float64), unit=unit,
                    profile_type=str(d.get("profile_type", "tophat")))


def specind_config(d: dict) -> SpecIndConfig:
    """SpecIndConfig scalars (dataclasses.asdict of the JAX config)."""
    lnl_type = str(d.get("lnl_type") or "chisq")
    if lnl_type not in ("chisq", "ridge", "marginal", "prior"):
        raise NotImplementedError(f"SpecIndConfig.lnl_type={lnl_type!r} is "
                                  f"not ported")
    opt = lambda v: None if v is None else float(v)
    return SpecIndConfig(
        grid_min=float(d["grid_min"]), grid_max=float(d["grid_max"]),
        ngrid=int(d.get("ngrid", 96)), prior_mean=opt(d.get("prior_mean")),
        prior_std=opt(d.get("prior_std")), lnl_type=lnl_type)


def index_slot(d: dict) -> IndexSlot:
    """IndexSlot fields {ci, which, cfg} (cfg as a nested dict)."""
    return IndexSlot(ci=int(d["ci"]), which=int(d["which"]),
                     cfg=specind_config(d["cfg"]))


def thetas(values, device=None) -> torch.Tensor:
    """The flat (nslot,) parameter vector of full_gibbs_step, float64 on
    `device`."""
    return _t(np.asarray(values, np.float64).reshape(-1), device)


def tod_block(d: dict, device=None) -> TodBlock:
    """TodBlock fields {tod, pix, psi, mask, vsun, fsamp} and, where present,
    satpos; pix becomes int32, the float arrays keep their dtype."""
    opt = d.get("satpos")
    return TodBlock(tod=_t(d["tod"], device),
                    pix=_t(d["pix"], device, torch.int32),
                    psi=_t(d["psi"], device), mask=_t(d["mask"], device),
                    vsun=_t(d["vsun"], device), fsamp=float(d["fsamp"]),
                    satpos=None if opt is None else _t(opt, device))


def diff_tod_block(d: dict, device=None) -> DiffTodBlock:
    """DiffTodBlock fields {tod, pixA, psiA, pixB, psiB, mask, vsun, fsamp};
    the pixels become int32, the float arrays keep their dtype."""
    return DiffTodBlock(**{k: _t(d[k], device, torch.int32 if k.startswith(
        "pix") else None) for k in ("tod", "pixA", "psiA", "pixB", "psiB",
                                    "mask", "vsun")}, fsamp=float(d["fsamp"]))


def tod_state(d: dict, device=None) -> TodState:
    """TodState fields {gain, sigma0, alpha, fknee, n_corr}."""
    return TodState(**{k: _t(d[k], device) for k in (
        "gain", "sigma0", "alpha", "fknee", "n_corr")})


def tod_aux(d: dict, device=None) -> dict:
    """The sidelobe and zodi entries of run.py's per-band TOD aux
    (_setup_tod_aux, run.py:647-712) as TodBand fields: {sl_blm (Nd, nl,
    M+1) complex, sl_plan {nside, lmax} (the JAX plan's resolution: the
    port's plan is rebuilt here, tableless, in sl_tables' dtype),
    sl_tables [(d_pos, d_neg) (nh, nl, nl) per m'], sl_pix (Ns, Nd, Nt),
    zodi (Ns, Nd, Nt)}, each None where absent. Returns {sl_blm, sl_plan,
    sl_tables, sl_pix, zodi} for TodBand._replace."""
    from .sphere.sht import _table, get_plan

    device = resolve_device(device)
    out = dict(sl_blm=None, sl_plan=None, sl_tables=None, sl_pix=None,
               zodi=None)
    if d.get("zodi") is not None:
        out["zodi"] = _t(d["zodi"], device)
    if d.get("sl_pix") is not None:
        out["sl_pix"] = _t(d["sl_pix"], device, torch.int32)
    if d.get("sl_blm") is None:
        return out
    tabs = [(np.asarray(dp), np.asarray(dn)) for dp, dn in d["sl_tables"]]
    dt = torch.float32 if tabs[0][0].dtype == np.float32 else torch.float64
    out["sl_blm"] = _t(d["sl_blm"], device)
    out["sl_plan"] = get_plan(int(d["sl_plan"]["nside"]),
                              int(d["sl_plan"]["lmax"]), dtype=dt,
                              device=device)
    out["sl_tables"] = []
    for dp, dn in tabs:
        tp = _table(dp, dt, device)
        out["sl_tables"].append((tp, tp if np.array_equal(dp, dn)
                                 else _table(dn, dt, device)))
    return out


def tod_config(d: dict) -> TodConfig:
    """TodConfig scalars and grids (dataclasses.asdict of the JAX config)."""
    kw = dict(d)
    for k in ("alpha_grid", "fknee_grid"):
        if k in kw:
            kw[k] = tuple(float(x) for x in kw[k])
    return TodConfig(**kw)


def multi_system(d: dict, device=None) -> MultiSystem:
    """MultiSystem fields {groups (AmplitudeSystem dicts, one per
    resolution group), cl, tri}."""
    return MultiSystem(groups=tuple(amplitude_system(g, device)
                                    for g in d["groups"]),
                       cl=_t(d["cl"], device), tri=_t(d["tri"], device))


def run_config(d: dict) -> RunConfig:
    """io.params.RunConfig from the JAX package's (dataclasses.asdict: bands
    and comps as nested dicts); the two have the same fields."""
    d = dict(d)
    d["bands"] = [BandConfig(**b) for b in d["bands"]]
    d["comps"] = [ComponentParamConfig(**dict(
        c, indices={k: dict(v) for k, v in c.get("indices", {}).items()}))
        for c in d["comps"]]
    return RunConfig(**d)
