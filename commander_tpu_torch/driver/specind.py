"""run()'s spectral-index step of the host loop and the mixing rebuild after
it (torch).

Counterpart of commander_tpu.run._stokes_group, _theta_for_stokes,
_rebuild_mixing, _pixreg_ids and _specind_step (run.py:821-961, 1023-1306;
the reference's sample_nonlin_params, comm_nonlin_mod.f90:92-193, and
updateMixmat per band, comm_diffuse_comp_mod.f90:1662). Per diffuse
component and spectral parameter, in order, on COMP_LMAX_IND:

  lmax_ind > 0   the alm-field MH (sampling/specind.sample_specind_alm) of
                 the parameter's alms to lmax_ind, with an adaptive step
                 toward half the proposals accepted; with ALMSAMP_PIXREG and
                 COMP_*_NUM_PIXREG the MH over pixel-region values
                 (sample_specind_alm_pixreg; region ids from _pixreg_ids,
                 the map's 0-pixels in an extra frozen region,
                 PIXREG_PRIORS, FIX_PIXREG, the scale's FWHM_POSTPROC);
  lmax_ind < 0   with --pixind the per-pixel inversion draw
                 (sample_specind_pixel), else the full-sky scalar draw;
  otherwise      the full-sky scalar draw;

each on the residual without the component (the template and source rows
subtracted too), against the component's amplitude map and, where the beams
are not all ~1, its per-band beamed maps. With COMP_*_SMOOTHING_SCALE the
local draws see the residual deconvolved to the scale's common Gaussian
(the ratio capped at 10), the amplitude smoothed to it, both degraded to
the scale's nside with the transfer-suppressed noise variance, and a
per-pixel draw comes back upgraded and post-smoothed. With POLTYPE 2 / 3 on
T/Q/U the local draws run per Stokes group ({T},{Q,U} or {T},{Q},{U}), the
higher groups with the POL lnL type into thetas_pol. The mixing is then
rebuilt: F from scalar thetas, per-Stokes F from per-group scalars, or F_pix
(B, C, S, P) with F its pixel mean where any theta is a map.

State carried between iterations (HostState): the alms of the alm-field
parameters (ind_alms), their step lengths (ind_steps), the region values
and region ids (ind_regs) and the per-group values (thetas_pol). Values are
device tensors (0-d for a scalar, (P,) for a map), float64.

Randomness: a torch.Generator, or `draws`, {(ci, which): per-branch draws}
in place of the generator's: {"u"} for a full-sky (0-d) or per-pixel (P,)
inversion, {"eta", "u"} for the alm MH, {"delta", "u"} for the region MH,
plus "pol": one {"u"} per higher Stokes group.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from ..instrument.beam import gaussian_bl
from ..model.mixing import mixing_element, mixing_matrix
from ..sampling import chisq
from ..sampling import full_gibbs
from ..sampling import joint
from ..sampling import specind as si
from ..sphere import healpix, sht

NGRID = 96
MH_STEPS = 3


@dataclasses.dataclass
class HostState:
    """The index state run() carries between iterations (run.py:1755-1759)
    beside the theta tuples: keyed by (component, parameter)."""
    thetas_pol: dict = dataclasses.field(default_factory=dict)
    ind_alms: dict = dataclasses.field(default_factory=dict)
    ind_steps: dict = dataclasses.field(default_factory=dict)
    ind_regs: dict = dataclasses.field(default_factory=dict)


def stokes_group(s: int, poltype: int) -> int:
    """Stokes index -> theta group of a POLTYPE (1: {T,Q,U}; 2: {T},{Q,U};
    3: {T},{Q},{U})."""
    if poltype <= 1 or s == 0:
        return 0
    return 1 if (poltype == 2 or s == 1) else 2


def theta_for_stokes(ci, s, thetas, thetas_pol, poltypes):
    """The theta tuple component ci sees at Stokes s: group 0 from thetas,
    the higher groups from thetas_pol[(ci, j)]."""
    if not thetas_pol or poltypes is None:
        return tuple(thetas[ci])
    out = []
    for j, t in enumerate(thetas[ci]):
        g = stokes_group(s, poltypes[ci][j])
        out.append(t if g == 0 else thetas_pol[(ci, j)][g - 1])
    return tuple(out)


def _is_map(t) -> bool:
    return isinstance(t, torch.Tensor) and t.ndim > 0 \
        or isinstance(t, np.ndarray) and t.ndim > 0


def rebuild_mixing(diffuse, bps, thetas, sys, thetas_pol=None,
                   poltypes=None, deltas=None):
    """sys with the mixing of `thetas` (run._rebuild_mixing): F (B, C, S)
    where every theta is a scalar, per Stokes where thetas_pol splits them,
    else F_pix (B, C, S, P) and F its pixel mean; in the data dtype on the
    data's device."""
    dev, dt = sys.data.device, sys.data.dtype
    S, P = sys.bl.shape[1], sys.data.shape[-1]
    split = bool(thetas_pol)
    all_th = [t for th in list(thetas) + (list(thetas_pol.values())
                                          if split else []) for t in th]
    if not any(_is_map(t) for t in all_th):
        if not split:
            F = mixing_matrix(diffuse, bps, thetas=thetas, deltas=deltas,
                              device=dev)[..., None].repeat(1, 1, S)
        else:
            F = torch.stack([mixing_matrix(
                diffuse, bps, thetas=[theta_for_stokes(
                    ci, s, thetas, thetas_pol, poltypes)
                    for ci in range(len(diffuse))], deltas=deltas,
                device=dev) for s in range(S)], dim=-1)
        return dataclasses.replace(sys, F=F.to(dt), F_pix=None)
    B, C = len(bps), len(diffuse)
    F_pix = torch.empty((B, C, S, P), dtype=dt, device=dev)
    F_mean = torch.empty((B, C, S), dtype=torch.float64, device=dev)
    for b, bp in enumerate(bps):
        d = 0.0 if deltas is None else deltas[b]
        for c, comp in enumerate(diffuse):
            for s in range(S) if split else (None,):
                th = theta_for_stokes(c, s, thetas, thetas_pol, poltypes) \
                    if split else thetas[c]
                v = mixing_element(comp, bp, th, d, band_index=b,
                                   device=dev)
                v = v.expand(P) if v.ndim == 0 else v
                sl = slice(None) if s is None else s
                F_pix[b, c, sl] = v.to(dt)
                F_mean[b, c, sl] = torch.mean(v)
    return dataclasses.replace(sys, F=F_mean.to(dt), F_pix=F_pix)


def _resolve(path, data_dir):
    p = str(path)
    return p if os.path.isabs(p) else os.path.join(data_dir or ".", p)


def pixreg_ids(nside: int, info: dict, npr: int, data_dir=None,
               synthetic: bool = False) -> np.ndarray:
    """(P,) int32 region id per pixel for the region MH (run._pixreg_ids):
    from COMP_*_PIXREG_MAP (1-indexed; 0 means not sampled and gives -1;
    ud-graded by the first child, or copied to the children), else the
    HEALPix pixels of nside n where npr = 12 n^2, else npr latitude bands
    of equal pixel count in RING order. A named map that does not exist
    raises, and in a synthetic run falls back to the built-in layout with a
    warning."""
    from ..io.fits import read_map

    path = info.get("pixreg_map")
    npix = 12 * nside ** 2
    if path and str(path).lower() not in ("none", "fullsky", ""):
        p = _resolve(path, data_dir)
        if os.path.exists(p):
            m = np.asarray(read_map(p))
            m = m[0] if m.ndim > 1 else m
            m = healpix.ud_map(m, nside, lambda x: x[..., 0])
            v = np.asarray(np.rint(m), np.int32)
            return np.where(v <= 0, -1, np.minimum(v - 1, npr - 1)
                            ).astype(np.int32)
        if not synthetic:
            raise FileNotFoundError(
                f"pixel-region map {path!r} not found (resolved {p!r}); set "
                f"COMP_*_PIXREG_MAP to a readable file or 'fullsky'")
        warnings.warn(f"pixel-region map {path!r} not found (resolved "
                      f"{p!r}); synthetic run: falling back to built-in "
                      f"{npr}-region layout", stacklevel=2)
    n = int(np.sqrt(npr / 12.0)) if npr >= 12 else 0
    if n >= 1 and 12 * n * n == npr:
        idx = healpix.udgrade_indices(nside, n)          # (npr, ratio)
        ids = np.empty(npix, np.int32)
        ids[idx] = np.arange(npr, dtype=np.int32)[:, None]
        return ids
    return np.minimum((np.arange(npix, dtype=np.int64) * npr) // npix,
                      npr - 1).astype(np.int32)


def index_bounds(info: dict, name: str, theta):
    """The parameter's grid (lo, hi), prior mean and rms in SED units
    (run.py:1058-1068)."""
    u = 1e9 if name == "nu_p" else 1.0
    sc = lambda k: None if info.get(k) is None else info[k] * u
    pm, pr, lo, hi = sc("prior_mean"), sc("prior_rms"), sc("low"), sc("high")
    if lo is None or hi is None:
        if pm is not None and pr:
            lo, hi = pm - 5 * pr, pm + 5 * pr
        else:
            d = _mean(theta)
            lo, hi = d - 0.5 * abs(d) - 0.1, d + 0.5 * abs(d) + 0.1
    return float(lo), float(hi), pm, pr, u


def _mean(t) -> float:
    return float(torch.mean(torch.as_tensor(t, dtype=torch.float64)))


def _scalar(v, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float64, device=dev)


def _smoothed(plan, sc, res, amp_pix, inv_rms2, bl):
    """The smoothing scale's inputs (run.py:1099-1142): the residual
    deconvolved to the common Gaussian (b_l ratio capped at 10, zero where
    the native beam is below 1e-4), the amplitude smoothed to it, both
    degraded to the scale's nside, and the transfer-suppressed noise
    variance. Returns (res_s, amp_s, inv_s, idx_s)."""
    dev, dt = res.device, res.dtype
    fw = max(sc["fwhm"], 1.0)
    g_l = torch.as_tensor(gaussian_bl(fw, plan.lmax), device=dev).to(dt)
    t_b = torch.where(bl > 1e-4, torch.clamp(
        g_l / torch.clamp(bl, min=1e-30), 0.0, 10.0),
        torch.zeros_like(bl))                              # (B, S, nl)
    res_sm = sht.alm2map(plan, sht.map2alm(plan, res) * t_b[..., None])
    amp_sm = sht.smooth_map(plan, amp_pix, fw)
    idx_s = torch.as_tensor(healpix.udgrade_indices(plan.nside, sc["nside"]),
                            device=dev)
    res_s = torch.mean(res_sm[..., idx_s], dim=-1)
    amp_s = torch.mean(amp_sm[..., idx_s], dim=-1)
    ellq = 2.0 * torch.arange(plan.lmax + 1, dtype=dt, device=dev) + 1.0
    supp = torch.sum(ellq * t_b ** 2, dim=-1) / (12 * plan.nside ** 2)
    var = torch.where(inv_rms2 > 0, 1.0 / torch.clamp(inv_rms2, min=1e-30),
                      torch.zeros_like(inv_rms2))
    var_s = torch.mean(var[..., idx_s], dim=-1) * supp[..., None]
    inv_s = torch.where(var_s > 0, 1.0 / torch.clamp(var_s, min=1e-30),
                        torch.zeros_like(var_s))
    return res_s, amp_s, inv_s, idx_s


def specind_step(cfg, pcfgs, diffuse, bps, sys, plan, state, thetas,
                 hs: HostState, pixind: bool = False, pol: bool = False,
                 data_dir=None, synthetic: bool = False, ts=None, ps=None,
                 generator: torch.Generator | None = None, draws=None,
                 deltas=None):
    """One pass over every diffuse component's spectral parameters
    (run._specind_step) and the mixing rebuild. thetas: per component a
    list of parameter values, updated in place; hs: the carried index state,
    updated in place; pol: the run is T/Q/U (POLTYPE splits apply); deltas:
    the bands' bandpass shifts in Hz, which the rebuilt mixing takes (the
    index grids evaluate at none, as run._specind_step's do). Returns
    (sys with the new mixing, {(ci, which): record}): per parameter its
    branch, seconds on the host's clock (the card synchronized) and, for the
    MH, the number of accepted proposals."""
    draws = draws or {}
    dev = sys.data.device

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    poltypes = [[int(pc.indices[n].get("poltype", 1) or 1)
                 for n in pc.indices] for pc in pcfgs]
    thetas_pol = hs.thetas_pol if pol else None
    scales = getattr(cfg, "smoothing_scales", []) or []
    beamed = not bool(torch.allclose(sys.bl, torch.ones_like(sys.bl),
                                     atol=1e-4))
    extra = joint.extra_sky(ts, ps, state.t, state.p, sys.data.shape[-1])
    records, changed = {}, False
    for ci, (pcfg, comp) in enumerate(zip(pcfgs, diffuse)):
        for which, name in enumerate(pcfg.indices):
            t0 = clock()
            info = pcfg.indices[name]
            d = draws.get((ci, which))
            lo, hi, pm, pr, u = index_bounds(info, name, thetas[ci][which])
            sicfg = si.SpecIndConfig(
                grid_min=lo, grid_max=hi, ngrid=NGRID, prior_mean=pm,
                prior_std=pr if pr else None,
                lnl_type=str(info.get("lnl_type") or "chisq"))
            res = chisq.compute_residual(sys, plan, state.a, exclude=ci)
            if extra is not None:
                res = res - extra
            amp_pix = full_gibbs._amp_synth(plan, state.a[ci])
            amp_band = full_gibbs._amp_synth(
                plan, state.a[ci][None] * sys.bl[..., None]) \
                if beamed else None
            res_s, amp_s, inv_s, idx_s, scale = (res, amp_pix,
                                                 sys.inv_rms2, None, None)
            ss_id = int(info.get("smoothing_scale", 0) or 0)
            if ss_id and ss_id <= len(scales):
                sc = scales[ss_id - 1]
                if sc["nside"] and sc["nside"] < plan.nside:
                    scale = sc
                    res_s, amp_s, inv_s, idx_s = _smoothed(
                        plan, sc, res, amp_pix, sys.inv_rms2, sys.bl)
            # map-valued other parameters at the working resolution
            th_scaled = tuple(
                torch.mean(t[idx_s], dim=-1) if scale is not None
                and _is_map(t) else t for t in thetas[ci])
            lmax_ind = pcfg.lmax_ind
            if lmax_ind and lmax_ind > 0:
                rec = _alm_field(cfg, info, comp, bps, sicfg, plan, res,
                                 amp_pix, amp_band, sys, thetas, ci, which,
                                 u, lmax_ind, hs, scales, data_dir,
                                 synthetic, generator, d)
            else:
                rec = _local(info, comp, bps, sicfg, plan, res_s, amp_s,
                             inv_s, amp_band, scale, th_scaled, thetas,
                             thetas_pol, poltypes, ci, which, lmax_ind,
                             pixind, generator, d, dev)
            rec["seconds"] = clock() - t0
            records[(ci, which)] = rec
            changed = True
    if changed:
        sys = rebuild_mixing(diffuse, bps, thetas, sys,
                             thetas_pol=thetas_pol, poltypes=poltypes,
                             deltas=deltas)
    return sys, records


def _alm_field(cfg, info, comp, bps, sicfg, plan, res, amp_pix, amp_band,
               sys, thetas, ci, which, u, lmax_ind, hs, scales, data_dir,
               synthetic, generator, d):
    """The alm-field MH of one parameter (run.py:1153-1235), the region
    form under ALMSAMP_PIXREG; thetas[ci][which] becomes the field's map."""
    dev = res.device
    L = int(min(lmax_ind, plan.lmax))
    key = (ci, which)
    step0 = hs.ind_steps.setdefault(key, 0.05)
    npr = int(info.get("num_pixreg", 0) or 0)
    mean0 = _mean(thetas[ci][which])
    if getattr(cfg, "almsamp_pixreg", False) and npr > 0:
        rop = hs.ind_regs.get(("rop", ci, which))
        if rop is None:
            rop = pixreg_ids(plan.nside, info, npr, data_dir, synthetic)
            hs.ind_regs[("rop", ci, which)] = rop
        nreg = npr
        frozen_extra = bool(np.any(rop < 0))
        if frozen_extra:
            # map value 0 = not sampled: an extra region, always frozen,
            # at the default theta
            rop = np.where(rop < 0, npr, rop)
            nreg = npr + 1
        t_reg = hs.ind_regs.get(key)
        if t_reg is None:
            t_reg = torch.full((nreg,), mean0, dtype=torch.float64,
                               device=dev)
        priors = None
        if info.get("pixreg_priors"):
            pv = [float(v) * u
                  for v in str(info["pixreg_priors"]).split(",")][:npr]
            if frozen_extra:
                pv = pv + [mean0]
            priors = np.asarray(pv)
        fix = None
        prfix = info.get("fix_pixreg")
        if prfix and str(prfix).lower() not in ("none", ""):
            fix = np.zeros(nreg, bool)
            for v in str(prfix).split(","):
                fix[int(v) - 1] = True
        if frozen_extra:
            fix = np.zeros(nreg, bool) if fix is None else fix
            fix[npr] = True
        fpp = 0.0
        ss_id = int(info.get("smoothing_scale", 0) or 0)
        if ss_id and ss_id <= len(scales):
            fpp = scales[ss_id - 1].get("fwhm_postproc", 0.0) or 0.0
        t_reg, th_map, t_alm, n_acc = si.sample_specind_alm_pixreg(
            comp, bps, sicfg, plan, res, amp_pix, sys.inv_rms2,
            tuple(thetas[ci]), t_reg, rop, which=which, lmax_ind=L,
            step=step0, nsteps=MH_STEPS, fwhm_postproc=float(fpp),
            fix_reg=fix, reg_priors=priors, generator=generator, draws=d)
        hs.ind_regs[key] = t_reg
        branch = "alm_pixreg"
    else:
        t_alm = hs.ind_alms.get(key)
        if t_alm is None:
            cdt = torch.complex128 if res.dtype == torch.float64 \
                else torch.complex64
            t_alm = torch.zeros((L + 1, L + 1), dtype=cdt, device=dev)
            t_alm[0, 0] = mean0 * np.sqrt(4.0 * np.pi)
        t_alm, th_map, n_acc = si.sample_specind_alm(
            comp, bps, sicfg, plan, res, amp_pix, sys.inv_rms2,
            tuple(thetas[ci]), t_alm, which=which, lmax_ind=L, step=step0,
            nsteps=MH_STEPS, amp_band=amp_band, generator=generator,
            draws=d)
        branch = "alm"
    # adaptive step length toward half the proposals accepted
    hs.ind_steps[key] = float(np.clip(
        step0 * np.exp(n_acc / MH_STEPS - 0.5), 1e-4, 1.0))
    hs.ind_alms[key] = t_alm
    thetas[ci][which] = th_map.to(torch.float64)
    return {"branch": branch, "accepted": int(n_acc), "step": step0}


def _local(info, comp, bps, sicfg, plan, res_s, amp_s, inv_s, amp_band,
           scale, th_scaled, thetas, thetas_pol, poltypes, ci, which,
           lmax_ind, pixind, generator, d, dev):
    """The per-pixel or full-sky draw of one parameter, per Stokes group
    under POLTYPE >= 2 (run.py:1236-1299)."""
    S = int(res_s.shape[1])
    pt = int(info.get("poltype", 1) or 1)
    split = thetas_pol is not None and S == 3 and pt >= 2
    groups = ([(0, 1)] + ([(1, 3)] if pt == 2 else [(1, 2), (2, 3)])) \
        if split else [(0, S)]
    per_pixel = lmax_ind is not None and lmax_ind < 0 and pixind

    def th_group(s_repr):
        out = []
        for j, t in enumerate(th_scaled):
            g = stokes_group(s_repr, poltypes[ci][j])
            out.append(thetas_pol[(ci, j)][g - 1]
                       if g > 0 and thetas_pol and (ci, j) in thetas_pol
                       else t)
        return tuple(out)

    def draw(scfg, sl, th_x, dd):
        r_g, a_g, i_g = res_s[:, sl], amp_s[sl], inv_s[:, sl]
        # the beamed maps belong to the native resolution; a smoothing
        # scale is at a common beam already
        ab_g = None if amp_band is None or scale is not None \
            else amp_band[:, sl]
        uu = None if dd is None else dd["u"]
        if per_pixel:
            new = si.sample_specind_pixel(
                comp, bps, scfg, r_g, a_g, i_g, th_x, which=which,
                amp_band=ab_g, generator=generator, u=uu)
            if scale is not None:
                # upgrade to the native nside, then FWHM_POSTPROC
                up = torch.as_tensor(healpix.udgrade_indices(
                    scale["nside"], plan.nside), device=dev)
                new = new[up]
                fpp = scale.get("fwhm_postproc", 0.0)
                if fpp and fpp > 0:
                    new = sht.smooth_map(plan, new.to(res_s.dtype), fpp
                                         ).to(torch.float64)
            return new
        return si.sample_specind_fullsky(
            comp, bps, scfg, r_g, a_g, i_g, th_x, which=which,
            amp_band=ab_g, generator=generator, u=uu)

    thetas[ci][which] = draw(sicfg, slice(*groups[0]), th_group(0), d)
    if split:
        scfg_p = dataclasses.replace(
            sicfg, lnl_type=str(info.get("lnl_type_pol") or "chisq"))
        pol_d = (d or {}).get("pol") or [None] * (len(groups) - 1)
        thetas_pol[(ci, which)] = [
            draw(scfg_p, slice(g0, g1), th_group(g0), dd)
            for (g0, g1), dd in zip(groups[1:], pol_d)]
    return {"branch": "pixel" if per_pixel else "fullsky",
            "groups": len(groups)}
