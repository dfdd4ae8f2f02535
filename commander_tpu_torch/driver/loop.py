"""run()'s Gibbs loop on the fast path: chain start, resume, the TOD route,
the per-sample reject rule, the status file and the thinning output (torch).

Counterpart of commander_tpu.run.run (run.py:1355-2566; the reference's
commander.f90:160-254) for the configurations its fast path takes
(run.py:1777-1794): scalar full-sky spectral indices drawn inside one
sampling/full_gibbs.full_gibbs_step per iteration, with the joint system's
template and source rows, the map-level gains after it, and, with --tod,
the TOD pass ahead of it (sampling/tod_gibbs.py). Per chain:

  1. build_model (driver/model.py), the Gibbs config, the chain file
     chain_c<chain>.h5 in outdir;
  2. the start: zero amplitudes, each component's C_b the mean of its prior
     spectrum over the bin (run.py:1456-1474); on resume the chain's last
     sample is dropped and the one before it seeds the alms and gains
     (commander.f90:160-174, run.py:1438-1446, :1492-1512); without a
     resume INIT_CHAIN ('file.h5:sample', a chain of either package) does;
  3. with --tod (float32 only): the bands' TOD simulated from the noiseless
     sky, the TOD state restored from the chain on resume, and the warm
     start (tod_gibbs.tod_burnin: one amplitude step, then 3 TOD passes, 1
     after a restore), as run()'s host composition of its deferred TOD
     route orders them (run.py:2012-2021; its encoded accelerator route
     orders them otherwise, ROADMAP queue 3 item 9);
  4. per attempt: the TOD pass and full_gibbs_step (tod_gibbs_step), or
     full_gibbs_step alone; the gains of the bands that sample them
     (run.py:2376-2431: GLS with the +-0.01 clamp and the soft prior, or
     the cross-C_l estimator over BAND_GAIN_LMIN..LMAX, with the
     calibration mask; hard priors re-drawn every
     NUMITER_RESAMPLE_HARD_GAIN_PRIORS iterations); the chi^2 of the full
     model;
  5. the reject rule (run.py:2433-2458, commander.f90:229-251): a sample
     whose chi^2 is not finite, or whose CG stopped above its tolerance
     (CG_CONVERGENCE_CRITERION other than fixed_iter, and at least one CG
     iteration), is rejected: the iteration counter stays, nothing is
     written, and the next attempt starts from the state the rejected one
     left (as run.py's does). After 25 rejects in a row the draw is
     accepted with a warning;
  6. at every THINNING_FACTOR-th accepted iteration: driver/output.py.

Every configuration that leaves run()'s fast path (its host loop,
run._specind_step and the modules it reaches) raises NotImplementedError
naming ROADMAP queue 1; none runs another path.

Randomness: a torch.Generator on the run's device (default: seeded from
BASE_SEED and the chain index), or `draws`, a function of the attempt
number returning every draw of that attempt ({eta1, eta2, gamma, u, eta_t,
eta_p, eps_gain}, and "tod": one pass_draws dict per band), used in place
of the generator's; attempt 0 is the TOD warm start ({eta1, eta2, gamma,
eta_t, eta_p, "tod": a list of passes}). Every draw is made on the
generator's own device (utils/device.randn), so a CUDA generator drives a CPU
run with the card's numbers. A rejected attempt consumes its draws.
"""
from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..io.chain import ChainFile
from ..model.cl import bin_index_table
from ..sampling import chisq
from ..sampling import full_gibbs
from ..sampling import gain as gain_mod
from ..sampling import gibbs as gibbs_mod
from ..sampling import tod_gibbs
from ..tod.model import TodState
from ..utils.device import resolve_device
from ..utils.status import StatusFile, Timer
from . import output
from .model import Model, build_model, diffuse_configs

HOST_LOOP = ("is not ported: it leaves run()'s fast path for its host loop "
             "(run._specind_step and the modules it reaches), ROADMAP queue "
             "1 item 2, the next slice")
MAX_CONSEC_REJECT = 25


class RunResult(NamedTuple):
    """The last state, the chain file, the last parameter vector, one
    record per attempt: {it, attempt, ok, chisq, cg_iters, cg_relres,
    seconds (the step), tod_seconds}, the timers, and with --tod the warm
    start's {cg_iters, cg_relres, npasses}."""
    state: gibbs_mod.GibbsState
    chain_path: str
    thetas: torch.Tensor
    records: list
    timer: Timer
    warm: dict | None = None


def refuse_host_loop(cfg, tod: bool, dtype, pixind=False, te_cl=False,
                     cg_groups=False, pol=False):
    """NotImplementedError for every configuration run() would take off its
    fast path (run.py:1777-1794) or that needs its host TOD branches."""
    pcfgs = diffuse_configs(cfg)
    why = []
    if pixind:
        why.append("--pixind")
    if te_cl:
        why.append("--te-cl")
    if cg_groups:
        why.append("--cg-groups (CG sampling groups)")
    if cfg.resample_cmb:
        why.append("RESAMPLE_CMB")
    if cfg.almsamp_pixreg:
        why.append("ALMSAMP_PIXREG")
    if int(cfg.output_cg_freq or 0) > 0:
        why.append("OUTPUT_EVERY_NTH_CG_ITERATION")
    for p in pcfgs:
        if p.lmax_ind is not None and p.lmax_ind >= 0:
            why.append(f"COMP_LMAX_IND {p.lmax_ind} of {p.label} (spectral "
                       f"indices as maps)")
        for name, info in p.indices.items():
            if info.get("smoothing_scale"):
                why.append(f"index smoothing of {p.label} {name}")
            if int(info.get("poltype") or 1) > 1:
                why.append(f"POLTYPE {info['poltype']} of {p.label} {name}")
    if any(np.ndim(v.get("default")) for p in pcfgs
           for v in p.indices.values()):
        why.append("map-valued spectral indices")
    if tod and cfg.enable_tod:
        if dtype != torch.float32:
            why.append("--tod in float64 (run() takes its host loop there; "
                       "the fast path with TOD is float32, --f32)")
        if any(b.tod_filelist for b in cfg.bands):
            why.append("archive TOD (BAND_TOD_FILELIST; ROADMAP queue 1 "
                       "item 6)")
        if any(b.sample_bandpass for b in cfg.bands):
            why.append("BAND_SAMP_BANDPASS with --tod")
        if cfg.sample_tod_mono:
            why.append("SAMPLE_TOD_MONOPOLE")
        if int(cfg.tod_4d_nth_iter or 0) > 0:
            why.append("TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER (4D maps)")
        if any(str(b.tod_type).upper() == "WMAP" for b in cfg.bands):
            why.append("differential (WMAP) TOD")
        if any(str(b.tod_type).lower() in ("none", "") for b in cfg.bands):
            why.append("map-level bands (BAND_TOD_TYPE none) beside the "
                       "TOD bands")
        if pol and any(not b.polarized for b in cfg.bands):
            why.append("unpolarized TOD bands in a --pol run")
    if why:
        raise NotImplementedError(
            "; ".join(why) + f": {HOST_LOOP}")


def chain_seed(base_seed: int, chain: int) -> int:
    """The seed of a chain's generator: BASE_SEED and the chain index
    folded into one 63-bit integer (the reference scrambles per rank,
    comm_param_mod.f90:334-357)."""
    return (int(base_seed) * 1_000_003 + int(chain)) % (2 ** 63)


def prior_cl_bins(model: Model, gcfg, nbins: int) -> np.ndarray:
    """(C, S, nbins) the mean of each component's prior spectrum over its
    bins (run.py:1463-1474)."""
    cl0, S = model.cl0, model.meta["nmaps"]
    out = np.zeros((cl0.shape[0], S, nbins))
    for c in range(cl0.shape[0]):
        cc = model.cl_cfgs[c] if model.cl_cfgs else gcfg.cl_cfg
        if cc.kind != "binned":
            cc = gcfg.cl_cfg
        idx = bin_index_table(cc)
        nb = len(cc.bin_starts)
        count = np.maximum(np.bincount(idx, minlength=nb), 1)
        for s in range(S):
            out[c, s, :nb] = np.bincount(idx, weights=cl0[c, s],
                                         minlength=nb) / count
    return out


def _read_start(ch: ChainFile, cfg, data_dir, status):
    """(first, previous sample or None): the resume point of the chain file
    (its last sample dropped), else INIT_CHAIN's sample."""
    first = ch.last_sample()
    if first > 0:
        first = max(first - 1, 0)
        return first, (ch.read_sample(first) if first > 0 else None)
    if not cfg.init_chain:
        return 0, None
    spec = str(cfg.init_chain)
    fpath, _, samp = spec.rpartition(":")
    if not fpath or not samp.isdigit():
        fpath, samp = spec, ""
    if not os.path.isabs(fpath):
        fpath = os.path.join(data_dir or ".", fpath)
    if not os.path.exists(fpath):
        return 0, None
    with ChainFile(fpath, "r") as ich:
        isamp = int(samp) if samp else ich.last_sample()
        prev = ich.read_sample(isamp) if isamp > 0 else None
    if prev is not None:
        status.update(f"warm start from {fpath}:{isamp}")
    return 0, prev


def _alms_from(prev: dict, model: Model, cdt, device) -> torch.Tensor:
    """The sample's component alms at the run's (S, lmax): pad or cut each
    (l, m) block (alm_equal, comm_map_mod.f90:1148)."""
    S, nl = model.meta["nmaps"], model.meta["lmax"] + 1
    out = np.zeros((len(model.diffuse), S, nl, nl), np.complex128)
    for i, d in enumerate(model.diffuse):
        a = prev["comps"][d.name]["alm"]
        s, n = min(a.shape[0], S), min(a.shape[1], nl)
        out[i, :s, :n, :n] = a[:s, :n, :n]
    return torch.as_tensor(out).to(device, cdt)


def _gain_mask(band, plan, data_dir, synthetic):
    """The calibration mask of a band (run._gain_calib_mask) as a (P,)
    tensor on the plan's device, or None for the full sky."""
    from ..io.fits import read_map
    from ..sphere import healpix, sht

    path = getattr(band, "maskfile_calib", None)
    if not path or str(path).lower() in ("none", "fullsky", ""):
        return None
    p = str(path)
    if not os.path.isabs(p):
        p = os.path.join(data_dir or ".", p)
    if not os.path.exists(p):
        if not synthetic:
            raise FileNotFoundError(
                f"gain calibration mask {path!r} not found (resolved "
                f"{p!r}); set BAND_MASKFILE_CALIB to a readable file or "
                f"'fullsky'")
        warnings.warn(f"gain calibration mask {path!r} not found; "
                      f"synthetic run: using fullsky", stacklevel=2)
        return None
    m = np.asarray(read_map(p))
    m = m[0] if m.ndim > 1 else m
    npix = 12 * plan.nside ** 2
    if m.shape[-1] != npix:
        ns_in = int(np.sqrt(m.shape[-1] / 12.0))
        if ns_in >= plan.nside:
            m = np.mean(m[np.asarray(healpix.udgrade_indices(
                ns_in, plan.nside))], axis=-1)
        else:
            idx = np.asarray(healpix.udgrade_indices(plan.nside, ns_in))
            out = np.empty(npix, m.dtype)
            for r in range(idx.shape[0]):
                out[idx[r]] = m[r]
            m = out
    mt = torch.as_tensor(np.asarray(m, np.float64)).to(
        plan.ring_weight.device, plan.rdtype)
    fwhm = float(getattr(band, "gain_apod_fwhm", 0.0) or 0.0)
    if fwhm > 0:
        # BAND_GAIN_APOD_FWHM: a Gaussian taper of the mask's edges
        mt = torch.clamp(sht.smooth_map(plan, mt[None], fwhm)[0], 0.0, 1.0)
    return mt


def sample_gains(cfg, model: Model, sys, state, gains: torch.Tensor,
                 it: int, masks: dict, generator, eps, data_dir,
                 synthetic) -> torch.Tensor:
    """The gains of the bands that sample them (run.py:2376-2431), in band
    order: a hard prior (BAND_GAIN_PRIOR_RMS < 0) keeps the gain but every
    NUMITER_RESAMPLE_HARD_GAIN_PRIORS-th iteration; else the calibration
    signal (BAND_GAIN_CALIB_COMP components, all by default) at unit gain
    against the residual with it added back, by the cross-C_l estimator
    (BAND_GAIN_LMIN/LMAX) or the GLS draw. None is applied to the data, as
    in run(). eps: optional (B,) N(0, 1) draws."""
    plan = model.plan
    sky_all = chisq.full_sky(sys, plan, state.a, model.ts, model.ps,
                             state.t, state.p)
    res_all = sys.data - sky_all
    names = [d.name.lower() for d in model.diffuse]
    g_new = gains.clone()
    for b, band in enumerate(cfg.bands):
        if not band.sample_gain:
            continue
        pm, pr = band.gain_prior_mean, band.gain_prior_rms
        e = None if eps is None else eps[b]
        if pr < 0:
            nth = max(int(cfg.resamp_hard_gain_nth or 0), 0)
            if nth and it % nth == 0:
                g_new[b] = pm + abs(pr) * gain_mod._normal((), g_new,
                                                           generator, e)
            continue
        toks = [t.strip().strip("'\"").lower() for t in str(
            band.gain_calib_comp or "all").replace(",", " ").split()]
        if "all" in toks or not toks:
            sig_b = sky_all[b]
        else:
            keep = torch.tensor([1.0 if n in toks else 0.0 for n in names],
                                dtype=state.a.real.dtype,
                                device=state.a.device)
            sig_b = chisq.sky_signal(sys, plan, state.a
                                     * keep[:, None, None, None])[b]
        sig_unit = sig_b / torch.clamp(g_new[b], min=1e-12).to(sig_b.dtype)
        res_b = res_all[b] + sig_b
        if b not in masks:
            masks[b] = _gain_mask(band, plan, data_dir, synthetic)
        gm = masks[b]
        if band.gain_lmin > 0 and band.gain_lmax > 0:
            g_new[b] = gain_mod.estimate_gain_cross_cl(
                plan, sig_unit, res_b, band.gain_lmin,
                min(band.gain_lmax, plan.lmax),
                mask=None if gm is None else gm.to(sig_b))
        else:
            g_new[b] = gain_mod.sample_gain_gls(
                res_b, sig_unit, sys.inv_rms2[b], g_new[b],
                mask=None if gm is None else gm.to(sig_b), prior_mean=pm,
                prior_rms=pr, optimize=cfg.operation == "optimize",
                generator=generator, eps=e)
    return g_new


def run(cfg, nside=None, lmax=None, synthetic: bool = False, niter=None,
        outdir=None, dtype=torch.float64, verbose: bool = True,
        tod: bool = False, chain: int = 1, pol: bool = False, data_dir=None,
        pixind: bool = False, te_cl: bool = False, cg_groups: bool = False,
        device=None, generator: torch.Generator | None = None, draws=None,
        a_true=None) -> RunResult:
    """Execute one chain of the Gibbs loop on `device` (None: the CUDA
    card); returns a RunResult. generator: the chain's (default: one on
    `device` seeded by chain_seed). a_true: the synthetic truth alms
    (build_model)."""
    device = resolve_device(device)
    refuse_host_loop(cfg, tod, dtype, pixind, te_cl, cg_groups, pol)
    outdir = outdir or cfg.output_dir or "./chains"
    os.makedirs(outdir, exist_ok=True)
    status = StatusFile(os.path.join(outdir, "comm_status.txt"))
    timer = Timer(device)
    status.update("init start")
    timer.start("init")
    model = build_model(cfg, nside=nside, lmax=lmax, synthetic=synthetic,
                        dtype=dtype, pol=pol, data_dir=data_dir,
                        device=device, a_true=a_true)
    meta, sys, plan = model.meta, model.sys, model.plan
    ts, ps = model.ts, model.ps
    gcfg = gibbs_mod.GibbsConfig(
        cl_cfg=model.cl_cfg, cg_tol=cfg.cg_tol, cg_maxiter=cfg.cg_maxiter,
        sample_cl=cfg.sample_powspec, optimize=cfg.operation == "optimize",
        cl_cfgs=model.cl_cfgs, cg_precond=str(cfg.cg_precond),
        cg_lmax_precond=int(cfg.cg_lmax_precond))
    nbins = max([len(gcfg.cl_cfg.bin_starts)]
                + [len(cc.bin_starts) for cc in model.cl_cfgs])
    niter = niter or cfg.num_gibbs_iter
    slots = full_gibbs.make_index_slots(model.diffuse, model.pcfgs) \
        if cfg.sample_specind else ()
    if generator is None:
        generator = torch.Generator(device)
        generator.manual_seed(chain_seed(cfg.base_seed, chain))

    chain_path = os.path.join(outdir, f"chain_c{chain:04d}.h5")
    ch = ChainFile(chain_path)
    try:
        return _chain(cfg, model, gcfg, ch, chain_path, outdir, status,
                      timer, niter, nbins, slots, synthetic, tod, generator,
                      draws, data_dir, device, dtype, verbose)
    finally:
        ch.close()


def _chain(cfg, model, gcfg, ch, chain_path, outdir, status, timer, niter,
           nbins, slots, synthetic, tod, generator, draws, data_dir, device,
           dtype, verbose) -> RunResult:
    meta, sys, plan = model.meta, model.sys, model.plan
    ts, ps = model.ts, model.ps
    first, prev = _read_start(ch, cfg, data_dir, status)
    ch.write_metadata({k: (",".join(map(str, v)) if isinstance(v, list)
                           else v) for k, v in meta.items()
                       if isinstance(v, (int, float, str, bool, list))})
    state = gibbs_mod.init_state(
        len(model.diffuse), meta["nmaps"], meta["lmax"], nbins, dtype=dtype,
        device=device, ntemp=0 if ts is None else ts.ntemp,
        nsrc=0 if ps is None else ps.pix.shape[0])
    state = dataclasses.replace(state, cl_bins=torch.as_tensor(
        prior_cl_bins(model, gcfg, nbins)).to(device, dtype))
    B = len(cfg.bands)
    gains = torch.ones(B, dtype=torch.float64, device=device)
    if prev is not None:
        state = dataclasses.replace(state, a=_alms_from(
            prev, model, state.a.dtype, device))
        if "gain" in prev and len(prev["gain"]) == B:
            gains = torch.as_tensor(prev["gain"], dtype=torch.float64,
                                    device=device)
    theta0 = [model.diffuse[s.ci].theta0[s.which] for s in slots]
    thetas = torch.tensor(theta0, dtype=torch.float64, device=device)
    beam_con = not bool(torch.allclose(
        sys.bl, torch.ones_like(sys.bl), atol=1e-4))
    timer.stop("init")
    status.update("init done")

    if cfg.output_input_model:
        write_input_model(ch, model, gcfg, state, gains)
        status.update("input model written as sample 999999")
        return RunResult(state, chain_path, thetas, [], timer)
    if cfg.output_debug_seds:
        raise NotImplementedError(f"OUTPUT_DEBUG_SEDS {HOST_LOOP}")

    bands = warm = None
    if tod and cfg.enable_tod:
        bands, state, warm = _tod_start(cfg, model, gcfg, ch, first, state,
                                        slots, thetas, generator, draws,
                                        status, timer, device, dtype)

    records, masks = [], {}
    it, attempt, consec = first + 1, first, 0
    while it <= niter:
        attempt += 1
        d = draws(attempt, bands) if draws is not None else None
        d = d or {}
        rec = {"it": it, "attempt": attempt, "tod_seconds": 0.0}
        if bands is not None:
            timer.start("tod")
            bands, sys = tod_phase(model, sys, slots, thetas, state, bands,
                                   it == first + 1, generator, d)
            rec["tod_seconds"] = timer.stop("tod")
        timer.start("gibbs")
        state, thetas, sys_f, gains, chi2_t = sky_phase(
            cfg, model, gcfg, slots, sys, state, thetas, gains, it, masks,
            generator, d, beam_con, data_dir, synthetic)
        chi2 = float(chi2_t)
        dt = timer.stop("gibbs")
        cg_it, cg_rr = int(state.cg_iters), float(state.cg_relres)
        ok = math.isfinite(chi2)
        if ok and str(cfg.cg_conv_crit).lower() != "fixed_iter" \
                and cg_it > 0:
            ok = math.isfinite(cg_rr) and cg_rr <= gcfg.cg_tol
        rec.update(ok=ok, chisq=chi2, cg_iters=cg_it, cg_relres=cg_rr,
                   seconds=dt + rec["tod_seconds"])
        records.append(rec)
        if not ok:
            consec += 1
            status.update(f"iter {it} REJECTED (cg={cg_it} relres="
                          f"{cg_rr:.2e} chisq={chi2:.1f}) [{consec} "
                          f"consecutive]")
            if verbose:
                print(f"iter {it:5d}  SAMPLE REJECTED  chisq {chi2:14.1f}  "
                      f"cg {cg_it:3d} ({cg_rr:.1e})  {dt:6.2f}s",
                      flush=True)
            if consec < MAX_CONSEC_REJECT:
                continue
            warnings.warn(
                f"iteration {it}: {consec} consecutive sample rejections; "
                f"accepting the last draw to avoid an infinite loop (the "
                f"reference would spin forever here - the model is likely "
                f"misconfigured)", stacklevel=2)
            rec["forced"] = True
        consec = 0
        status.update(f"iter {it} cg={cg_it} relres={cg_rr:.2e} "
                      f"chisq={chi2:.1f}")
        if verbose:
            print(f"iter {it:5d}  chisq {chi2:14.1f}  cg {cg_it:3d} "
                  f"({cg_rr:.1e})  {dt:6.2f}s", flush=True)
        if it % cfg.thinning == 0:
            timer.start("output")
            th = full_gibbs.theta_tuple(model.diffuse, slots, thetas.cpu())
            output.write_sample(ch, it, model, gcfg, sys_f, state, th,
                                gains.cpu().numpy(), chi2, outdir, cfg,
                                bands)
            timer.stop("output")
        it += 1
    status.update("done")
    if verbose:
        print(timer.report(), flush=True)
    return RunResult(state, chain_path, thetas, records, timer, warm)


def tod_phase(model, sys, slots, thetas, state, bands, first: bool,
              generator, d: dict):
    """The TOD pass of an attempt (run.py:2064-2201): every band on the
    model sky of (state, thetas) with the template and source rows, its
    binned maps and rms into the system. Reads nothing back to the host.
    Returns (bands, sys)."""
    sky_sys = full_gibbs.system_at(sys, model.diffuse, model.bps, slots,
                                   thetas)
    sky = chisq.full_sky(sky_sys, model.plan, state.a, model.ts, model.ps,
                         state.t, state.p)
    return tod_gibbs.tod_pass(bands, sys, sky, first, generator,
                              d.get("tod"))


def sky_phase(cfg, model, gcfg, slots, sys, state, thetas, gains, it: int,
              masks: dict, generator, d: dict, beam_con: bool, data_dir,
              synthetic: bool):
    """The rest of an attempt: full_gibbs_step (gibbs_step where no index is
    sampled), the gains, and the chi^2 of the full model as a device
    scalar. Reads nothing back to the host but the CG's own reads (its
    residual norms, and the joint preconditioner's build). Returns (state,
    thetas, the system at the new thetas, gains, chi^2)."""
    plan, ts, ps = model.plan, model.ts, model.ps
    if slots:
        state, thetas, sys_f = full_gibbs.full_gibbs_step(
            gcfg, model.diffuse, model.bps, slots, sys, plan, state, thetas,
            generator, beam_consistent=beam_con, draws=d, ts=ts, ps=ps)
    else:
        state = gibbs_mod.gibbs_step(gcfg, sys, plan, state, generator,
                                     draws=d, ts=ts, ps=ps)
        sys_f = sys
    if any(b.sample_gain for b in cfg.bands):
        gains = sample_gains(cfg, model, sys_f, state, gains, it, masks,
                             generator, d.get("eps_gain"), data_dir,
                             synthetic)
    chi2 = torch.sum((sys_f.data - chisq.full_sky(
        sys_f, plan, state.a, ts, ps, state.t, state.p)) ** 2
        * sys_f.inv_rms2)
    return state, thetas, sys_f, gains, chi2


def write_input_model(ch, model, gcfg, state, gains):
    """OUTPUT_INPUT_MODEL: the input model as sample 999999
    (commander.f90:132-137)."""
    lmax = model.meta["lmax"]
    cl_now = gibbs_mod.eval_cl_all(gcfg, model.sys, state.cl_bins)
    ell = np.arange(lmax + 1)
    dl = cl_now.cpu().numpy().astype(np.float64) * (ell * (ell + 1)
                                                    / (2 * np.pi))
    a = state.a.cpu().numpy().astype(np.complex128)
    ch.write_sample(999999, {
        d.name: {"alm": a[i], "Dl": dl[i],
                 "specind": np.asarray([float(np.mean(t)) for t in d.theta0],
                                       np.float64)}
        for i, d in enumerate(model.diffuse)}, gains=gains.cpu().numpy())


def _tod_start(cfg, model, gcfg, ch, first, state, slots, thetas, generator,
               draws, status, timer, device, dtype):
    """The TOD bands simulated from the noiseless sky (run.
    _setup_synthetic_tod, LFI kind), their state restored from the chain on
    resume (run.py:1703-1726), and the warm start (tod_gibbs.tod_burnin:
    3 passes, 1 after a restore). Returns (bands, state, the warm start's
    {cg_iters, cg_relres, npasses})."""
    sys, meta = model.sys, model.meta
    timer.start("tod_sim")
    sky0 = meta.get("sky_true")
    bands = tod_gibbs.simulate_bands(
        meta["nside"], sys.data if sky0 is None else sky0, sys.inv_rms,
        [b.nominal_freq_ghz * 1e9 for b in cfg.bands],
        nscan=cfg.synth_tod_nscan,
        ndet=cfg.synth_tod_ndet, ntod=cfg.synth_tod_ntod,
        sigma0_scale=cfg.synth_tod_sigma0_scale, fknee=cfg.synth_tod_fknee,
        seed=cfg.base_seed, dtype=dtype, device=device)
    timer.stop("tod_sim")
    restored = False
    if first > 0:
        saved = ch.read_tod_state(first)
        for b, band in enumerate(bands):
            st = saved.get(cfg.bands[b].label)
            if not st or tuple(st["gain"].shape) != tuple(
                    band.state.gain.shape):
                continue
            t = lambda k: torch.as_tensor(st[k]).to(device, dtype)
            bands[b] = band._replace(state=TodState(
                gain=t("gain"), sigma0=t("sigma0"), alpha=t("alpha"),
                fknee=t("fknee"), n_corr=band.state.n_corr))
            restored = True
    npasses = 1 if restored else 3
    timer.start("tod_burnin")
    d0 = draws(0, bands, npasses) if draws is not None else None
    sys_th = full_gibbs.system_at(sys, model.diffuse, model.bps, slots,
                                  thetas)
    bands, state = tod_gibbs.tod_burnin(gcfg, bands, sys_th, model.plan,
                                        state, generator, npasses=npasses,
                                        draws=d0, ts=model.ts, ps=model.ps)
    timer.stop("tod_burnin")
    status.update(f"tod init: {len(bands)} bands "
                  f"({'chain-restored' if restored else 'burned in'})")
    return bands, state, dict(cg_iters=int(state.cg_iters),
                              cg_relres=float(state.cg_relres),
                              npasses=npasses)
