"""run()'s Gibbs loop: chain start, resume, the TOD routes, the fast path
and the host loop, the per-sample reject rule, the status file and the
thinning output (torch).

Counterpart of commander_tpu.run.run (run.py:1355-2566; the reference's
commander.f90:160-254). Per chain:

  1. build_model (driver/model.py), the Gibbs config (with --cg-groups its
     CG sampling groups, sampling/groups.py; run.py:1406-1420), the chain
     file chain_c<chain>.h5 in outdir;
  2. the start: zero amplitudes, each component's C_b the mean of its prior
     spectrum over the bin (run.py:1456-1474); on resume the chain's last
     sample is dropped and the one before it seeds the alms and gains
     (commander.f90:160-174, run.py:1438-1446, :1492-1512); without a
     resume INIT_CHAIN ('file.h5:sample', a chain of either package) does;
     OUTPUT_INPUT_MODEL writes the input model, OUTPUT_DEBUG_SEDS every
     component's SED to sed.dat (run.py:1536-1555), and the run ends;
  3. with --tod: the TOD of every band with a TOD type simulated from the
     noiseless sky (map-level bands, BAND_TOD_TYPE none, keep their maps;
     BAND_TOD_TYPE WMAP gives a differential block, tod/differential.py),
     the TOD state (and the monopoles) restored from the chain on resume,
     and the warm start: gibbs_step on the map-level data, then 3 TOD
     passes on its sky (1 after a restore). run() defers it on an
     accelerator in float32 (run.py:1636-1643, :1728-1751); where its
     deferred fast route then runs (plain synthetic LFI bands, no bandpass
     or monopole sampling: the card in float32, or fullgibbs="encoded")
     the port follows run()'s host composition of that route (:2012-2021;
     ROADMAP queue 3 item 9), else run() takes its host loop: a
     differential band always sends the chain there, in either dtype, as
     run()'s _accel_tod_ok asks every band to be LFI (:1727-1733);
  4. per attempt on the fast path (run.py:1777-1794: scalar full-sky
     indices, none of host_loop_reasons): the TOD pass and
     full_gibbs_step, or full_gibbs_step alone; the gains of the bands
     that sample them (run.py:2376-2431: GLS with the +-0.01 clamp and the
     soft prior, or the cross-C_l estimator over BAND_GAIN_LMIN..LMAX,
     with the calibration mask; hard priors re-drawn every
     NUMITER_RESAMPLE_HARD_GAIN_PRIORS iterations); the chi^2 of the full
     model;
  5. per attempt of the host loop (run.py:2062-2436; host_reasons, TOD off
     the fast route, --cg-groups, OUTPUT_EVERY_NTH_CG_ITERATION): with TOD
     its host TOD stage (host_tod_phase: per band the pass on the full
     model sky, the monopoles carried, the band-level bandpass MH on the
     TOD chi^2, the binned rows into the system; then the 4D maps of the
     LFI bands); then
     host_phase: gibbs_step on the current system (F, or F_pix where an
     index is a map; the groups' sweep; the chunked CG with its dumps),
     with --te-cl on T/Q/U the TE-coupled inverse-Wishart C_ell draw per
     component, whose symmetric root becomes the next solve's prior (a
     draw that is not finite or not positive-definite rejects the sample),
     with RESAMPLE_CMB three joint (alm, C_ell) MH moves on the CMB, then
     driver/specind.specind_step (every index by its branch, the mixing
     rebuilt at the bandpass shifts) and, where a source catalog gives some
     alpha rms > 0, the sources' spectral indices (a grid draw, or the
     Powell fit in optimize mode) and their stamps remade; the gains and
     the chi^2. The system, the theta maps, driver/specind.HostState and
     the bandpass shifts carry from one attempt to the next, a rejected
     one's included. A resume restores what run() restores (the alms, the
     gains, the TOD states and monopoles): the indices and the bandpass
     shifts restart from their defaults, as run()'s do;
  6. the reject rule (run.py:2433-2458, commander.f90:229-251): a sample
     whose chi^2 is not finite, or whose CG stopped above its tolerance
     (CG_CONVERGENCE_CRITERION other than fixed_iter, and at least one CG
     iteration), is rejected: the iteration counter stays, nothing is
     written, and the next attempt starts from the state the rejected one
     left (as run.py's does). After 25 rejects in a row the draw is
     accepted with a warning;
  7. at every THINNING_FACTOR-th accepted iteration: driver/output.py.

What stays refused raises NotImplementedError naming its ROADMAP item
(refuse_host_loop): archive TOD (queue 1 item 6, which brings the
sidelobe, zodi and per-detector bandpass inputs), the bandpass move on a
differential band (queue 3 item 17), QU-covariance noise with template or
source rows (queue 3 item 12).

Randomness: a torch.Generator on the run's device (default: seeded from
BASE_SEED and the chain index, and on a resume or a warm start from a
sample also from the resume point, as run() folds it into its state key),
or `draws`, a function of the attempt number returning every draw of that
attempt ({eta1, eta2, gamma, u, eta_t, eta_p, eps_gain}, and "tod": one
pass_draws dict per band, None for a band without TOD; in the host loop
also "bp": one {z, u} per band that samples its bandpass, "groups": one
draws dict per CG sampling group, "te": one sample_cl_binned_invwishart_TE
draws dict per component, "resample": three {eps, u}, "specind":
specind_step's draws, "alpha_u": the sources' uniforms), used in place of
the generator's; attempt 0 is the TOD warm start ({eta1, eta2, gamma,
eta_t, eta_p, "tod": a list of passes}). Every draw is made on the
generator's own device (utils/device.randn), so a CUDA generator drives a
CPU run with the card's numbers. A rejected attempt consumes its draws.
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
from ..model.cl import (bin_index_table, full_cl_matrix,
                        sample_cl_binned_invwishart_TE, sqrt_psd)
from ..sampling import chisq
from ..sampling import full_gibbs
from ..sampling import gain as gain_mod
from ..sampling import gibbs as gibbs_mod
from ..sampling import joint
from ..sampling import mh
from ..sampling import tod_gibbs
from ..sampling.tod_gibbs import has_tod_type, is_differential
from ..tod import bandpass_mh
from ..tod.model import TodState
from ..tod.process import static_signal, tod_chisq
from ..utils.device import resolve_device
from ..utils.status import StatusFile, Timer
from . import output
from . import specind as host_specind
from .model import Model, build_model, diffuse_configs

MAX_CONSEC_REJECT = 25
# the band-level bandpass proposal's step (run.py:2134) and the 4D maps'
# psi bins (run.py:2212)
BP_STEP_HZ = 0.1e9
NPSI_4D = 64


class RunResult(NamedTuple):
    """The last state, the chain file, the last parameter vector (the fast
    path's (nslot,) tensor; the host loop's per-component lists of values,
    0-d tensors or (P,) maps), one record per attempt: {it, attempt, ok,
    chisq, cg_iters, cg_relres, seconds (the step), tod_seconds; the host
    loop's index records under "specind" and MH acceptances under
    "resample"}, the timers, with --tod the warm start's {cg_iters,
    cg_relres, npasses}, the host loop's carried index state, the system
    the next attempt would take (the fast path's base system), the model
    (its source rows as the last attempt left them), with --tod the bands
    (None for a band without TOD) and the bands' bandpass shifts (Hz)."""
    state: gibbs_mod.GibbsState
    chain_path: str
    thetas: torch.Tensor | list
    records: list
    timer: Timer
    warm: dict | None = None
    host: host_specind.HostState | None = None
    sys: object = None
    model: Model | None = None
    bands: list | None = None
    bp_deltas: np.ndarray | None = None


def host_loop_reasons(cfg, pixind: bool = False, te_cl: bool = False
                      ) -> list:
    """What takes a configuration off run()'s fast path onto its host loop
    (run.py:1777-1788); empty where the fast path takes it."""
    why = [f for f, on in (("--pixind", pixind), ("--te-cl", te_cl),
                           ("RESAMPLE_CMB", cfg.resample_cmb),
                           ("ALMSAMP_PIXREG", cfg.almsamp_pixreg)) if on]
    for p in diffuse_configs(cfg):
        if p.lmax_ind is not None and p.lmax_ind >= 0:
            why.append(f"COMP_LMAX_IND {p.lmax_ind} of {p.label}")
        for name, info in p.indices.items():
            if info.get("smoothing_scale"):
                why.append(f"index smoothing of {p.label} {name}")
            if int(info.get("poltype") or 1) > 1:
                why.append(f"POLTYPE {info['poltype']} of {p.label} {name}")
            if np.ndim(info.get("default")):
                why.append(f"map-valued {p.label} {name}")
    return why


def _qucov_with_rows(cfg, pol: bool, synthetic: bool, data_dir) -> bool:
    """Whether build_model would read QU-covariance noise blocks (a QUcov
    noise file with four rows on a T/Q/U run from FITS maps) into a model
    with template or source rows."""
    from ..io.fits import read_map

    rows = any(c.ctype in ("md", "cmb_relquad")
               or c.cclass in ("template", "ptsrc") for c in cfg.comps)
    if synthetic or not rows or not (pol and all(b.polarized
                                                 for b in cfg.bands)):
        return False
    for b in cfg.bands:
        path = os.path.join(data_dir or ".", b.noisefile or "")
        if str(b.noise_format).lower() == "qucov" and b.noisefile \
                and os.path.exists(path) and read_map(path).shape[0] >= 4:
            return True
    return False


def refuse_host_loop(cfg, tod: bool, dtype=None, pixind=False, te_cl=False,
                     cg_groups=False, pol=False, synthetic: bool = False,
                     data_dir=None):
    """NotImplementedError, before the model is built, for what is not
    ported: the inputs that only archive TOD brings (ROADMAP queue 1 item
    6: the archive reader, with the sidelobe, zodi and per-detector
    bandpass terms); the bandpass move on a differential (WMAP) band, where
    run()'s general form hands the band's DiffTodBlock to tod_chisq, which
    reads block.pix and raises (run.py:2174-2179; queue 3 item 17); and
    QU-covariance noise blocks beside template or source rows, whose joint
    system the JAX package weighs by the diagonal alone (queue 3 item
    12)."""
    why = []
    if tod and cfg.enable_tod:
        if any(b.tod_filelist for b in cfg.bands):
            why.append("archive TOD (BAND_TOD_FILELIST) is not ported "
                       "(ROADMAP queue 1 item 6)")
        bp_diff = [b.label for b in cfg.bands
                   if is_differential(b) and b.sample_bandpass]
        if bp_diff:
            why.append(f"BAND_SAMP_BANDPASS on a differential (WMAP) band "
                       f"({', '.join(bp_diff)}) is refused: the JAX "
                       f"package's general bandpass form fails on a "
                       f"differential block (ROADMAP queue 3 item 17)")
    if _qucov_with_rows(cfg, pol, synthetic, data_dir):
        why.append("QU-covariance noise (BAND_NOISE_FORMAT QUcov) beside "
                   "template or source rows is refused: the JAX package's "
                   "joint system drops the blocks there (ROADMAP queue 3 "
                   "item 12)")
    if why:
        raise NotImplementedError("; ".join(why))


def chain_seed(base_seed: int, chain: int, resume: int | None = None
               ) -> int:
    """The seed of a chain's generator: BASE_SEED and the chain index
    folded into one 63-bit integer (the reference scrambles per rank,
    comm_param_mod.f90:334-357); where a sample seeds the chain (a resume
    from sample `resume`, or INIT_CHAIN with resume 0) max(resume, 1) is
    folded in too, as run() folds it into its state key (run.py:1504-1506),
    so that a resumed chain does not repeat the fresh chain's first
    draws."""
    seed = (int(base_seed) * 1_000_003 + int(chain)) % (2 ** 63)
    if resume is not None:
        seed = (seed * 1_000_003 + max(int(resume), 1)) % (2 ** 63)
    return seed


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
    m = healpix.ud_map(m[0] if m.ndim > 1 else m, plan.nside)
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
        a_true=None, rng_device=None, fullgibbs="auto",
        mono_guard: bool = False) -> RunResult:
    """Execute one chain of the Gibbs loop on `device` (None: the CUDA
    card); returns a RunResult. generator: the chain's (default: one on
    rng_device, else `device`, seeded by chain_seed). a_true: the synthetic
    truth alms (build_model). fullgibbs: run()'s own switch: "auto" defers
    the TOD warm start to the fast route in float32 on the card alone;
    "encoded" takes that route where the bands allow it, as run() does on
    the CPU with it. In float64 run() takes its host loop there; the port's
    "encoded" route in float64 is kept for tests/test_torch_driver_tod.py's
    float64 leg alone. mono_guard: the port-only guard of the TOD
    monopole draw (tod/model.sample_mono; ROADMAP queue 3 item 4a)."""
    device = resolve_device(device)
    refuse_host_loop(cfg, tod, dtype, pixind, te_cl, cg_groups, pol,
                     synthetic, data_dir)
    outdir = outdir or cfg.output_dir or "./chains"
    os.makedirs(outdir, exist_ok=True)
    status = StatusFile(os.path.join(outdir, "comm_status.txt"))
    timer = Timer(device)
    status.update("init start")
    timer.start("init")
    model = build_model(cfg, nside=nside, lmax=lmax, synthetic=synthetic,
                        dtype=dtype, pol=pol, data_dir=data_dir,
                        device=device, a_true=a_true)
    if te_cl:
        # the TE draw runs the shared joint-Stokes config (run.py:1404-1405)
        model = model._replace(cl_cfgs=())
    groups = ()
    if cg_groups:
        from ..sampling.groups import build_groups
        groups = build_groups(
            cfg, [d.name for d in model.diffuse],
            model.meta.get("template_names"), model.ps is not None,
            ptsrc_labels=[c.label for c in cfg.comps
                          if c.cclass == "ptsrc"],
            nmaps=model.meta["nmaps"], npix=12 * model.meta["nside"] ** 2,
            data_dir=data_dir)
    gcfg = gibbs_mod.GibbsConfig(
        cl_cfg=model.cl_cfg, cg_tol=cfg.cg_tol, cg_maxiter=cfg.cg_maxiter,
        sample_cl=cfg.sample_powspec and not te_cl,
        optimize=cfg.operation == "optimize", cl_cfgs=model.cl_cfgs,
        cg_precond=str(cfg.cg_precond),
        cg_lmax_precond=int(cfg.cg_lmax_precond), groups=groups)
    nbins = max([len(gcfg.cl_cfg.bin_starts)]
                + [len(cc.bin_starts) for cc in model.cl_cfgs])
    niter = niter or cfg.num_gibbs_iter
    slots = full_gibbs.make_index_slots(model.diffuse, model.pcfgs) \
        if cfg.sample_specind else ()
    # the TOD route (run.py:1615-1751): run() defers the warm start to its
    # fast route in float32 on an accelerator, or with fullgibbs
    # "encoded"; plain synthetic bands keep that route, any TOD extra sends
    # the chain to the host loop
    tod_on = bool(tod and cfg.enable_tod)
    tod_bands = [tod_on and has_tod_type(b) for b in cfg.bands]
    deferred = tod_on and (fullgibbs == "encoded" or (
        dtype == torch.float32 and device.type == "cuda"))
    tod_fast_ok = any(tod_bands) and not cfg.sample_tod_mono and not any(
        b.sample_bandpass for b in cfg.bands) and not any(
        on and is_differential(b) for on, b in zip(tod_bands, cfg.bands))
    cg_dump = int(cfg.output_cg_freq or 0)
    host = bool(host_loop_reasons(cfg, pixind, te_cl)) \
        or (cfg.sample_specind and not slots) or bool(groups) \
        or cg_dump > 0 \
        or (any(tod_bands) and not (deferred and tod_fast_ok))
    opts = dict(host=host, pixind=pixind, te_cl=te_cl, pol=pol, chain=chain,
                rng_device=rng_device, tod_bands=tod_bands, cg_dump=cg_dump,
                mono_guard=mono_guard)
    chain_path = os.path.join(outdir, f"chain_c{chain:04d}.h5")
    ch = ChainFile(chain_path)
    try:
        return _chain(cfg, model, gcfg, ch, chain_path, outdir, status,
                      timer, niter, nbins, slots, synthetic, tod_on,
                      generator, draws, data_dir, device, dtype, verbose,
                      opts)
    finally:
        ch.close()


def _chain(cfg, model, gcfg, ch, chain_path, outdir, status, timer, niter,
           nbins, slots, synthetic, tod, generator, draws, data_dir, device,
           dtype, verbose, opts) -> RunResult:
    meta, sys, plan = model.meta, model.sys, model.plan
    ts, ps = model.ts, model.ps
    first, prev = _read_start(ch, cfg, data_dir, status)
    if generator is None:
        generator = torch.Generator(opts["rng_device"] or device)
        generator.manual_seed(chain_seed(
            cfg.base_seed, opts["chain"], None if prev is None else first))
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
        write_debug_seds(os.path.join(outdir, "sed.dat"), model.diffuse)
        status.update("SEDs dumped to sed.dat")
        return RunResult(state, chain_path, thetas, [], timer)

    bands = warm = None
    bp_deltas = np.zeros(B)
    if tod:
        bands, restored = _simulate(cfg, model, ch, first, device, dtype,
                                    opts, timer)
        if any(b is not None and b.has_templates for b in bands):
            # run()'s _accel_tod_ok (run.py:1727-1733): a band's sidelobe
            # or zodi term takes the chain to the host loop
            opts = dict(opts, host=True)
    hs = None
    if opts["host"]:
        # run()'s host loop: per-component lists of values, every index at
        # its default (run.py:1755-1759)
        thetas = [list(d.theta0) for d in model.diffuse]
        hs = host_specind.HostState()
    if tod:
        # the host loop's warm start runs on the model's own system; the
        # deferred route's on the system at its index slots
        sys_warm = sys if opts["host"] else full_gibbs.system_at(
            sys, model.diffuse, model.bps, slots, thetas)
        bands, state, warm = _tod_start(gcfg, model, bands, restored, state,
                                        sys_warm, generator, draws, status,
                                        timer)

    records, masks = [], {}
    it, attempt, consec = first + 1, first, 0
    while it <= niter:
        attempt += 1
        d = draws(attempt, bands) if draws is not None else None
        d = d or {}
        rec = {"it": it, "attempt": attempt, "tod_seconds": 0.0}
        if bands is not None:
            timer.start("tod")
            if opts["host"]:
                bands, sys = host_tod_phase(
                    cfg, model, sys, state, thetas, bands, bp_deltas,
                    it == first + 1, generator, d, outdir, it, rec, timer)
            else:
                bands, sys = tod_phase(model, sys, slots, thetas, state,
                                       bands, it == first + 1, generator, d)
            rec["tod_seconds"] = timer.stop("tod")
        timer.start("gibbs")
        cl_ok = True
        if opts["host"]:
            model, state, sys, gains, chi2_t, cl_ok = host_phase(
                cfg, model, gcfg, sys, state, thetas, hs, gains, it, masks,
                generator, d, data_dir, synthetic, opts, rec, outdir,
                bp_deltas)
            sys_f = sys
        else:
            state, thetas, sys_f, gains, chi2_t = sky_phase(
                cfg, model, gcfg, slots, sys, state, thetas, gains, it,
                masks, generator, d, beam_con, data_dir, synthetic)
        chi2 = float(chi2_t)
        dt = timer.stop("gibbs")
        cg_it, cg_rr = int(state.cg_iters), float(state.cg_relres)
        ok = cl_ok and math.isfinite(chi2)
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
            if opts["host"]:
                print(_host_lines(model, rec, cfg), flush=True)
        if it % cfg.thinning == 0:
            timer.start("output")
            th = thetas if opts["host"] else full_gibbs.theta_tuple(
                model.diffuse, slots, thetas.cpu())
            output.write_sample(ch, it, model, gcfg, sys_f, state, th,
                                gains.cpu().numpy(), chi2, outdir, cfg,
                                bands, None if hs is None
                                else hs.thetas_pol, bp_deltas)
            timer.stop("output")
        it += 1
    status.update("done")
    if verbose:
        print(timer.report(), flush=True)
    return RunResult(state, chain_path, thetas, records, timer, warm, hs,
                     sys, model, bands, bp_deltas)


def _host_lines(model, rec, cfg) -> str:
    """The host loop's index records of an attempt, one line per parameter
    (component.parameter, branch, seconds, the MH acceptances), the
    RESAMPLE_CMB acceptances, per band its bandpass move (the proposal,
    the two TOD chi^2, whether it was taken) and a monopole draw that was
    not usable."""
    out = [f"      mono {cfg.bands[b].label} draw not usable: the "
           f"monopoles kept" for b, ok in (rec.get("mono_ok") or {}).items()
           if not ok]
    for b, r in (rec.get("bp") or {}).items():
        out.append(f"      bandpass {cfg.bands[b].label} {r['form']} "
                   f"delta {r['delta']:.6g} -> prop {r['prop']:.6g} Hz  "
                   f"chi2 {r['chi2_cur']:.10g} -> {r['chi2_prop']:.10g}  "
                   f"{'accepted' if r['accepted'] else 'rejected'}")
    for (ci, j), r in (rec.get("specind") or {}).items():
        name = list(model.pcfgs[ci].indices)[j]
        acc = f" acc {r['accepted']}/{host_specind.MH_STEPS}" \
            if "accepted" in r else ""
        out.append(f"      index {model.diffuse[ci].name}.{name} "
                   f"{r['branch']} {r['seconds']:.3f}s{acc}")
    if "resample" in rec:
        out.append(f"      resample acc {rec['resample']}")
    return "\n".join(out)


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


def host_phase(cfg, model, gcfg, sys, state, thetas, hs, gains, it: int,
               masks: dict, generator, d: dict, data_dir, synthetic: bool,
               opts: dict, rec: dict, outdir=None, bp_deltas=None):
    """An attempt of run()'s host loop after its TOD stage (run.py:
    2256-2436): gibbs_step on the current system (with
    OUTPUT_EVERY_NTH_CG_ITERATION and neither rows nor user groups, its
    chunked CG with the dumps, cg_dump_step); with --te-cl on T/Q/U the TE
    draw; with RESAMPLE_CMB the three joint MH moves; the index step (the
    mixing rebuilt at the bandpass shifts bp_deltas) and the sources'
    indices; the gains; the chi^2 of the full model as a device scalar.
    thetas and hs are updated in place; the per-parameter index records go
    to rec["specind"], the MH acceptances to rec["resample"]. Returns
    (model with the current source set, state, the system of the next
    attempt, gains, chi^2, whether the C_ell draw was valid)."""
    plan, ts = model.plan, model.ts
    dump = None
    if opts.get("cg_dump") and not cfg.cg_user_groups and ts is None \
            and model.ps is None:
        dump = (opts["cg_dump"], cg_dump_writer(outdir, state.it + 1))
        # run()'s dump step draws the amplitudes alone, without groups
        gcfg = dataclasses.replace(gcfg, groups=())
    state = gibbs_mod.gibbs_step(gcfg, sys, plan, state, generator,
                                 draws=d, ts=ts, ps=model.ps, cg_dump=dump)
    cl_ok = True
    if opts["te_cl"] and model.meta["nmaps"] == 3:
        sys, state, cl_ok = te_cl_step(gcfg, sys, state, generator,
                                       d.get("te"))
    if cfg.resample_cmb:
        state, rec["resample"] = resample_cmb(model, gcfg, sys, state,
                                              generator, d.get("resample"))
    if cfg.sample_specind:
        sys, rec["specind"] = host_specind.specind_step(
            cfg, model.pcfgs, model.diffuse, model.bps, sys, plan, state,
            thetas, hs, pixind=opts["pixind"], pol=opts["pol"],
            data_dir=data_dir, synthetic=synthetic, ts=ts, ps=model.ps,
            generator=generator, draws=d.get("specind"),
            deltas=None if bp_deltas is None else bp_deltas.tolist())
        model, state = ptsrc_alpha_step(model, gcfg, sys, state, generator,
                                        d.get("alpha_u"))
    if any(b.sample_gain for b in cfg.bands):
        gains = sample_gains(cfg, model, sys, state, gains, it, masks,
                             generator, d.get("eps_gain"), data_dir,
                             synthetic)
    chi2 = torch.sum((sys.data - chisq.full_sky(
        sys, plan, state.a, ts, model.ps, state.t, state.p)) ** 2
        * sys.inv_rms2)
    return model, state, sys, gains, chi2, cl_ok


def cg_dump_writer(outdir: str, gibbs_it: int):
    """The dump of OUTPUT_EVERY_NTH_CG_ITERATION (run.py:1596-1600): the
    amplitudes at CG iteration i of Gibbs step gibbs_it (the state's step
    counter, as run() numbers them) to cg_amp_k<gibbs_it>_i<i>.npz, real
    and imaginary parts in float32."""
    def dump(cg_i: int, a: torch.Tensor):
        a = a.detach().to("cpu")
        np.savez(os.path.join(outdir, f"cg_amp_k{gibbs_it:06d}_i"
                                      f"{cg_i:04d}.npz"),
                 a_re=a.real.numpy().astype(np.float32),
                 a_im=a.imag.numpy().astype(np.float32))
    return dump


def write_debug_seds(path: str, diffuse):
    """OUTPUT_DEBUG_SEDS (run.py:1536-1555; dump_components,
    comm_signal_mod.f90:132-152): each component's response to a delta
    bandpass at 500 frequencies from 1 GHz to 3 THz, at the mean of its
    default parameters, as text."""
    from ..instrument.bandpass import delta_bandpass
    from ..model.mixing import mixing_element

    nus = np.geomspace(1e9, 3e12, 500)
    with open(path, "w") as f:
        for d in diffuse:
            f.write(f"# Component = {d.name}\n")
            th = tuple(torch.tensor(float(np.mean(t)), dtype=torch.float64)
                       for t in d.theta0)
            for nu in nus:
                val = float(mixing_element(d, delta_bandpass(nu), th,
                                           device="cpu"))
                f.write(f"  {nu:16.8e}  {val:16.8e}\n")
            f.write("\n")


def host_tod_phase(cfg, model, sys, state, thetas, bands, bp_deltas,
                   first: bool, generator, d: dict, outdir, it: int,
                   rec: dict, timer=None, sky=None):
    """The host loop's TOD stage (run.py:2064-2202): per band with TOD, in
    band order, the pass on the full model sky of the current system (F,
    or F_pix; chisq.full_sky) with scan rejection off on the chain's first
    iteration, the monopoles carried; with BAND_SAMP_BANDPASS the
    band-level bandpass move (bandpass_step: bp_deltas and the system's
    mixing updated); the binned rows into the system (hit pixels take the
    map and 1/rms, unhit ones inv_rms 0). Then, every
    TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER-th iteration, the 4D maps. The
    bandpass records go to rec["bp"], the move's seconds to
    rec["bp_seconds"], whether each band's monopole draw was usable (else
    its monopoles were kept: tod/model.sample_mono) to rec["mono_ok"].
    sky: the model sky (B, S, P) where the caller has it.
    Returns (bands, sys)."""
    plan = model.plan
    if sky is None:
        sky = chisq.full_sky(sys, plan, state.a, model.ts, model.ps,
                             state.t, state.p)
    sl_all = tod_gibbs.band_sl_fmaps(bands, sys, state.a)
    data, inv_rms = sys.data.clone(), sys.inv_rms.clone()
    tod_d, bp_d = d.get("tod"), d.get("bp")
    bands = list(bands)
    rec["bp"], rec["bp_seconds"], rec["mono_ok"] = {}, 0.0, {}
    for b, band in enumerate(bands):
        if band is None:
            continue
        band, prod = tod_gibbs._band_pass(band, sky[b], first, generator,
                                          None if tod_d is None
                                          else tod_d[b], sl_all[b])
        bands[b] = band
        if "mono_ok" in prod:
            rec["mono_ok"][b] = bool(prod["mono_ok"])
        if cfg.bands[b].sample_bandpass:
            if timer is not None:
                timer.start("bandpass")
            sys, rec["bp"][b] = bandpass_step(
                cfg, model, sys, state, thetas, band, b, sky[b], bp_deltas,
                generator, None if bp_d is None else bp_d[b], sl_all[b])
            if timer is not None:
                rec["bp_seconds"] += timer.stop("bandpass")
        k = prod["map"].shape[0]
        hit = prod["rms"] > 0
        data[b, :k] = torch.where(hit, prod["map"].to(data.dtype),
                                  data[b, :k])
        inv_rms[b, :k] = torch.where(
            hit, 1.0 / torch.where(hit, prod["rms"], 1.0).to(data.dtype), 0.0)
    sys = dataclasses.replace(sys, data=data, inv_rms=inv_rms,
                              inv_rms2=inv_rms ** 2)
    nth = int(cfg.tod_4d_nth_iter or 0)
    if nth > 0 and it % nth == 0:
        write_4d_maps(cfg, bands, outdir, it)
    return bands, sys


def bandpass_step(cfg, model, sys, state, thetas, band, b: int, sky_b,
                  bp_deltas: np.ndarray, generator, draws=None,
                  sl_fmaps=None):
    """The band-level bandpass move on the TOD chi^2 (run.py:2130-2186;
    sample_bp, comm_tod_bandpass_mod.f90:28): the proposal bp_deltas[b] +
    0.1 GHz z, both chi^2 under the band's new TOD state. With scalar
    indices and no F_pix (the fast form) through the unit component
    streams, made once for the band (bandpass_mh); else the mixing rebuilt
    at the proposal and tod_chisq on its model sky against sky_b, the
    band's sky of this stage. Accepted by mh.accept_bandpass_tod; then the
    mixing is rebuilt at the new shifts. Both forms carry the band's static
    terms: the sidelobe term of sl_fmaps (the stage's f-maps), the zodi
    template and the monopoles (run.py:2111, :2150, :2169). draws:
    optional {"z": a normal, "u": a uniform} (float64). bp_deltas is
    updated in place. Returns (sys, {form, delta, prop, chi2_cur,
    chi2_prop, accepted})."""
    from ..utils.device import rand, randn

    plan, diffuse, bps = model.plan, model.diffuse, model.bps
    dev = sys.data.device
    if draws is None:
        draws = {"z": randn((), generator, torch.float64, dev),
                 "u": rand((), generator, torch.float64, dev)}
    delta = float(bp_deltas[b])
    prop = delta + BP_STEP_HZ * float(draws["z"])
    tcfg, blk, tst = band.cfg, band.block, band.state
    terms = dict(sl_fmaps=sl_fmaps, s_extra=band.zodi, mono=band.mono,
                 sl_pix=band.sl_pix)
    fast = sys.F_pix is None and not any(
        host_specind._is_map(t) for th in thetas for t in th)
    if fast:
        comp_tod = bandpass_mh.unit_comp_tod(plan, sys.bl[b], state.a, blk,
                                             tcfg.pol)
        s_stat = static_signal(tcfg, blk, tod_gibbs.pixel_vectors(
            tcfg.nside, blk.tod.dtype, str(blk.tod.device)), **terms)
        nd = blk.tod.shape[1]

        def c2(delta_b):
            F_row = bandpass_mh.det_mixing(
                diffuse, [bps[b]] * nd, [tuple(th) for th in thetas],
                torch.full((nd,), delta_b, dtype=torch.float64, device=dev),
                cfg.bands[b].bandpass_model)
            return torch.sum(bandpass_mh.chisq_det(F_row, comp_tod, s_stat,
                                                   blk, tst))
        c2_cur, c2_prop = c2(delta), c2(prop)
        del comp_tod, s_stat
    else:
        ds = bp_deltas.copy()
        ds[b] = prop
        sys_prop = host_specind.rebuild_mixing(diffuse, bps, thetas, sys,
                                               deltas=ds.tolist())
        sky_prop = chisq.full_sky(sys_prop, plan, state.a, model.ts,
                                  model.ps, state.t, state.p)
        pv = tod_gibbs.pixel_vectors(tcfg.nside, blk.tod.dtype,
                                     str(blk.tod.device))
        c2_cur = tod_chisq(tcfg, blk, tst, sky_b, pv, **terms)
        c2_prop = tod_chisq(tcfg, blk, tst, sky_prop[b], pv, **terms)
        del sky_prop, sys_prop
    c2_cur, c2_prop = float(c2_cur), float(c2_prop)
    new, acc = mh.accept_bandpass_tod(c2_cur, c2_prop, delta, prop,
                                      u=draws["u"])
    if acc:
        bp_deltas[b] = new
        sys = host_specind.rebuild_mixing(diffuse, bps, thetas, sys,
                                          deltas=bp_deltas.tolist())
    return sys, dict(form="fast" if fast else "general", delta=delta,
                     prop=prop, chi2_cur=c2_cur, chi2_prop=c2_prop,
                     accepted=acc)


def write_4d_maps(cfg, bands, outdir: str, it: int):
    """TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER (run.py:2204-2226;
    comm_4D_map_mod.f90:97): per LFI band with TOD (a differential band
    has none, run.py:2210), tod_4D_<label>_k<it>.h5 with one group per
    detector, its calibrated, n_corr-subtracted TOD binned by (pixel, psi)
    in NPSI_4D bins of weight gain^2 / sigma0^2."""
    from ..tod.maps4d import bin_4d, write_4d_hdf

    for b, band in enumerate(bands):
        if band is None or band.kind != "lfi":
            continue
        blk, st = band.block, band.state
        calib = (blk.tod - st.n_corr) / torch.clamp(st.gain[..., None],
                                                     min=1e-30)
        ivar = st.gain ** 2 / torch.clamp(st.sigma0 ** 2, min=1e-30)
        path = os.path.join(outdir, f"tod_4D_{cfg.bands[b].label}_"
                                    f"k{it:06d}.h5")
        for det in range(blk.tod.shape[1]):
            ss, ws, mn = bin_4d(calib[:, det], blk.pix[:, det],
                                blk.psi[:, det], blk.mask[:, det],
                                ivar[:, det], 12 * band.cfg.nside ** 2,
                                NPSI_4D)
            write_4d_hdf(path, f"det{det}", ss, ws, mn)


def te_cl_step(gcfg, sys, state, generator, draws=None):
    """The TE-coupled C_ell draw of every component (run.py:2266-2295; the
    reference's sample_Cls_inverse_wishart, comm_Cl_mod.f90:865-1006): the
    binned TE inverse-Wishart and B inverse gamma, the (nl, 3, 3) matrices'
    symmetric root as the next solve's prior, the Stokes diagonal into
    cl_bins. draws: optional list of per-component draws dicts. Returns
    (sys, state, valid): a matrix that is not finite or has an eigenvalue
    below -1e-12 of its max (ell >= 2) makes the sample invalid."""
    idx = bin_index_table(gcfg.cl_cfg)
    bins = state.cl_bins.clone()
    mats = []
    for ci in range(state.a.shape[0]):
        cl_te, cl_b = sample_cl_binned_invwishart_TE(
            gcfg.cl_cfg, state.a[ci], generator,
            None if draws is None else draws[ci])
        mats.append(full_cl_matrix(cl_te, cl_b, idx))
        bins[ci, 0] = cl_te[:, 0, 0]
        bins[ci, 1] = cl_te[:, 1, 1]
        bins[ci, 2] = cl_b
    cl_mat = torch.stack(mats)                          # (C, nl, 3, 3)
    cm = cl_mat.detach().to("cpu", torch.float64).numpy()
    valid = bool(np.isfinite(cm).all())
    if valid:
        ev = np.linalg.eigvalsh(cm[:, 2:])
        valid = not (ev < -1e-12 * max(1.0, np.abs(cm[:, 2:]).max())).any()
    sys = dataclasses.replace(
        sys, sqrtS_mat=sqrt_psd(cl_mat),
        cl=torch.diagonal(cl_mat, dim1=-2, dim2=-1).permute(0, 2, 1))
    return sys, dataclasses.replace(state, cl_bins=bins), valid


def resample_cmb(model, gcfg, sys, state, generator, draws=None):
    """RESAMPLE_CMB: three joint (alm, C_ell) MH moves on the CMB component
    (run.py:2299-2314; commander.f90:222-226), where its C_ell is sampled
    (binned). draws: optional list of three {eps, u}. Returns (state, the
    three acceptances as host bools)."""
    cmb = next((i for i, d in enumerate(model.diffuse) if d.sed == "cmb"), 0)
    cfgs = gcfg.cl_cfgs
    if cfgs and cfgs[cmb].kind != "binned":
        return state, []
    cc = cfgs[cmb] if cfgs else gcfg.cl_cfg
    a, clb, acc = state.a, state.cl_bins, []
    for k in range(3):
        a, clb, ok = mh.sample_joint_alm_cl(
            cc, sys, model.plan, a, clb, cmb, generator=generator,
            draws=None if draws is None else draws[k])
        acc.append(ok)
    return (dataclasses.replace(state, a=a, cl_bins=clb),
            [bool(x) for x in acc])


def ptsrc_alpha_step(model, gcfg, sys, state, generator, u=None):
    """The sources' spectral indices (run.py:2337-2372; samplePtsrcSpecInd,
    comm_ptsrc_comp_mod.f90:1492-1971) where the catalog gives some alpha
    rms > 0: on the residual of the full model, a grid draw over [-4, 1]
    (64 points) with the catalog's alpha as the prior mean, or in optimize
    mode the Powell fit of (amplitude, alpha); only the free sources move.
    The stamps are remade at the new alphas (meta["ptsrc_alpha"] updated).
    u: optional (nsrc,) uniforms. Returns (model, state)."""
    meta, ps = model.meta, model.ps
    if ps is None or meta.get("ptsrc_unit") is None \
            or not np.any(np.asarray(meta["ptsrc_alpha_rms"]) > 0):
        return model, state
    dev, dt = sys.data.device, sys.data.dtype
    unit, nur = meta["ptsrc_unit"], meta["ptsrc_nuratio"]
    rms = np.asarray(meta["ptsrc_alpha_rms"], np.float64)
    free = rms > 0
    alphas = np.asarray(meta["ptsrc_alpha"], np.float64)
    res = sys.data - chisq.full_sky(sys, model.plan, state.a, model.ts, ps,
                                    state.t, state.p)
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    if gcfg.optimize:
        amps, new = joint.optimize_ptsrc(unit, nur, res, state.p, alphas,
                                         sys.inv_rms2)
        state = dataclasses.replace(state, p=torch.where(
            torch.as_tensor(free, device=dev), amps.to(dev, dt), state.p))
    else:
        grid = torch.linspace(-4.0, 1.0, 64, dtype=torch.float64,
                              device=dev)
        new = joint.sample_ptsrc_alpha(
            unit, nur, res, state.p, f64(alphas), sys.inv_rms2, grid,
            prior_mean=f64(alphas),
            prior_istd=f64(np.where(free, 1.0 / np.maximum(rms, 1e-30),
                                    1e30)),
            generator=generator, u=u)
    alphas = np.where(free, new.detach().to("cpu", torch.float64).numpy(),
                      alphas)
    meta["ptsrc_alpha"] = alphas
    ps = joint.restamp_ptsrc(unit, f64(nur), f64(alphas))
    ps = dataclasses.replace(ps, prior_mean=unit.prior_mean,
                             prior_istd=unit.prior_istd)
    return model._replace(ps=ps), state


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


def _simulate(cfg, model, ch, first, device, dtype, opts, timer):
    """The bands' TOD simulated from the noiseless sky (run.
    _setup_synthetic_tod, an LFI or a differential block by the band's TOD
    type; None for a band without TOD), with
    SAMPLE_TOD_MONOPOLE their monopoles at zero, and on resume each band's
    TOD state and monopoles restored from the chain's sample `first`
    (run.py:1703-1726). Returns (bands, whether a state was restored)."""
    sys, meta = model.sys, model.meta
    timer.start("tod_sim")
    sky0 = meta.get("sky_true")
    bands = tod_gibbs.simulate_bands(
        meta["nside"], sys.data if sky0 is None else sky0, sys.inv_rms,
        [b.nominal_freq_ghz * 1e9 for b in cfg.bands],
        nscan=cfg.synth_tod_nscan,
        ndet=cfg.synth_tod_ndet, ntod=cfg.synth_tod_ntod,
        sigma0_scale=cfg.synth_tod_sigma0_scale, fknee=cfg.synth_tod_fknee,
        seed=cfg.base_seed, sample_mono=bool(cfg.sample_tod_mono),
        dtype=dtype, device=device, tod=opts["tod_bands"],
        mono_guard=opts["mono_guard"],
        kinds=["diff" if is_differential(b) else "lfi" for b in cfg.bands])
    timer.stop("tod_sim")
    restored = False
    if first > 0:
        saved = ch.read_tod_state(first)
        for b, band in enumerate(bands):
            st = saved.get(cfg.bands[b].label)
            if band is None or not st or tuple(st["gain"].shape) != tuple(
                    band.state.gain.shape):
                continue
            t = lambda k: torch.as_tensor(st[k]).to(device, dtype)
            bands[b] = band._replace(state=TodState(
                gain=t("gain"), sigma0=t("sigma0"), alpha=t("alpha"),
                fknee=t("fknee"), n_corr=band.state.n_corr))
            if "mono" in st and band.mono is not None:
                bands[b] = bands[b]._replace(mono=t("mono"))
            restored = True
    return bands, restored


def _tod_start(gcfg, model, bands, restored: bool, state, sys_warm,
               generator, draws, status, timer):
    """The TOD warm start (run.py:1636-1643, :1734-1745; deferred,
    :2012-2021) of the simulated (and restored: _simulate) bands:
    tod_gibbs.tod_burnin on sys_warm (gibbs_step on the map-level data, then
    3 TOD passes on its full model sky, 1 after a restore, scan rejection
    off, the monopoles carried). run() orders the simulation after the
    amplitude step where it does not defer; the simulation draws from no
    generator, so the order changes nothing. Returns (bands, state, the warm
    start's {cg_iters, cg_relres, npasses})."""
    npasses = 1 if restored else 3
    timer.start("tod_burnin")
    d0 = draws(0, bands, npasses) if draws is not None else None
    bands, state = tod_gibbs.tod_burnin(gcfg, bands, sys_warm, model.plan,
                                        state, generator, npasses=npasses,
                                        draws=d0, ts=model.ts, ps=model.ps)
    timer.stop("tod_burnin")
    status.update(f"tod init: {sum(b is not None for b in bands)} bands "
                  f"({'chain-restored' if restored else 'burned in'})")
    return bands, state, dict(cg_iters=int(state.cg_iters),
                              cg_relres=float(state.cg_relres),
                              npasses=npasses)
