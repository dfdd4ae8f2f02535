"""The port's main path: build the Gibbs problem and take steps.

Twin of the JAX package's __graft_entry__._build_problem / entry(): the same
components (CMB, synchrotron power law, MBB dust), mixing, C_ell prior,
noise and data recipe, bins and GibbsConfig, step for step.

Presets:
  entry      nside 64 / lmax 128, 3 bands geomspace(30, 353) GHz,
             FWHM 600*30/f arcmin, CG tol 1e-6, maxiter 60.
  tutorial   the reference tutorial's LFI bands at nside 1024 / lmax 2000:
             30/44/70 GHz, FWHM 32.3/27.1/13.3 arcmin (param_tutorial_full
             .txt), temperature only, CG tol 1e-6, maxiter 100 (the
             tutorial's 1e-6 solve takes ~80-100 CG iterations).
  entry_pol  the entry problem with T/Q/U maps and T/E/B amplitudes (S = 3).
  tutorial_pol  the tutorial polarized, as param_tutorial_full.txt has it:
             all three bands and cmb, synch and dust carry polarization; the
             CMB's C_ell is binned and resampled, synch and dust sit on the
             tutorial's own fixed `gauss` priors (tutorial_fg_priors(), read
             from the file), because
             resampling every component's bins lets the C_ell of modes the
             data do not constrain random-walk and the CG conditioning with
             them. Diagonal noise, synthetic data from the seed.
Polarized problems zero the E and B priors below ell = 2 (ell_mask).

Presets of the whole Gibbs iteration (sampling/full_gibbs.full_gibbs_step):
their data are a simulated sky in place of white noise. True amplitudes are
drawn on the host from numpy's default_rng([seed, 1]), scaled by sqrt(C_ell),
projected with F(theta_true) and the beams, synthesized once on the device
and given numpy noise; the chain starts from the components' theta0, off the
truth. build_full_problem makes them and returns a FullProblem.
  entry_full     the entry_pol problem with index slots for synch beta, dust
                 beta and dust T_d.
  tutorial_full  tutorial_pol with the same three slots.
  fullgibbs      temperature only at nside 1024 / lmax 2000: 5 components
                 (cmb, synch, MBB dust, free-free T_e 7000 K, spinning dust
                 nu_p 21 GHz), 6 delta bands 30/44/70/100/217/353 GHz, FWHM
                 30' down to 6', rms 0.5-3.0 per pixel, 5 slots.
All three evaluate the index likelihood through each band's beam
(beam_consistent): their beams differ.

Presets of the Gibbs iteration from time-ordered data
(sampling/tod_gibbs.tod_gibbs_step): a full preset whose bands carry
simulated TOD (tod_gibbs.simulate_bands) of the noiseless band sky at
theta_true: unit gain, sigma0 = 1.3 x the band's map rms, 1/f noise with
f_knee 0.03 Hz and alpha -1.5, fsamp 10 Hz (param_tutorial_full.txt:31-41).
Each TOD pass replaces the bands' maps and noise by the binned maps and rms.
  entry_tod      entry_full with 16 scans x 4 detectors x 8192 samples per
                 band: the check against the CPU float64 step.
  tutorial_tod   tutorial_full with the TOD of param_tutorial_full.txt: 96
                 scans x 4 detectors x 131072 samples per band (5.03e7; 1.51e8
                 for the three LFI bands), CG tol 1e-6 and maxiter 400. Cuts
                 against that file: 3 of its 8 components (cmb, synch, dust;
                 the point sources, monopole/dipole, free-free, AME and
                 relquad components are tutorial_joint's), bands at the
                 component nside / lmax with Gaussian beams and delta
                 bandpasses at 30/44/70 GHz, and TOD simulated in place of the
                 LFI archives (not in the repository).

Presets of the whole 8-component model from TOD (the joint amplitude system
of sampling/joint.py; tod_gibbs_step with ts / ps): a TOD preset with
param_tutorial_full.txt's other five components, as run.build_model(cfg,
synthetic=True) makes them (run.py:394-577):
  - ff (free-free, T_e) and ame (spinning dust, nu_p) as diffuse
    components, T only as the file has them: their F row is repeated over
    Stokes (run.py:862) and their E / B prior amplitudes default to 1.0
    (run.py:254-260), on the file's fixed power_law_gauss / power_law C_ell;
  - the index slots make_index_slots(comps, pcfgs) gives from the file's
    ranges and Gaussian priors (tutorial_indices()): beta_s, beta_d, T_d,
    T_e, nu_p;
  - md: 4 rows per band ([1, x, y, z] on its T plane), prior 0 +- 100;
  - relquad: one row, the relquad template of each band on its T plane,
    pinned at 1 (prior rms 0 is inverse std 1e6, run.py:497);
  - radio: 20 sources at random pixels (no catalog in the file), SED
    (nu / 30 GHz)^-2.5, Gaussian stamps of FWHM max(beam, 60') on min(32,
    npix / 4) pixels, amplitudes 50 + 50 |N(0, 1)| (run.py:558-577).
The simulated sky carries the sources at those amplitudes and the relquad
template at its pinned amplitude 1, md at 0. (run.py injects the sources
only, so its model pins a relquad signal its data lack: a declared cut,
beside delta bandpasses, Gaussian beams and simulated TOD.)
  entry_joint     entry_tod with these rows, at nside 64: the check against
                  the CPU float64 step.
  tutorial_joint  tutorial_tod with these rows: nside 1024 / lmax 2000, the
                  file's TOD, CG tol 1e-6, maxiter 400.

Presets of the multi-resolution chain (commander_tpu.run.run_multires, the
--multires run; sampling/multires_gibbs.multires_gibbs_step): every band
keeps its own (nside, lmax), the bands of one resolution form a group with
its own plan, and one CG operator runs every group's transforms.
build_multi_problem makes them as run.build_multi_model(cfg,
synthetic=True) does and returns a MultiProblem.
  tutorial_multires  param_tutorial_full.txt's bands, components and CG
                  settings, run with --multires --pol: 30 and 44 GHz at
                  nside 512 / lmax 1000 and 70 GHz at nside 1024 / lmax 2000
                  (BeyondPlanck's LFI resolutions, at the tutorial's lmax :
                  nside ratio), T/Q/U, the file's five diffuse components
                  (cmb, synch, dust, ff, ame; build_multi_model drops md
                  and has no template or source rows), five index
                  parameters with the file's ranges and Gaussian priors, CG
                  tol 1e-6 and maxiter 400, no gain sampling (the file sets
                  none). Cuts: delta bandpasses, Gaussian beams times the
                  pixel window, white full-sky noise of rms 10, a synthetic
                  sky drawn from 100 / (l (l + 1)) at the start values, and
                  no TOD (run_multires' TOD branch is not ported).
  entry_multires  the same at 30/44 GHz nside 32 / lmax 64 and 70 GHz
                  nside 64 / lmax 128, with every band sampling its gain:
                  the check against the CPU float64 step.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from .driver.model import (band_bandpasses, comp_ell_mask, comp_to_diffuse,
                           white_alm)
from .instrument.bandpass import delta_bandpass
from .instrument.beam import gaussian_bl, pixel_window
from .io.params import Params, lower_params
from .model.cl import ClModelConfig, bin_index_table, fixed_cl_from_config
from .model.mixing import DiffuseComponent, mixing_matrix
from .model.relquad import relquad_template
from .sampling import amplitude as amp
from .sampling import gibbs, joint, multires
from .sampling.chisq import sky_signal
from .sampling.full_gibbs import make_index_slots, system_at, theta_tuple
from .sampling.tod_gibbs import simulate_bands
from .sphere import healpix, sht
from .sphere.alm import triangle_mask
from .utils.device import resolve_device

GHZ = 1e9

PRESETS = {
    "entry": dict(nside=64, lmax=128, nband=3, cg_tol=1e-6, cg_maxiter=60),
    "tutorial": dict(nside=1024, lmax=2000, nband=3,
                     freqs_ghz=(30.0, 44.0, 70.0),
                     fwhm_arcmin=(32.3, 27.1, 13.3),
                     cg_tol=1e-6, cg_maxiter=100),
}
PRESETS["entry_pol"] = dict(PRESETS["entry"], pol=True)
PRESETS["tutorial_pol"] = dict(PRESETS["tutorial"], pol=True, fg_priors=True)

# truth off the start values (components().theta0), one entry per slot
PRESETS["entry_full"] = dict(PRESETS["entry_pol"],
                             theta_true=(-2.8, 1.5, 21.0))
PRESETS["tutorial_full"] = dict(PRESETS["tutorial_pol"],
                                theta_true=(-2.8, 1.5, 21.0))
# TOD of param_tutorial_full.txt:31-41 (sigma0 scale, f_knee; the
# simulator's alpha and fsamp)
TOD_NOISE = dict(sigma0_scale=1.3, fknee=0.03, alpha=-1.5, fsamp=10.0)
PRESETS["entry_tod"] = dict(PRESETS["entry_full"], tod=dict(
    TOD_NOISE, nscan=16, ndet=4, ntod=8192))
PRESETS["tutorial_tod"] = dict(PRESETS["tutorial_full"], cg_maxiter=400,
                               tod=dict(TOD_NOISE, nscan=96, ndet=4,
                                        ntod=131072))
# the whole model of param_tutorial_full.txt: truth off the start values
# for all five slots
JOINT_THETA_TRUE = (-2.8, 1.5, 21.0, 8000.0, 23e9)
# (the five diffuse components are fullgibbs's)
PRESETS["entry_joint"] = dict(PRESETS["entry_tod"], model="fullgibbs",
                              fg_priors=True, joint=True,
                              theta_true=JOINT_THETA_TRUE)
PRESETS["tutorial_joint"] = dict(PRESETS["tutorial_tod"], model="fullgibbs",
                                 joint=True, theta_true=JOINT_THETA_TRUE)
PRESETS["fullgibbs"] = dict(
    nside=1024, lmax=2000, nband=6, model="fullgibbs",
    freqs_ghz=(30.0, 44.0, 70.0, 100.0, 217.0, 353.0),
    fwhm_arcmin=tuple(np.linspace(30.0, 6.0, 6)), cg_tol=1e-7, cg_maxiter=60,
    cl_ell2=300.0, rms=(0.5, 3.0), nbin=12,
    theta_true=(-3.0, 1.5, 21.0, 8000.0, 23e9))

# the reference tutorial's parameter file, beside the package
TUTORIAL_PARAMS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "param_tutorial_full.txt")


def tutorial_config(*overrides):
    """param_tutorial_full.txt lowered by io.params, with "--KEY=value"
    overrides."""
    return lower_params(Params.load(TUTORIAL_PARAMS, overrides))


def tutorial_fg_priors() -> dict:
    """The tutorial's fixed foreground priors by component, from the file's
    COMP_CL_* keys: {name: {kind, amp (T, E, B) D_l amplitudes, beta (T, E,
    B), lpivot}} (E / B default to amplitude 1, beta 0 where the file sets
    only T, as io.params lowers them)."""
    return {c.label: dict(kind=str(c.cl_type), amp=tuple(c.cl_amp_def),
                          beta=tuple(c.cl_beta_def), lpivot=c.cl_lpivot)
            for c in tutorial_config().comps
            if c.cclass == "diffuse" and c.ctype != "cmb"
            and c.ctype not in ("md", "cmb_relquad", "template")}


def tutorial_indices() -> dict:
    """The file's index ranges (COMP_PRIOR_UNI_*) and Gaussian priors
    (COMP_PRIOR_GAUSS_*) by component: {name: {param: {low, high,
    prior_mean, prior_rms, ...}}}, nu_p in GHz as the file gives it."""
    return {c.label: c.indices for c in tutorial_config().comps
            if c.indices}


class IndexPriors(NamedTuple):
    """A component's index configs in the form make_index_slots reads."""
    indices: dict


def components(model: str = "entry"):
    comps = [
        DiffuseComponent("cmb", "cmb", 100 * GHZ, unit="uK_cmb"),
        DiffuseComponent("synch", "power_law", 30 * GHZ, theta0=(-3.1,)),
        DiffuseComponent("dust", "MBB", 353 * GHZ, theta0=(1.6, 19.6)),
    ]
    if model == "fullgibbs":
        comps += [
            DiffuseComponent("ff", "freefree", 40 * GHZ, theta0=(7000.0,)),
            DiffuseComponent("ame", "spindust", 22 * GHZ, theta0=(21e9,)),
        ]
    return comps


class FullProblem(NamedTuple):
    """What full_gibbs_step needs, and the truth its data were made from."""
    plan: sht.SHTPlan
    sys: amp.AmplitudeSystem
    cfg: gibbs.GibbsConfig
    comps: list
    bps: list
    slots: tuple
    thetas0: torch.Tensor      # (nslot,) float64 start values, on the device
    theta_true: tuple          # (nslot,) floats
    a_true: torch.Tensor       # (C, S, nl, nm) true amplitudes
    beam_consistent: bool
    # TOD presets: one tod_gibbs.TodBand per band, the noiseless band sky
    # (B, S, P) they were simulated from, and the simulator's host seconds
    bands: list | None = None
    sky_true: torch.Tensor | None = None
    sim_seconds: float | None = None
    # joint presets: the template and source rows (joint.TemplateSet,
    # PtsrcSet) and the amplitudes the sky was made with
    ts: object = None
    ps: object = None
    t_true: torch.Tensor | None = None
    p_true: torch.Tensor | None = None


def _bands(nband, freqs_ghz, fwhm_arcmin):
    """(delta bandpasses, FWHM in arcmin) of a preset's bands."""
    freqs = np.geomspace(30, 353, nband) if freqs_ghz is None \
        else np.asarray(freqs_ghz, np.float64)
    fwhm = 600.0 * 30 / freqs if fwhm_arcmin is None \
        else np.asarray(fwhm_arcmin, np.float64)
    return [delta_bandpass(f * GHZ) for f in freqs], fwhm


def build_problem(nside, lmax, nband=3, freqs_ghz=None, fwhm_arcmin=None,
                  dtype=torch.float32, device=None, seed=0,
                  cg_tol=1e-6, cg_maxiter=60, pol=False, fg_priors=False,
                  model="entry", cl_ell2=None, rms=20.0, nbin=8,
                  cg_precond="diagonal", cg_lmax_precond=-1):
    """(plan, sys, cfg, comps) for the amplitude + C_ell problem, with the
    system and plan on `device` (None: the CUDA card).
    pol: T/Q/U maps (S = 3) in place of T alone. fg_priors: every
    foreground on its fixed prior (tutorial_fg_priors()), only the CMB's bins
    resampled.
    model: the component set (components()). cl_ell2: prior spectrum
    cl_ell2 / (l (l + 1)) from l = 2 in place of 1e4 / (1 + l (l + 1)).
    rms: the noise rms per pixel, or its (low, high) range, drawn uniformly.
    nbin: C_ell bins above l = 4. cg_precond, cg_lmax_precond: the CG's
    preconditioner
    (GibbsConfig; every preset keeps the diagonal one, as
    param_tutorial_full.txt does). Data are white noise made on the host
    from numpy's default_rng(seed), as the reference makes them."""
    device = resolve_device(device)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    S = 3 if pol else 1
    plan = sht.get_plan(nside, lmax, spin2=pol, dtype=dtype, device=device)
    comps = components(model)
    bps, fwhm = _bands(nband, freqs_ghz, fwhm_arcmin)
    F = mixing_matrix(comps, bps, device="cpu").numpy().astype(npdt)
    nl = lmax + 1
    npix = 12 * nside * nside
    bl = np.stack([gaussian_bl(fw, lmax) for fw in fwhm]).astype(npdt)
    bl = bl[:, None, :].repeat(S, 1)
    ell = np.arange(nl)
    if cl_ell2 is None:
        cl = np.broadcast_to(1e4 / (1.0 + ell * (ell + 1.0)),
                             (len(comps), S, nl)).astype(npdt)
    else:
        cl = np.zeros((len(comps), S, nl), npdt)
        cl[:, :, 2:] = cl_ell2 / (ell[2:] * (ell[2:] + 1.0))
    bins = tuple(int(b) for b in np.unique(np.concatenate(
        [[0, 2], np.geomspace(4, max(lmax, 5), nbin).astype(int)])))
    cl_cfg = ClModelConfig(kind="binned", lmax=lmax, nmaps=S, bin_starts=bins)
    cl_cfgs = ()
    if fg_priors:
        cl_cfgs = [cl_cfg]
        priors = tutorial_fg_priors()
        for c, comp in enumerate(comps[1:], start=1):
            pr = priors[comp.name]
            cl[c] = fixed_cl_from_config(pr["kind"], pr["amp"][:S],
                                         pr["beta"][:S], pr["lpivot"], lmax,
                                         S)
            cl_cfgs.append(ClModelConfig(kind=pr["kind"], lmax=lmax, nmaps=S,
                                         ell_pivot=pr["lpivot"]))
        cl_cfgs = tuple(cl_cfgs)
    ell_mask = None
    if pol:
        ell_mask = np.ones((len(comps), S, nl), npdt)
        ell_mask[:, 1:, :2] = 0.0
    rng = np.random.default_rng(seed)
    if np.ndim(rms) == 0:
        rms = np.full((nband, S, npix), rms, npdt)
    else:
        rms = (rms[0] + (rms[1] - rms[0]) * rng.random((nband, S, npix))
               ).astype(npdt)
    data = rng.standard_normal((nband, S, npix)).astype(npdt) * 50.0
    t = lambda a: torch.as_tensor(a, device=device)
    sys = amp.build_system(t(F), t(bl), t(rms), t(cl), t(data),
                           ell_mask=None if ell_mask is None
                           else t(ell_mask))
    cfg = gibbs.GibbsConfig(cl_cfg=cl_cfg, cg_tol=cg_tol,
                            cg_maxiter=cg_maxiter, cl_cfgs=cl_cfgs,
                            cg_precond=cg_precond,
                            cg_lmax_precond=cg_lmax_precond)
    return plan, sys, cfg, comps


def _simulated_sky(plan, sys, F_true, rng):
    """(data (B, S, P), a_true (C, S, nl, nm)) on the system's device: white
    alms from rng scaled by the square root of the system's prior spectrum,
    projected with F_true (B, C) and the beams, synthesized on the device,
    plus numpy noise of the system's rms."""
    dev, dt = sys.data.device, sys.data.dtype
    cl = sys.cl.cpu().numpy().astype(np.float64)
    C, S, nl = cl.shape
    shape = (C, S, nl, nl)
    a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
        * np.sqrt(0.5)
    a[..., 0] = rng.standard_normal(shape[:-1])
    a = a * np.tril(np.ones((nl, nl))) * np.sqrt(cl)[..., None]
    cdt = np.complex64 if dt == torch.float32 else np.complex128
    alm_b = (np.einsum("bc,cslm->bslm", F_true, a)
             * sys.bl.cpu().numpy()[..., None]).astype(cdt)
    sky = amp._synth(plan, torch.as_tensor(alm_b, device=dev))
    noise = torch.as_tensor(rng.standard_normal(tuple(sky.shape)).astype(
        np.float32 if dt == torch.float32 else np.float64), device=dev)
    rms = torch.where(sys.inv_rms > 0, 1.0 / sys.inv_rms.clamp(min=1e-300),
                      torch.zeros_like(sys.inv_rms))
    return sky + noise * rms, torch.as_tensor(a.astype(cdt), device=dev)


def joint_rows(nside: int, bps, fwhm_arcmin, nmaps: int, dtype, device,
               seed: int = 0):
    """(ts, ps, t_true, p_true): param_tutorial_full.txt's md, relquad and
    radio rows as the joint presets have them (module docstring), the
    sources drawn from default_rng([seed, 2]), on `device` in `dtype`."""
    npix = 12 * nside * nside
    B = len(bps)
    vec = healpix.pix2vec_ring(nside)
    base = np.concatenate([np.ones((1, npix)), vec.T], axis=0)
    quad = [relquad_template(nside, bp.nu_c) for bp in bps]
    planes = np.concatenate([base] * B + [np.stack(quad)], axis=0)
    rows = np.concatenate([np.arange(4 * B), np.full(B, 4 * B)])
    slots = np.concatenate([np.repeat(np.arange(B), 4), np.arange(B)]) \
        * nmaps
    ts = joint.make_template_set(
        planes, rows, slots, 4 * B + 1, B, nmaps,
        prior_mean=np.r_[np.zeros(4 * B), 1.0],
        prior_istd=np.r_[np.full(4 * B, 1.0 / 100.0), 1e6], dtype=dtype,
        device=device)
    rng = np.random.default_rng([seed, 2])
    nsrc = 20
    src_pix = rng.choice(npix, size=nsrc, replace=False)
    F_src = np.stack([(bp.nu_c / (30 * GHZ)) ** -2.5 * np.ones(nsrc)
                      for bp in bps])
    ps = joint.gaussian_stamp_ptsrc(
        nside, src_pix, F_src, np.maximum(np.asarray(fwhm_arcmin), 60.0),
        nmaps=nmaps, npatch=min(32, npix // 4), dtype=dtype, device=device)
    p_true = np.abs(rng.standard_normal(nsrc)) * 50.0 + 50.0
    t_true = np.r_[np.zeros(4 * B), 1.0]
    t = lambda a: torch.as_tensor(a, device=device).to(dtype)
    return ts, ps, t(t_true), t(p_true)


def build_full_problem(theta_true, dtype=torch.float32, device=None, seed=0,
                       tod=None, joint_model=False, **kw) -> FullProblem:
    """The problem of the whole Gibbs iteration: build_problem(**kw) with
    one index slot per free spectral parameter and, for data, a sky
    simulated at theta_true (one value per slot) from
    default_rng([seed, 1]); the chain starts from the components' theta0.
    tod: the keywords of tod_gibbs.simulate_bands (nscan, ndet, ntod, ...)
    to give every band TOD of the noiseless band sky, from seed + b.
    joint_model: add the md, relquad and radio rows (joint_rows) and their
    signal, and take the index slots' ranges and priors from
    the tutorial file (tutorial_indices())."""
    plan, sys, cfg, comps = build_problem(dtype=dtype, device=device,
                                          seed=seed, **kw)
    bps, fwhm = _bands(kw.get("nband", 3), kw.get("freqs_ghz"),
                       kw.get("fwhm_arcmin"))
    if joint_model:
        ind = tutorial_indices()
        pcfgs = [IndexPriors(ind.get(c.name, {})) for c in comps]
    else:
        pcfgs = None
    slots = make_index_slots(comps, pcfgs)
    F_true = mixing_matrix(comps, bps, device="cpu", thetas=theta_tuple(
        comps, slots, theta_true)).numpy()
    data, a_true = _simulated_sky(plan, sys, F_true,
                                  np.random.default_rng([seed, 1]))
    extra = None
    rows = dict(ts=None, ps=None, t_true=None, p_true=None)
    if joint_model:
        ts, ps, t_true, p_true = joint_rows(
            plan.nside, bps, fwhm, sys.data.shape[1], sys.data.dtype,
            sys.data.device, seed)
        rows = dict(ts=ts, ps=ps, t_true=t_true, p_true=p_true)
        extra = joint.extra_sky(ts, ps, t_true, p_true, data.shape[-1])
        data = data + extra
    thetas0 = torch.tensor([comps[s.ci].theta0[s.which] for s in slots],
                           dtype=torch.float64).to(sys.data.device)
    pb = FullProblem(plan, dataclasses.replace(sys, data=data), cfg, comps,
                     bps, slots, thetas0, tuple(float(x) for x in theta_true),
                     a_true, beam_consistent=True, **rows)
    if tod is None:
        return pb
    sys_true = system_at(sys, comps, bps, slots, torch.tensor(
        theta_true, dtype=torch.float64, device=sys.data.device))
    sky_true = sky_signal(sys_true, plan, a_true)
    if extra is not None:
        sky_true = sky_true + extra
    t0 = time.perf_counter()
    bands = simulate_bands(plan.nside, sky_true, sys.inv_rms,
                           [bp.nu_c for bp in bps], seed=seed, dtype=dtype,
                           device=sys.data.device, **tod)
    return pb._replace(bands=bands, sky_true=sky_true,
                       sim_seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# The multi-resolution chain (run.build_multi_model, run.run_multires)
# ---------------------------------------------------------------------------

class MultiProblem(NamedTuple):
    """What multires_gibbs_step needs (run.build_multi_model's ms, plans,
    diffuse, cl_cfg and meta), and the truth of its synthetic sky."""
    ms: multires.MultiSystem   # groups with F at thetas0, cl = cl0
    plans: list                # one SHT plan per group
    diffuse: list              # DiffuseComponent per component
    bps: list                  # Bandpass per band
    cl_cfg: ClModelConfig      # binned, at the component lmax
    slots: tuple               # IndexSlot per free parameter
    thetas0: torch.Tensor      # (nslot,) float64 start values (the truth)
    ell_mask: torch.Tensor     # (C, S, nl) COMP_LMAX_AMP / LMIN_AMP window
    band_slot: dict            # band -> (group, row in the group)
    groups: list               # (nside, lmax) per group
    a_true: torch.Tensor | None  # (C, S, nl, nm) the sky's amplitudes
    #                               (None on FITS maps)
    cfg: object                # the lowered config (io.params.RunConfig)


def build_multi_problem(cfg, seed: int = 0, dtype=torch.float64,
                        device=None, max_nside=None, pol: bool = False,
                        a_true=None, data_dir=None,
                        synthetic: bool = True) -> MultiProblem:
    """The multi-resolution problem of run.build_multi_model(cfg,
    synthetic), on `device` (None: the CUDA card) in `dtype`.

    Bands are grouped by (nside, lmax) with lmax = min(band lmax, 3 nside -
    1) and nside capped at max_nside; the components sit at the largest
    group lmax. Per group: b_l = Gaussian (FWHM, 60' where unset) x the
    HEALPix pixel window, rms 10 on a full-sky mask, F at the components'
    theta0. The prior is cl0 = 100 / (l (l + 1)) (1 at l <= 1) times the
    COMP_LMAX_AMP window; the sky's amplitudes a_true = sqrt(cl0) x a white
    draw, from numpy's default_rng([seed, 1]) unless given (the tests pass
    JAX build_multi_model's draw); per group in order, data = its sky + rms x
    default_rng(seed).standard_normal, as build_multi_model draws it. C_l bins
    geometric from 4 to lmax (run.py:2683-2685). pol: T/Q/U where every band
    is polarized.

    synthetic=False reads each band's BAND_MAPFILE, BAND_NOISEFILE and
    BAND_MASKFILE (io/fits.py, under data_dir; none and fullsky skipped, a
    missing file raises FileNotFoundError with the resolved path), their
    first S rows brought to the group's nside by udgrade_indices (a mean
    over the children, or the parent's value), the mask kept above 0.5
    (run.py:2642-2666); there is no a_true."""
    from .io.fits import read_map

    device = resolve_device(device)
    diffuse = [comp_to_diffuse(c) for c in cfg.comps
               if c.cclass == "diffuse"
               and c.ctype not in ("md", "cmb_relquad", "template")]
    bands = list(cfg.bands)
    pol = pol and all(b.polarized for b in bands)
    S = 3 if pol else 1
    res_of = []
    for b in bands:
        ns = min(b.nside, max_nside) if max_nside else b.nside
        res_of.append((ns, min(b.lmax, 3 * ns - 1)))
    group_keys = sorted(set(res_of))
    lmax_c = max(lm for _, lm in group_keys)
    nl_c = lmax_c + 1
    C = len(diffuse)
    bps = band_bandpasses(cfg, data_dir)
    F_all = mixing_matrix(diffuse, bps, device="cpu").numpy()
    ell = np.arange(nl_c, dtype=np.float64)
    ell_mask = comp_ell_mask(cfg.comps, [d.name for d in diffuse], nl_c, S)
    cl0 = np.broadcast_to(100.0 / np.maximum(ell * (ell + 1.0), 1.0),
                          (C, S, nl_c)) * ell_mask
    if a_true is None and synthetic:
        a_true = white_alm(np.random.default_rng([seed, 1]),
                            (C, S, nl_c, nl_c)) \
            * np.sqrt(cl0)[..., None] * triangle_mask(nl_c, nl_c)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    if synthetic:
        a_true = torch.as_tensor(np.array(a_true), device=device).to(cdt)
    else:
        a_true = None
    t = lambda x: torch.as_tensor(np.asarray(x), device=device).to(dtype)

    rng = np.random.default_rng(seed)
    groups, plans, band_slot = [], [], {}
    for g, (ns, lm) in enumerate(group_keys):
        idxs = [i for i, r in enumerate(res_of) if r == (ns, lm)]
        for j, i in enumerate(idxs):
            band_slot[i] = (g, j)
        plan_g = sht.get_plan(ns, lm, spin2=pol, dtype=dtype, device=device)
        npix_g, nl_g = 12 * ns * ns, lm + 1
        pw = pixel_window(ns, lm)
        bl_g = np.stack([gaussian_bl(bands[i].beam_fwhm_arcmin or 60.0, lm)
                         * pw for i in idxs])[:, None, :].repeat(S, 1)
        rms_g = np.full((len(idxs), S, npix_g), 10.0)
        mask_g = np.ones((len(idxs), S, npix_g))
        data_g = np.zeros((len(idxs), S, npix_g))
        if not synthetic:
            for j, i in enumerate(idxs):
                for attr, dest in (("mapfile", data_g), ("noisefile", rms_g),
                                   ("maskfile", mask_g)):
                    m = _band_file(bands[i], attr, data_dir, S, ns, read_map)
                    if m is not None:
                        dest[j, :m.shape[0]] = (m > 0.5) \
                            if attr == "maskfile" else m
        sys_g = amp.build_system(
            t(F_all[idxs]), t(bl_g), t(rms_g), t(cl0[..., :nl_g]),
            t(data_g), mask=t(mask_g))
        if synthetic:
            sky = amp._synth(plan_g, amp._project_bands(
                sys_g, plan_g, a_true[..., :nl_g, :nl_g]))
            noise = rms_g * rng.standard_normal(tuple(sky.shape))
            sys_g = dataclasses.replace(sys_g, data=sky + t(noise))
        groups.append(sys_g)
        plans.append(plan_g)
    bins = tuple(int(x) for x in np.unique(np.concatenate(
        [[0, 2], np.geomspace(4, max(lmax_c, 5), 10).astype(int)])))
    # run.py:2846-2869's grids and priors (run_multires takes the chisq lnL
    # whatever the file says; no file in the repo sets another)
    pcfgs = {c.label: c for c in cfg.comps}
    slots = make_index_slots(diffuse, [IndexPriors(
        pcfgs[d.name].indices if d.name in pcfgs else {}) for d in diffuse])
    thetas0 = torch.tensor([diffuse[s.ci].theta0[s.which] for s in slots],
                           dtype=torch.float64, device=device)
    return MultiProblem(
        ms=multires.build_multi_system(groups, t(cl0)), plans=plans,
        diffuse=diffuse, bps=bps,
        cl_cfg=ClModelConfig(kind="binned", lmax=lmax_c, nmaps=S,
                             bin_starts=bins),
        slots=slots, thetas0=thetas0, ell_mask=t(ell_mask),
        band_slot=band_slot, groups=group_keys, a_true=a_true, cfg=cfg)


def _band_file(band, attr: str, data_dir, S: int, nside: int, read_map):
    """A band's map, noise or mask file (attr) as its first S rows at
    `nside` (run.py:2649-2661), or None where the band names none."""
    fn = getattr(band, attr, None)
    if not fn or str(fn).lower() in ("none", "fullsky"):
        return None
    path = os.path.join(data_dir or ".", fn)
    if not os.path.exists(path):
        raise FileNotFoundError(f"band {band.label}: {attr} {fn!r} not "
                                f"found (resolved {path!r})")
    m = read_map(path)[:S]
    mns = int(np.sqrt(m.shape[1] / 12))
    if mns != nside:
        tab = healpix.udgrade_indices(mns, nside)
        m = m[:, tab].mean(-1) if tab.ndim == 2 else m[:, tab]
    return m


def multires_config(nsides=(512, 512, 1024), lmaxs=(1000, 1000, 2000),
                    sample_gain: bool = False):
    """param_tutorial_full.txt lowered with each band at its own (nside,
    lmax) and sample_gain on every band or none: its three LFI bands, its
    eight components (build_multi_problem keeps the five diffuse ones), its
    index defaults, ranges and priors, CG tol and maxiter. (Its TOD type is
    ignored by the multires loop without TOD.)"""
    over = []
    for i, (ns, lm) in enumerate(zip(nsides, lmaxs), start=1):
        over += [f"--BAND_NSIDE{i:03d}={ns}", f"--BAND_LMAX{i:03d}={lm}"]
        if sample_gain:
            over.append(f"--BAND_SAMP_GAIN{i:03d}=.true.")
    return tutorial_config(*over)


PRESETS["tutorial_multires"] = dict(multires=True, nsides=(512, 512, 1024),
                                    lmaxs=(1000, 1000, 2000))
PRESETS["entry_multires"] = dict(multires=True, nsides=(32, 32, 64),
                                 lmaxs=(64, 64, 128), sample_gain=True)


def build_preset(name: str, dtype=torch.float32, device=None, seed=0,
                 **overrides):
    """build_problem at a named preset, build_full_problem where the preset
    names a truth (theta_true), or build_multi_problem for the multires
    presets (multires_config's keywords: nsides, lmaxs, sample_gain);
    overrides replace preset fields (a smaller nside
    for a CPU rehearsal, say) or set the CG's preconditioner
    (cg_precond="pseudoinv", cg_lmax_precond=16)."""
    kw = dict(PRESETS[name])
    kw.update(overrides)
    if kw.pop("multires", False):
        return build_multi_problem(multires_config(**kw), seed=seed,
                                   dtype=dtype, device=device, pol=True)
    if "theta_true" not in kw:
        return build_problem(dtype=dtype, device=device, seed=seed, **kw)
    return build_full_problem(dtype=dtype, device=device, seed=seed,
                              joint_model=kw.pop("joint", False), **kw)


def initial_state(cfg: gibbs.GibbsConfig, sys: amp.AmplitudeSystem,
                  cl0: float = 100.0, ts=None, ps=None) -> gibbs.GibbsState:
    """The reference entry()'s starting state: zero amplitudes (those of the
    template and source rows ts, ps too), all binned C_b at cl0."""
    return gibbs.init_state(
        sys.F.shape[1], sys.F.shape[2], cfg.cl_cfg.lmax,
        len(cfg.cl_cfg.bin_starts), cl0=cl0, dtype=sys.data.dtype,
        device=sys.data.device, ntemp=0 if ts is None else ts.ntemp,
        nsrc=0 if ps is None else ps.pix.shape[0])


def prior_state(cfg: gibbs.GibbsConfig, sys: amp.AmplitudeSystem, ts=None,
                ps=None) -> gibbs.GibbsState:
    """The starting state of commander_tpu.run (run.py:1456-1473): zero amplitudes,
    and each component's binned C_b the mean of its prior spectrum sys.cl
    over the bin (a component on a fixed prior keeps a slot it never
    reads), and zero template and source amplitudes where ts, ps are
    given. The iteration from TOD starts here: a flat C_b far above the
    prior at high l lets the warm start's amplitude draw carry the map
    noise of the narrow-beam bands into the model sky the TOD pass fits."""
    st = initial_state(cfg, sys, ts=ts, ps=ps)
    cl = sys.cl.to(torch.float64).cpu().numpy()
    binned = np.zeros(tuple(st.cl_bins.shape))
    for c in range(cl.shape[0]):
        cc = cfg.cl_cfgs[c] if cfg.cl_cfgs else cfg.cl_cfg
        if cc.kind != "binned":
            cc = cfg.cl_cfg
        idx = bin_index_table(cc)
        nb = len(cc.bin_starts)
        count = np.maximum(np.bincount(idx, minlength=nb), 1)
        for s_ in range(cl.shape[1]):
            binned[c, s_, :nb] = np.bincount(idx, weights=cl[c, s_],
                                             minlength=nb) / count
    return dataclasses.replace(st, cl_bins=torch.as_tensor(
        binned, dtype=st.cl_bins.dtype, device=st.cl_bins.device))
