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
             tutorial's own fixed `gauss` priors (FG_PRIORS below), because
             resampling every component's bins lets the C_ell of modes the
             data do not constrain random-walk and the CG conditioning with
             them. Diagonal noise, synthetic data from the seed.
Polarized problems zero the E and B priors below ell = 2 (ell_mask).
"""
from __future__ import annotations

import numpy as np
import torch

from .instrument.bandpass import delta_bandpass
from .instrument.beam import gaussian_bl
from .model.cl import ClModelConfig, fixed_cl_from_config
from .model.mixing import DiffuseComponent, mixing_matrix
from .sampling import amplitude as amp
from .sampling import gibbs
from .sphere import sht
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

# the tutorial's fixed foreground priors (COMP_CL_TYPE = gauss): per-Stokes
# D_l amplitude, Gaussian FWHM in arcmin, pivot
FG_PRIORS = {
    "synch": dict(kind="gauss", amp=(1e3, 200.0, 100.0),
                  beta=(60.0, 30.0, 30.0), lpivot=50),
    "dust": dict(kind="gauss", amp=(1e7, 500.0, 500.0),
                 beta=(60.0, 30.0, 30.0), lpivot=50),
}


def components():
    return [
        DiffuseComponent("cmb", "cmb", 100 * GHZ, unit="uK_cmb"),
        DiffuseComponent("synch", "power_law", 30 * GHZ, theta0=(-3.1,)),
        DiffuseComponent("dust", "MBB", 353 * GHZ, theta0=(1.6, 19.6)),
    ]


def build_problem(nside, lmax, nband=3, freqs_ghz=None, fwhm_arcmin=None,
                  dtype=torch.float32, device=None, seed=0,
                  cg_tol=1e-6, cg_maxiter=60, pol=False, fg_priors=False):
    """(plan, sys, cfg, comps) for the 3-component amplitude + C_ell
    problem, with the system and plan on `device` (None: the CUDA card).
    pol: T/Q/U maps (S = 3) in place of T alone. fg_priors: synch and dust
    on the fixed FG_PRIORS, only the CMB's bins resampled. Data are made on
    the host from numpy's default_rng(seed), as the reference makes them."""
    device = resolve_device(device)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    S = 3 if pol else 1
    plan = sht.get_plan(nside, lmax, spin2=pol, dtype=dtype, device=device)
    comps = components()
    freqs = np.geomspace(30, 353, nband) if freqs_ghz is None \
        else np.asarray(freqs_ghz, np.float64)
    fwhm = 600.0 * 30 / freqs if fwhm_arcmin is None \
        else np.asarray(fwhm_arcmin, np.float64)
    bps = [delta_bandpass(f * GHZ) for f in freqs]
    F = mixing_matrix(comps, bps).astype(npdt)
    nl = lmax + 1
    npix = 12 * nside * nside
    bl = np.stack([gaussian_bl(fw, lmax) for fw in fwhm]).astype(npdt)
    bl = bl[:, None, :].repeat(S, 1)
    ell = np.arange(nl)
    cl = np.broadcast_to(1e4 / (1.0 + ell * (ell + 1.0)),
                         (len(comps), S, nl)).astype(npdt)
    bins = tuple(int(b) for b in np.unique(np.concatenate(
        [[0, 2], np.geomspace(4, max(lmax, 5), 8).astype(int)])))
    cl_cfg = ClModelConfig(kind="binned", lmax=lmax, nmaps=S, bin_starts=bins)
    cl_cfgs = ()
    if fg_priors:
        cl_cfgs = [cl_cfg]
        for c, comp in enumerate(comps[1:], start=1):
            pr = FG_PRIORS[comp.name]
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
    rms = np.full((nband, S, npix), 20.0, npdt)
    data = rng.standard_normal((nband, S, npix)).astype(npdt) * 50.0
    t = lambda a: torch.as_tensor(a, device=device)
    sys = amp.build_system(t(F), t(bl), t(rms), t(cl), t(data),
                           ell_mask=None if ell_mask is None
                           else t(ell_mask))
    cfg = gibbs.GibbsConfig(cl_cfg=cl_cfg, cg_tol=cg_tol,
                            cg_maxiter=cg_maxiter, cl_cfgs=cl_cfgs)
    return plan, sys, cfg, comps


def build_preset(name: str, dtype=torch.float32, device=None, seed=0,
                 **overrides):
    """build_problem at a named preset; overrides replace preset fields
    (a smaller nside for a CPU rehearsal, say)."""
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return build_problem(dtype=dtype, device=device, seed=seed, **kw)


def initial_state(cfg: gibbs.GibbsConfig, sys: amp.AmplitudeSystem,
                  cl0: float = 100.0) -> gibbs.GibbsState:
    """The reference entry()'s starting state: zero amplitudes, all binned
    C_b at cl0."""
    return gibbs.init_state(sys.F.shape[1], sys.F.shape[2], cfg.cl_cfg.lmax,
                            len(cfg.cl_cfg.bin_starts), cl0=cl0,
                            dtype=sys.data.dtype, device=sys.data.device)
