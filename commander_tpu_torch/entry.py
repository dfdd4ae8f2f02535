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
"""
from __future__ import annotations

import numpy as np
import torch

from .instrument.bandpass import delta_bandpass
from .instrument.beam import gaussian_bl
from .model.cl import ClModelConfig
from .model.mixing import DiffuseComponent, mixing_matrix
from .sampling import amplitude as amp
from .sampling import gibbs
from .sphere import sht

GHZ = 1e9

PRESETS = {
    "entry": dict(nside=64, lmax=128, nband=3, cg_tol=1e-6, cg_maxiter=60),
    "tutorial": dict(nside=1024, lmax=2000, nband=3,
                     freqs_ghz=(30.0, 44.0, 70.0),
                     fwhm_arcmin=(32.3, 27.1, 13.3),
                     cg_tol=1e-6, cg_maxiter=100),
}


def components():
    return [
        DiffuseComponent("cmb", "cmb", 100 * GHZ, unit="uK_cmb"),
        DiffuseComponent("synch", "power_law", 30 * GHZ, theta0=(-3.1,)),
        DiffuseComponent("dust", "MBB", 353 * GHZ, theta0=(1.6, 19.6)),
    ]


def build_problem(nside, lmax, nband=3, freqs_ghz=None, fwhm_arcmin=None,
                  dtype=torch.float32, device="cpu", seed=0,
                  cg_tol=1e-6, cg_maxiter=60):
    """(plan, sys, cfg, comps) for the 3-component amplitude + C_ell
    problem, with the system and plan on `device`. Data are made on the
    host from numpy's default_rng(seed), as the reference makes them."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    plan = sht.get_plan(nside, lmax, dtype=dtype, device=device)
    comps = components()
    freqs = np.geomspace(30, 353, nband) if freqs_ghz is None \
        else np.asarray(freqs_ghz, np.float64)
    fwhm = 600.0 * 30 / freqs if fwhm_arcmin is None \
        else np.asarray(fwhm_arcmin, np.float64)
    bps = [delta_bandpass(f * GHZ) for f in freqs]
    F = mixing_matrix(comps, bps).astype(npdt)
    nl = lmax + 1
    npix = 12 * nside * nside
    bl = np.stack([gaussian_bl(fw, lmax) for fw in fwhm]).astype(npdt)[:, None, :]
    ell = np.arange(nl)
    cl = (1e4 / (1.0 + ell * (ell + 1.0)))[None, None, :].repeat(3, 0).astype(npdt)
    rng = np.random.default_rng(seed)
    rms = np.full((nband, 1, npix), 20.0, npdt)
    data = rng.standard_normal((nband, 1, npix)).astype(npdt) * 50.0
    t = lambda a: torch.as_tensor(a, device=device)
    sys = amp.build_system(t(F), t(bl), t(rms), t(cl), t(data))
    bins = tuple(int(b) for b in np.unique(np.concatenate(
        [[0, 2], np.geomspace(4, max(lmax, 5), 8).astype(int)])))
    cl_cfg = ClModelConfig(kind="binned", lmax=lmax, nmaps=1, bin_starts=bins)
    cfg = gibbs.GibbsConfig(cl_cfg=cl_cfg, cg_tol=cg_tol,
                            cg_maxiter=cg_maxiter)
    return plan, sys, cfg, comps


def build_preset(name: str, dtype=torch.float32, device="cpu", seed=0,
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
