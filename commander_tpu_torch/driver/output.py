"""What the driver writes at a thinning point: the chain sample, the TOD
state, the sigma_l files and the optional FITS maps (run.py:2469-2562).

Everything is written from one host copy of the state, taken after the step
(no read inside a step): the alms are copied to the host once, in the run's
complex dtype, and written as complex128 packed real alms, as the JAX
package writes them.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..io import fits as fitsio
from ..model.cl import sigma_ell_spectra, write_sigma_l
from ..sampling import chisq
from ..sampling import gibbs as gibbs_mod


def _host(x):
    return None if x is None else x.detach().to("cpu").numpy()


def write_sample(ch, it: int, model, gcfg, sys, state, thetas, gains,
                 chi2: float, outdir: str, cfg, bands=None, thetas_pol=None,
                 bp_deltas=None):
    """Sample `it` of the chain file `ch` (io/chain.ChainFile): per diffuse
    component its alm, D_l of the current C_l and its spectral parameters
    (run.py:2512-2528), the band gains, and under aux/ the chi^2, CG
    iterations, bandpass shifts (bp_deltas, Hz; zeros where not given) and
    template and source amplitudes; per TOD band (None: none) its state,
    monopoles and bandpass shift under tod/<label>; the
    sigma_l_<comp>_k<it>.dat files;
    with OUTPUT_CHISQ_MAP / OUTPUT_RESIDUAL_MAPS the chi^2 and residual FITS
    maps. thetas: per component the tuple of its parameter values (floats,
    0-d tensors or maps: a map is written whole as theta_map<j> and its
    mean under specind, as run.py:2505-2517 writes them); thetas_pol: the
    per-Stokes-group values of POLTYPE >= 2 parameters, {(ci, j): [group 1,
    ...]}, written as specind_pol<j> (each group's mean)."""
    meta, diffuse = model.meta, model.diffuse
    lmax = meta["lmax"]
    a_host = _host(state.a).astype(np.complex128)
    if cfg.output_chisq_map or cfg.output_residual_maps:
        # the diffuse model's chi^2 per pixel, as run.py:2490 maps it
        _, cmap, _ = chisq.compute_chisq(sys, model.plan, state.a)
        if cfg.output_chisq_map:
            fitsio.write_map(os.path.join(outdir, f"chisq_k{it:06d}.fits"),
                             _host(cmap.sum(dim=0)), unit="chisq")
        if cfg.output_residual_maps:
            res = _host(sys.data - chisq.full_sky(
                sys, model.plan, state.a, model.ts, model.ps, state.t,
                state.p))
            for b, band in enumerate(cfg.bands):
                fitsio.write_map(os.path.join(
                    outdir, f"res_{band.label}_k{it:06d}.fits"), res[b],
                    unit="uK")
    cl_now = _host(gibbs_mod.eval_cl_all(gcfg, sys, state.cl_bins)
                   ).astype(np.float64)
    ell = np.arange(lmax + 1)
    dl_fac = ell * (ell + 1) / (2 * np.pi)
    comps_out = {}
    mean = lambda t: float(torch.mean(torch.as_tensor(t, dtype=torch.float64)))
    for i, d in enumerate(diffuse):
        entry = {"alm": a_host[i], "Dl": cl_now[i] * dl_fac,
                 "specind": np.asarray([mean(t) for t in thetas[i]],
                                       np.float64)}
        for j, t in enumerate(thetas[i]):
            if np.ndim(t) > 0:
                entry[f"theta_map{j}"] = _host(torch.as_tensor(t)).astype(
                    np.float64)
            if thetas_pol and (i, j) in thetas_pol:
                entry[f"specind_pol{j}"] = np.asarray(
                    [mean(v) for v in thetas_pol[(i, j)]], np.float64)
        comps_out[d.name] = entry
        sig = _host(sigma_ell_spectra(state.a[i].to(torch.complex128),
                                      lmax))
        write_sigma_l(os.path.join(outdir, f"sigma_l_{d.name}_k{it:06d}.dat"),
                      sig, lmax)
    B = len(cfg.bands)
    bp = np.zeros(B) if bp_deltas is None \
        else np.asarray(bp_deltas, np.float64).copy()
    extra = {"chisq": chi2, "cg_iters": int(state.cg_iters),
             "bp_delta": bp}
    if state.t is not None:
        extra["md_amps"] = _host(state.t)
    if state.p is not None:
        extra["ptsrc_amps"] = _host(state.p)
        if meta.get("ptsrc_alpha") is not None:
            extra["ptsrc_alpha"] = np.asarray(meta["ptsrc_alpha"])
    ch.write_sample(it, comps_out, gains=np.asarray(gains, np.float64),
                    extra=extra)
    for b, band in enumerate(bands or ()):
        if band is None:
            continue
        st = band.state
        ch.write_tod_state(it, cfg.bands[b].label, dict(
            gain=_host(st.gain), sigma0=_host(st.sigma0),
            alpha=_host(st.alpha), fknee=_host(st.fknee),
            mono=_host(band.mono), bp_delta=bp[b:b + 1]))
