"""run()'s spectral-index step of the host loop, branch by branch: the
port's driver/specind.specind_step against commander_tpu.run._specind_step,
float64 on the CPU at nside 8 / lmax 16 (param_tutorial_full.txt, T/Q/U),
two calls in a row with the JAX keys' draws replayed, to 1e-8.

Two cases, each one configuration that takes several branches at once (two
cases also let xdist deal the file after tests/test_sharding.py: ROADMAP
"Tier-1 verify"):
  pixel_alm_fullsky_poltype  --pixind: dust beta, T_d and AME nu_p per pixel
                             (dust beta per {T},{Q,U}); synch beta an alm
                             field to l = 4; ff T_e full-sky
                             (COMP_LMAX_IND 0) per {T},{Q},{U};
  pixreg_smoothing           synch beta by region means (a region map with
                             0-pixels: the frozen extra region; a fixed
                             region; region priors; the scale's postproc),
                             dust beta per pixel on a smoothing scale at
                             nside 4.

specind_draws regenerates _specind_step's draws from its key in its own
order (one split per parameter, one more per higher Stokes group; the MH
samplers' per-step (k1, k2) splits); tests/test_torch_host_loop_run.py
replays whole runs with it.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu.sampling import gibbs as jgibbs
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu_torch.driver import specind as tspec
from commander_tpu_torch.sampling import gibbs as tgibbs
from test_torch_host_loop import (LMAX, NSIDE, T, _abs, _models, _region_map,
                                  _rel, reference_form)  # noqa: F401
from test_torch_specind import _mh_draws

torch.set_num_threads(2)


def specind_draws(key, cfg, pcfgs, nside, lmax, pixind, S, data_dir=None):
    """_specind_step's draws under `key` in its order: per parameter one
    split (k) and, for each higher Stokes group, one more (kg): the alm MH's
    (eta, u) and the region MH's (delta, u) by its per-step (k1, k2)
    splits, an inversion's uniforms (P at the working nside, or one).
    Returns ({(ci, which): draws}, the key after)."""
    out = {}
    scales = cfg.smoothing_scales
    for ci, pc in enumerate(pcfgs):
        for which, name in enumerate(pc.indices):
            info = pc.indices[name]
            key, k = jax.random.split(key)
            lmax_ind = pc.lmax_ind
            if lmax_ind and lmax_ind > 0:
                npr = int(info.get("num_pixreg") or 0)
                if cfg.almsamp_pixreg and npr > 0:
                    rop = tspec.pixreg_ids(nside, info, npr, data_dir, True)
                    nreg = npr + int(np.any(rop < 0))
                    delta, u = _mh_draws(k, 3, lambda kk: jax.random.normal(
                        kk, (nreg,), jnp.float64))
                    out[(ci, which)] = {"delta": T(delta), "u": T(u)}
                else:
                    nl_i = min(lmax_ind, lmax) + 1
                    eta, u = _mh_draws(k, 3, lambda kk: j_random_alm_white(
                        kk, (nl_i, nl_i), jnp.float64))
                    out[(ci, which)] = {"eta": T(eta), "u": T(u)}
                continue
            ns = nside
            ss = int(info.get("smoothing_scale") or 0)
            if ss and ss <= len(scales) and scales[ss - 1]["nside"] \
                    and scales[ss - 1]["nside"] < nside:
                ns = scales[ss - 1]["nside"]
            per_pixel = lmax_ind is not None and lmax_ind < 0 and pixind

            def one(kk):
                if per_pixel:
                    return T(np.asarray(jax.random.uniform(
                        kk, (12 * ns * ns, 1), jnp.float64))[:, 0])
                return T(np.asarray(jax.random.uniform(
                    kk, (1,), jnp.float64))[0])

            entry = {"u": one(k)}
            pt = int(info.get("poltype") or 1)
            if S == 3 and pt >= 2:
                entry["pol"] = []
                for _ in range(1 if pt == 2 else 2):
                    key, kg = jax.random.split(key)
                    entry["pol"].append({"u": one(kg)})
            out[(ci, which)] = entry
    return out, key


BRANCHES = {
    "pixel_alm_fullsky_poltype": (("--COMP_LMAX_IND02=4",
                                   "--COMP_BETA_POLTYPE03=2",
                                   "--COMP_LMAX_IND06=0",
                                   "--COMP_T_E_POLTYPE06=3"), True),
    "pixreg_smoothing": (("--COMP_LMAX_IND02=4", "--ALMSAMP_PIXREG=.true.",
                          "--COMP_BETA_NUM_PIXREG02=6",
                          "--COMP_BETA_PIXREG_MAP02=reg.fits",
                          "--COMP_BETA_FIX_PIXREG02=2",
                          "--COMP_BETA_PIXREG_PRIORS02="
                          "-3.1,-3.0,-3.2,-3.1,-3.1,-3.0",
                          "--COMP_BETA_SMOOTHING_SCALE02=1",
                          "--COMP_BETA_SMOOTHING_SCALE03=1",
                          "--NUM_SMOOTHING_SCALES=1",
                          "--SMOOTHING_SCALE_FWHM01=600",
                          "--SMOOTHING_SCALE_FWHM_POSTPROC01=300",
                          "--SMOOTHING_SCALE_NSIDE01=4",
                          "--SMOOTHING_SCALE_LMAX01=8"), True),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_specind_step_matches(tmp_path_factory, reference_form, branch):
    """Two specind_step calls in a row (the second from the first's thetas,
    mixing and carried state) against run._specind_step with its keys'
    draws: every theta (maps per pixel), F and F_pix, the per-group values,
    the alm-field alms 1e-8; the step lengths and the region values
    exactly / 1e-8."""
    over, pixind = BRANCHES[branch]
    data_dir = str(tmp_path_factory.mktemp("reg"))
    _region_map(os.path.join(data_dir, "reg.fits"), NSIDE, 6)
    jout, model, jcfg, tcfg = _models(*over)
    (plan_j, sys_j, diffuse_j, bps_j, _, _, meta_j, truth_j, pcfgs_j, ts_j,
     ps_j, cl_cfgs_j) = jout
    C, S = len(diffuse_j), 3
    st_j = jgibbs.init_state(jax.random.PRNGKey(0), C, S, LMAX, 4,
                             ntemp=int(ts_j.maps.shape[0]),
                             nsrc=int(ps_j.pix.shape[0]))
    rng = np.random.default_rng(7)
    t0 = rng.standard_normal(st_j.t.shape)
    p0 = np.asarray(meta_j["ptsrc_true"])
    st_j = dataclasses.replace(st_j, a=jnp.asarray(truth_j[0]
                                                   + 1j * truth_j[1]),
                               t=jnp.asarray(t0), p=jnp.asarray(p0))
    st_t = tgibbs.GibbsState(a=model.truth, cl_bins=torch.zeros(
        C, S, 4, dtype=torch.float64),
                             t=T(t0), p=T(p0))
    th_j = [tuple(d.theta0) for d in diffuse_j]
    th_t = [list(d.theta0) for d in model.diffuse]
    st = dict(ind_alms={}, ind_steps={}, thetas_pol={}, ind_regs={})
    hs = tspec.HostState()
    sys_t = model.sys
    key = jax.random.PRNGKey(5)
    for _ in range(2):
        d, _k = specind_draws(key, tcfg, model.pcfgs, NSIDE, LMAX, pixind,
                              S, data_dir)
        key, sys_j, th_j = jrun._specind_step(
            key, jcfg, pcfgs_j, diffuse_j, bps_j, sys_j, plan_j, st_j, th_j,
            deltas=[0.0] * 3, pixind=pixind, data_dir=data_dir,
            synthetic=True, ts=ts_j, ps=ps_j, **st)
        assert np.array_equal(np.asarray(key), np.asarray(_k))
        sys_t, recs = tspec.specind_step(
            tcfg, model.pcfgs, model.diffuse, model.bps, sys_t, model.plan,
            st_t, th_t, hs, pixind=pixind, pol=True, data_dir=data_dir,
            synthetic=True, ts=model.ts, ps=model.ps, draws=d)
        for ci in range(C):
            for j, t in enumerate(th_j[ci]):
                assert _abs(th_t[ci][j], t) <= 1e-8, (branch, ci, j)
        assert _rel(sys_t.F, sys_j.F) <= 1e-8
        if sys_j.F_pix is None:
            assert sys_t.F_pix is None
        else:
            assert _rel(sys_t.F_pix, sys_j.F_pix) <= 1e-8
        assert hs.ind_steps == st["ind_steps"]
        assert set(hs.thetas_pol) == set(st["thetas_pol"])
        for k, v in st["thetas_pol"].items():
            for g, r in zip(hs.thetas_pol[k], v):
                assert _abs(g, r) <= 1e-8
        for k, v in st["ind_alms"].items():
            assert _rel(hs.ind_alms[k], v) <= 1e-8
        for k, v in st["ind_regs"].items():
            got = hs.ind_regs[k]
            assert np.array_equal(got, v) if k[0] == "rop" \
                else _abs(got, v) <= 1e-8
    kinds = {r["branch"] for r in recs.values()}
    assert kinds == {"pixel_alm_fullsky_poltype": {"pixel", "alm", "fullsky"},
                     "pixreg_smoothing": {"pixel", "alm_pixreg"}}[branch]
    assert sys_t.F_pix is not None
    if branch == "pixel_alm_fullsky_poltype":
        assert len(hs.thetas_pol[(3, 0)]) == 2
        assert hs.thetas_pol[(2, 0)][0].shape == (12 * NSIDE ** 2,)
