"""run()'s host loop end to end: the port's chain against the JAX
package's, float64 on the CPU at nside 8 / lmax 16
(param_tutorial_full.txt, T/Q/U), 2 iterations and a resume to 3 from
the JAX chain, with run()'s draws replayed attempt by attempt.

One case per group of configurations, each a single JAX run() (plus its
resume) that covers several of them:
  pixind_te_resample   --pixind --te-cl, RESAMPLE_CMB, synch beta an alm
                       field to l = 8, dust beta per Stokes group
                       (POLTYPE 2); cmb, synch and dust only (ff and ame
                       left out): with five components on three bands the
                       joint CG under the TE prior amplifies the two
                       packages' rounding (their operators and
                       preconditioners agree to 1e-12) to 3e-4 of the alms
                       in its 18 iterations (ROADMAP queue 3 item 10d);
                       run() parts from itself as far when its data move
                       by 1e-12, which the whole-model case holds the port
                       to (tests/test_torch_host_loop_te.py);
  pixreg_smoothing     --pixind, synch beta by region means (ALMSAMP_PIXREG,
                       a region map with unsampled pixels, a fixed region,
                       region priors), dust beta on a smoothing scale.

run()'s key chain in the host loop: the state key (the chain key; on a
resume fold_in(key, max(first, 1))) split per attempt by gibbs_step, and
skey = fold_in(key, 552) split, in order, once per component for the TE
draw, three times for the MH moves, then by _specind_step
(test_torch_host_loop_specind.specind_draws). The port runs in run()'s
forms of the declared divergences (the model sky under F_pix at the pixel
mean F, the index phase's spin-0 amplitude maps). Held: every sample
(alms, D_l, indices, theta maps, per-group values, md / source
amplitudes, chi^2, CG iterations) to 1e-8, the accept / reject sequence,
the MH acceptances and the adaptive step lengths after every attempt.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu.sampling import mh as jmh
from commander_tpu_torch.driver import loop
from commander_tpu_torch.driver import specind as tspec
from commander_tpu_torch.model import cl as tcl
from commander_tpu_torch.sampling import chisq as tchisq
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import mh as tmh
from commander_tpu_torch.sphere import sht as tsht
from test_torch_cl import _jax_te_draws
from test_torch_driver import (_cfgs, _port_model, _same_samples, _samples,
                               _status, _truth, step_draws)
from test_torch_host_loop import _region_map
from test_torch_host_loop_specind import specind_draws

torch.set_num_threads(2)

NSIDE, LMAX = 8, 16
T = torch.as_tensor

GROUPS = {
    "pixind_te_resample": (dict(pixind=True, te_cl=True), (
        "--RESAMPLE_CMB=.true.", "--COMP_LMAX_IND02=8",
        "--COMP_BETA_POLTYPE03=2", "--INCLUDE_COMP06=.false.",
        "--INCLUDE_COMP07=.false.")),
    "pixreg_smoothing": (dict(pixind=True, te_cl=False), (
        "--COMP_LMAX_IND02=8", "--ALMSAMP_PIXREG=.true.",
        "--COMP_BETA_NUM_PIXREG02=6", "--COMP_BETA_PIXREG_MAP02=reg.fits",
        "--COMP_BETA_FIX_PIXREG02=2",
        "--COMP_BETA_PIXREG_PRIORS02=-3.1,-3.0,-3.2,-3.1,-3.1,-3.0",
        "--COMP_BETA_SMOOTHING_SCALE03=1", "--NUM_SMOOTHING_SCALES=1",
        "--SMOOTHING_SCALE_FWHM01=600",
        "--SMOOTHING_SCALE_FWHM_POSTPROC01=300",
        "--SMOOTHING_SCALE_NSIDE01=4", "--SMOOTHING_SCALE_LMAX01=8")),
}


def host_replay(jcfg, tcfg, model, te_cl, pixind, first=None, chain=1,
                data_dir=None):
    """draws(attempt) of the port's host loop: run()'s own (module
    docstring), each new attempt the next in its key chain."""
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.base_seed), chain)
    state_key = key if first is None else jax.random.fold_in(
        key, max(first, 1))
    skey = jax.random.fold_in(key, 552)
    C, S = len(model.diffuse), model.meta["nmaps"]
    nbins = len(model.cl_cfg.bin_starts) if te_cl else max(
        [len(model.cl_cfg.bin_starts)]
        + [len(cc.bin_starts) for cc in model.cl_cfgs])
    nmodes = tcl.wishart_dof_check(model.cl_cfg)
    made = {}

    def draws(attempt, bands=None, npasses=0):
        nonlocal state_key, skey
        if attempt in made:
            return made[attempt]
        d, state_key = step_draws(state_key, model)
        if te_cl and S == 3:
            d["te"] = []
            for _ in range(C):
                skey, ck = jax.random.split(skey)
                d["te"].append(_jax_te_draws(ck, nmodes))
        if jcfg.resample_cmb:
            d["resample"] = []
            for _ in range(3):
                skey, jk = jax.random.split(skey)
                k1, k2 = jax.random.split(jk)
                d["resample"].append({
                    "eps": T(np.asarray(jax.random.normal(
                        k1, (S, nbins), jnp.float64))),
                    "u": T(np.asarray(jax.random.uniform(
                        k2, (), jnp.float64)))})
        d["specind"], skey = specind_draws(skey, tcfg, model.pcfgs, NSIDE,
                                           LMAX, pixind, S, data_dir)
        made[attempt] = d
        return d

    return draws


def _runs(root, name):
    """Both drivers' 2-iteration chains and their resumes to 3, with what
    each recorded per attempt: the step lengths after the index step and
    the MH acceptances."""
    kw, over = GROUPS[name]
    data_dir = str(root)
    _region_map(os.path.join(data_dir, "reg.fits"), NSIDE, 6)
    jcfg, tcfg = _cfgs(*over)
    _, truth = _truth(jcfg, NSIDE, LMAX)
    model = _port_model(tcfg, truth, NSIDE, LMAX)
    seen = {"jax": [], "port": [], "jax_mh": [], "port_mh": []}
    j_spec, j_mh = jrun._specind_step, jmh.sample_joint_alm_cl
    t_spec = tspec.specind_step

    def j_spec_spy(*a, **k):
        out = j_spec(*a, **k)
        seen["jax"].append(dict(k["ind_steps"]))
        return out

    def j_mh_spy(*a, **k):
        out = j_mh(*a, **k)
        seen["jax_mh"].append(bool(out[2]))
        return out

    def t_spec_spy(*a, **k):
        out = t_spec(*a, **k)
        seen["port"].append(dict(a[8].ind_steps))
        return out

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrun, "_specind_step", j_spec_spy)
        mp.setattr(jmh, "sample_joint_alm_cl", j_mh_spy)
        mp.setattr(tspec, "specind_step", t_spec_spy)
        mp.setattr(tchisq, "_REFERENCE_FORM", True)
        mp.setattr(tfg, "_amp_synth", tsht.alm2map)
        for tag, niter in (("", 2), ("3", 3)):
            jdir, tdir = root / f"jax{tag}", root / f"port{tag}"
            first = None
            if tag:
                for d in (jdir, tdir):
                    os.makedirs(d)
                    shutil.copy(out["jax"], d / "chain_c0001.h5")
                first = 1
            _, out["jax" + tag] = jrun.run(
                jcfg, nside=NSIDE, lmax=LMAX, synthetic=True, niter=niter,
                outdir=str(jdir), dtype="float64", verbose=False, pol=True,
                data_dir=data_dir, **kw)
            out["port" + tag] = loop.run(
                tcfg, nside=NSIDE, lmax=LMAX, synthetic=True, niter=niter,
                outdir=str(tdir), dtype=torch.float64, verbose=False,
                pol=True, device="cpu", data_dir=data_dir, a_true=truth,
                draws=host_replay(jcfg, tcfg, model, kw["te_cl"],
                                  kw["pixind"], first=first,
                                  data_dir=data_dir), **kw)
    for r in (out["port"], out["port3"]):
        seen["port_mh"] += [a for rec in r.records
                            for a in rec.get("resample", [])]
    return out, seen


def _same_maps(got, ref, its):
    """The entries of map-valued indices and per-group values, 1e-8 in
    units of max(1, |value|)."""
    for i in its:
        for name, r in ref[i]["comps"].items():
            g = got[i]["comps"][name]
            assert set(g) == set(r), (i, name)
            for k in r:
                if k.startswith(("theta_map", "specind_pol")):
                    assert g[k].shape == r[k].shape
                    assert np.all(np.abs(g[k] - r[k]) <= 1e-8 * np.maximum(
                        1.0, np.abs(r[k]))), (i, name, k)


@pytest.mark.parametrize("name", list(GROUPS))
def test_host_loop_chain_matches_run(tmp_path, name):
    """The host loop's samples 1-2 and, after a resume from the JAX chain's
    sample 1, samples 2-3, as run() writes them (1e-8), with the same
    accept / reject sequence (run.py:2440-2456), the same MH acceptances
    and step lengths; the theta maps are maps."""
    out, seen = _runs(tmp_path, name)
    for tag, its in (("", (1, 2)), ("3", (2, 3))):
        got = _samples(out["port" + tag].chain_path)
        ref = _samples(out["jax" + tag])
        assert sorted(got) == sorted(ref)
        _same_samples(got, ref, its)
        _same_maps(got, ref, its)
        seq = [r["ok"] for r in out["port" + tag].records]
        assert seq == _status(os.path.dirname(out["jax" + tag]))
    assert seen["port"] == seen["jax"] and len(seen["jax"]) >= 4
    assert seen["port_mh"] == seen["jax_mh"]
    last = _samples(out["port3"].chain_path)[3]["comps"]
    assert last["synch"]["theta_map0"].shape == (12 * NSIDE ** 2,)
    assert last["dust"]["theta_map0"].std() > 0
    if name == "pixind_te_resample":
        assert len(seen["jax_mh"]) == 3 * len(seen["jax"])
        assert "specind_pol0" in last["dust"]
    else:
        reg = out["port3"].host.ind_regs
        assert reg[("rop", 1, 0)].min() == -1 and reg[(1, 0)].shape == (7,)
