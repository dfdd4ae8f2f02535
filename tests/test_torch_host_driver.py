"""run()'s host loop with --cg-groups and with OUTPUT_EVERY_NTH_CG_ITERATION:
the port's chains against commander_tpu.run.run's, float64 on the CPU at
nside 8 / lmax 16 (param_tutorial_full.txt, T/Q/U), 2 iterations with
run()'s draws replayed attempt by attempt.

Two cases, each one JAX run():
  cg_groups      --cg-groups with a user group written on the command line
                 (CG_SAMPLING_GROUP01 = md,cmb with a group mask that drops
                 a band of pixels, and its maxiter), then the automatic
                 groups of every component: the diffuse ones, md, radio and
                 relquad. No parameter file in the repository sets a group;
  cg_dumps       OUTPUT_EVERY_NTH_CG_ITERATION = 3, which run() takes only
                 without template and source rows, so md, radio and
                 relquad are left out: the amplitudes every third CG
                 iteration in cg_amp_k<step>_i<iteration>.npz.

run()'s keys here: per attempt the state key's split (next, k_amp, k_cl)
by gibbs_step, group gi drawing under fold_in(k_amp, gi) (its solve's own
splits: test_torch_host_parts._group_draws), the dumping CG's rhs under
k_amp as compute_rhs draws it; skey = fold_in(key, 552) by _specind_step.
Held to 1e-8 as test_torch_driver.py holds its chains: every sample (alms,
D_l, indices, md and source amplitudes, chi^2, CG iterations) and the
accept / reject sequence; the dump files by name, their amplitudes to 1e-6
of their max (float32 files). With the groups, the l <= 1 alms and the md
amplitudes are held to GROUP_LOW (and the D_l and indices, which read
them, to 1e-6): the md rows and the diffuse monopoles and dipoles share
those modes, and the sweep leaves their split to rounding. run() parts from
itself there when its data move by 1e-12 (measured at this size: 2.3e-7 of
the cmb alms' max in l <= 1, 4.4e-7 of the md amplitudes' max, l >= 2 below
1.1e-11); the port stands 1.7e-7 / 1.0e-6 and 5.5e-7 / 1.9e-6 from it at
samples 1 / 2, within 10x run()'s own spread.
"""
import os

import jax
import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu.io import fits as jfits
from commander_tpu_torch.driver import loop
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sphere import sht as tsht
from test_torch_driver import (_cfgs, _port_model, _same_samples, _samples,
                               _status, _truth, step_draws)
from test_torch_host_loop_specind import specind_draws
from test_torch_host_parts import _group_draws

torch.set_num_threads(2)

NSIDE, LMAX = 8, 16
# 10x run()'s own spread in the modes the groups leave to rounding
GROUP_LOW = 1e-5
CASES = {
    "cg_groups": (dict(cg_groups=True), (
        "--NUM_CG_SAMPLING_GROUPS=1", "--CG_SAMPLING_GROUP01=md,cmb",
        "--CG_SAMPLING_GROUP_MASK01=gmask.fits",
        "--CG_SAMPLING_GROUP_MAXITER01=80")),
    "cg_dumps": (dict(), (
        "--OUTPUT_EVERY_NTH_CG_ITERATION=3", "--INCLUDE_COMP04=.false.",
        "--INCLUDE_COMP05=.false.", "--INCLUDE_COMP08=.false.")),
}


def host_replay(jcfg, tcfg, model, groups, chain=1):
    """draws(attempt) of the port's host loop: run()'s own (module
    docstring)."""
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.base_seed), chain)
    state_key, skey = key, jax.random.fold_in(key, 552)
    made = {}

    def draws(attempt, bands=None, npasses=0):
        nonlocal state_key, skey
        if attempt in made:
            return made[attempt]
        k_amp = jax.random.split(state_key, 3)[1]
        d, state_key = step_draws(state_key, model)
        if groups:
            w = type("W", (), {"sys": model.sys, "ps": model.ps})
            d["groups"] = [_group_draws(jax.random.fold_in(k_amp, gi), g, w)
                           for gi, g in enumerate(groups)]
        d["specind"], skey = specind_draws(skey, tcfg, model.pcfgs, NSIDE,
                                           LMAX, False, 3)
        made[attempt] = d
        return d

    return draws


def _same_grouped(got, ref, its):
    """The groups' samples: l >= 2 alms, source amplitudes and chi^2 1e-8,
    l <= 1 alms and md amplitudes GROUP_LOW, D_l and indices 1e-6 (in
    units of max(1, |value|)), CG iterations exactly (module docstring)."""
    rel = lambda a, b: np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    within = lambda a, b, t: np.all(np.abs(np.asarray(a) - np.asarray(b))
                                    <= t * np.maximum(1.0, np.abs(b)))
    for i in its:
        g, r = got[i], ref[i]
        for name, c in r["comps"].items():
            a, b = g["comps"][name]["alm"], c["alm"]
            top = np.abs(b).max()
            assert np.abs(a[:, 2:] - b[:, 2:]).max() <= 1e-8 * top, (i, name)
            assert np.abs(a[:, :2] - b[:, :2]).max() <= GROUP_LOW * top
            for k in ("Dl", "specind"):
                assert within(g["comps"][name][k], c[k], 1e-6), (i, name, k)
        assert rel(g["aux"]["md_amps"], r["aux"]["md_amps"]) <= GROUP_LOW
        for k in ("ptsrc_amps", "chisq"):
            assert within(g["aux"][k], r["aux"][k], 1e-8), (i, k)
        assert int(g["aux"]["cg_iters"]) == int(r["aux"]["cg_iters"])
        assert np.allclose(g["gain"], r["gain"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", list(CASES))
def test_host_driver_chain_matches_run(tmp_path, name):
    """Samples 1-2 as run() writes them (1e-8) and the same accept / reject
    sequence; with groups the port's sweep runs every group; with the dumps
    the same files, their amplitudes to 1e-6."""
    kw, over = CASES[name]
    npix = 12 * NSIDE ** 2
    mask = np.ones(npix)
    mask[npix // 3: npix // 2] = 0.0
    jfits.write_map(str(tmp_path / "gmask.fits"), mask[None])
    jcfg, tcfg = _cfgs(*over)
    _, truth = _truth(jcfg, NSIDE, LMAX)
    model = _port_model(tcfg, truth, NSIDE, LMAX)
    groups = ()
    if kw.get("cg_groups"):
        from commander_tpu_torch.sampling.groups import build_groups
        groups = build_groups(
            tcfg, [d.name for d in model.diffuse],
            model.meta["template_names"], True, ptsrc_labels=["radio"],
            nmaps=3, npix=npix, data_dir=str(tmp_path))
        assert groups[0].mask is not None and groups[0].temp_idx \
            and len(groups) == 9
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfg, "_amp_synth", tsht.alm2map)
        for side in ("jax", "port"):
            os.makedirs(tmp_path / side)
        _, out["jax"] = jrun.run(
            jcfg, nside=NSIDE, lmax=LMAX, synthetic=True, niter=2,
            outdir=str(tmp_path / "jax"), dtype="float64", verbose=False,
            pol=True, data_dir=str(tmp_path), **kw)
        out["port"] = loop.run(
            tcfg, nside=NSIDE, lmax=LMAX, synthetic=True, niter=2,
            outdir=str(tmp_path / "port"), dtype=torch.float64,
            verbose=False, pol=True, device="cpu", a_true=truth,
            data_dir=str(tmp_path),
            draws=host_replay(jcfg, tcfg, model, groups), **kw)
    got, ref = _samples(out["port"].chain_path), _samples(out["jax"])
    assert sorted(got) == sorted(ref) == [1, 2]
    for smp in list(got.values()) + list(ref.values()):
        # a model without rows writes no row amplitudes
        for k in ("md_amps", "ptsrc_amps"):
            smp["aux"].setdefault(k, np.zeros(0))
    if name == "cg_groups":
        _same_grouped(got, ref, (1, 2))
    else:
        _same_samples(got, ref, (1, 2))
    assert [r["ok"] for r in out["port"].records] == \
        _status(str(tmp_path / "jax"))
    assert out["port"].host is not None
    if name == "cg_dumps":
        names = sorted(f for f in os.listdir(tmp_path / "jax")
                       if f.startswith("cg_amp_"))
        assert names == sorted(f for f in os.listdir(tmp_path / "port")
                               if f.startswith("cg_amp_")) and len(names) > 2
        for f in names:
            g, r = (np.load(tmp_path / s / f) for s in ("port", "jax"))
            for k in ("a_re", "a_im"):
                assert g[k].dtype == np.float32
                assert np.abs(g[k] - r[k]).max() <= 1e-6 * np.abs(r[k]).max()
