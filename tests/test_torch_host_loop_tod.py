"""run()'s host loop with --tod, float64 on the CPU: the port's chain against
commander_tpu.run.run(tod=True, dtype="float64") at nside 8 / lmax 16
(param_tutorial_full.txt, 8 scans x 2 detectors x 2048 samples per TOD
band), 2 iterations and a resume to 3 from the JAX chain, with run()'s
draws replayed attempt by attempt.

One case per group of configurations, each one JAX run() and its resume:
  pixind_bp_4d       --pol --pixind, synch beta an alm field to l = 8, every
                     band's bandpass sampled on the TOD chi^2 (attempt 1 at
                     scalar theta in the move's fast form, later ones under
                     F_pix in its general form) and the 4D maps every
                     iteration. Not SAMPLE_TOD_MONOPOLE: on T/Q/U some hit
                     pixels here are seen at fewer than three angles, and
                     run()'s unguarded solve of their singular Stokes
                     blocks gives rounding noise -- NaN in one band (the
                     draw then kept at zero), monopoles of 54 and 488 uK in
                     the others where the port's LU gives 67 and 601, and
                     4e8 by the second iteration (measured at this size;
                     ROADMAP queue 3 item 4a);
  scalar_mixed       scalar theta, band 030's bandpass sampled in the fast
                     form every attempt, SAMPLE_TOD_MONOPOLE (T only, so
                     every hit pixel's block is usable and the monopoles
                     move), band 070 map-level (BAND_TOD_TYPE
                     none for the port; run() reads that value as a TOD
                     type and keeps a band at map level only without the
                     key, so its configuration drops the key: ROADMAP
                     queue 3 item 13) and band 044 unpolarized (so the run
                     is T only, as build_model makes it in both packages);
                     cmb, synch, dust and the sources only, 16 scans x
                     4096 samples: T only with the md and relquad rows
                     run()'s first TOD iteration bins maps at chi^2 1e60-
                     1e65 (band 030's gain falls to 0.56 in its burn-in,
                     the md amplitudes reach 5e32), in both packages, and
                     the two part by the rounding that amplifies (5e-5 of
                     the alms); without those rows its chi^2 is 3.5e4
                     (measured; ROADMAP queue 3 item 14). This chain is
                     held to MIXED, not 1e-8: T only its TOD draws (the
                     noise-PSD grid cells, the scans' accept flags) turn on
                     rounding, and run() against itself with its data moved
                     by 1e-12 parts by 8.1e-6 / 7.2e-5 / 6.7e-4 of the
                     cmb / dust / synch alms at sample 1 (measured at this
                     size); the port stands 1.3e-6 / 1.0e-5 / 9.7e-5 from
                     run() there, its TOD gains, sigma0 and monopoles
                     within 8e-5, and MIXED is 10x run()'s own spread;
                     the noise-PSD grid cells are not held there (one
                     flips by the resume's last sample).

run()'s key chain with TOD on its host loop: the state key (the chain key;
on a resume fold_in(key, max(first, 1))) split by the warm start's
gibbs_step and then once per attempt; the burn-in's passes under
fold_in(key, 772), one split per pass and TOD band; per attempt tkey =
fold_in(key, 991) split once per TOD band for its pass and, where the band
samples its bandpass, once more into (tkey, kp, ka): the proposal's normal
and the accept uniform; skey = fold_in(key, 552) by _specind_step
(test_torch_host_loop_specind.specind_draws). The port runs in run()'s
forms of the declared divergences (the model sky under F_pix at the pixel
mean F, the index phase's spin-0 amplitude maps, every band's orbital
dipole at 30 GHz). Held to 1e-8 as test_torch_host_loop_run.py holds its
chains: every sample (alms, D_l, indices, md and source amplitudes, chi^2,
CG iterations, bp_delta), each TOD band's gain, sigma0, alpha, fknee,
monopoles and bandpass shift, the accept / reject sequence, both MH moves'
acceptances (the bandpass moves and the index step's alm field) and the 4D
maps (1e-8 of their max). The theta maps to THETA of their max: the port's
T_d map stands 2.4e-8 from run()'s (measured); a per-pixel inversion draw
moves ~2000 grid steps per unit relative change of the alms
(torch_tools/host_loop_rounding.py), and the alms here agree to 1e-8, which
allows ~2e-5 grid steps, 3e-7 of T_d's max.
"""
import dataclasses
import os
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu.sampling import mh as jmh
from commander_tpu_torch.driver import loop
from commander_tpu_torch.driver import specind as tspec
from commander_tpu_torch.io.chain import ChainFile
from commander_tpu_torch.sampling import chisq as tchisq
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import tod_gibbs
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.tod import sim as tsim
from test_torch_driver import (_cfgs, _port_model, _rel, _same_samples,
                               _samples, _status, _truth, step_draws)
from test_torch_driver import tod_draws_row
from test_torch_host_loop_specind import specind_draws

torch.set_num_threads(2)

NSIDE, LMAX = 8, 16
# scalar_mixed's bound (module docstring): 10x run()'s own spread
MIXED = 1e-2
# the theta maps, of their max (module docstring)
THETA = 1e-6
T = torch.as_tensor
TOD = ("--SYNTH_TOD_NSCAN=8", "--SYNTH_TOD_NTOD=2048", "--SYNTH_TOD_NDET=2")
TOD_T = ("--SYNTH_TOD_NSCAN=16", "--SYNTH_TOD_NTOD=4096",
         "--SYNTH_TOD_NDET=2")
BP_ALL = tuple(f"--BAND_SAMP_BANDPASS00{b}=.true." for b in (1, 2, 3))

CASES = {
    "pixind_bp_4d": (dict(pixind=True), TOD + BP_ALL + (
        "--COMP_LMAX_IND02=8", "--TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER=1")),
    "scalar_mixed": (dict(pixind=False), TOD_T + (
        "--BAND_SAMP_BANDPASS001=.true.", "--BAND_TOD_TYPE003=none",
        "--BAND_POLARIZATION002=.false.", "--SAMPLE_TOD_MONOPOLE=.true.",
        "--INCLUDE_COMP04=.false.", "--INCLUDE_COMP06=.false.",
        "--INCLUDE_COMP07=.false.", "--INCLUDE_COMP08=.false.")),
}


def host_tod_replay(jcfg, tcfg, model, pixind, first=None, chain=1):
    """draws(attempt, bands, npasses) of the port's host loop with TOD:
    run()'s own (module docstring)."""
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.base_seed), chain)
    state_key = key if first is None else jax.random.fold_in(
        key, max(first, 1))
    skey = jax.random.fold_in(key, 552)
    tkey = jax.random.fold_in(key, 991)
    S = model.meta["nmaps"]
    made = {}

    def draws(attempt, bands=None, npasses=0):
        nonlocal state_key, skey, tkey
        if attempt in made:
            return made[attempt]
        d, state_key = step_draws(state_key, model)
        if attempt == 0:
            k, d["tod"] = jax.random.fold_in(key, 772), []
            for _ in range(npasses):
                k, row = tod_draws_row(k, bands)
                d["tod"].append(row)
            return d
        d["tod"], d["bp"] = [], []
        for b, band in enumerate(bands):
            if band is None:
                d["tod"].append(None)
                d["bp"].append(None)
                continue
            tkey, row = tod_draws_row(tkey, [band])
            d["tod"].append(row[0])
            bp = None
            if jcfg.bands[b].sample_bandpass:
                tkey, kp, ka = jax.random.split(tkey, 3)
                bp = {"z": float(jax.random.normal(kp, (), jnp.float64)),
                      "u": T(np.asarray(jax.random.uniform(
                          ka, (), jnp.float64)))}
            d["bp"].append(bp)
        d["specind"], skey = specind_draws(skey, tcfg, model.pcfgs, NSIDE,
                                           LMAX, pixind, S)
        made[attempt] = d
        return d

    return draws


def _runs(root, name):
    """Both drivers' 2-iteration chains and their resumes to 3, with the
    bandpass acceptances and the index step lengths each recorded."""
    kw, over = CASES[name]
    jcfg, tcfg = _cfgs(*over)
    if "--BAND_TOD_TYPE003=none" in over:
        jcfg.bands[2] = dataclasses.replace(jcfg.bands[2], tod_type="none")
    _, truth = _truth(jcfg, NSIDE, LMAX)
    model = _port_model(tcfg, truth, NSIDE, LMAX)
    seen = {"jax": [], "port": [], "jax_bp": []}
    j_spec, j_acc = jrun._specind_step, jmh.accept_bandpass_tod
    t_spec, real_sim = tspec.specind_step, tsim.simulate_tod

    def j_spec_spy(*a, **k):
        out = j_spec(*a, **k)
        seen["jax"].append(dict(k["ind_steps"]))
        return out

    def j_acc_spy(*a, **k):
        out = j_acc(*a, **k)
        seen["jax_bp"].append(bool(out[1]))
        return out

    def t_spec_spy(*a, **k):
        out = t_spec(*a, **k)
        seen["port"].append(dict(a[8].ind_steps))
        return out

    def sim(*a, **k):
        # run._setup_synthetic_tod simulates every orbital dipole at 30 GHz
        return real_sim(*a, **dict(k, nu=30e9))

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrun, "_specind_step", j_spec_spy)
        mp.setattr(jmh, "accept_bandpass_tod", j_acc_spy)
        mp.setattr(tspec, "specind_step", t_spec_spy)
        mp.setattr(tchisq, "_REFERENCE_FORM", True)
        mp.setattr(tfg, "_amp_synth", tsht.alm2map)
        mp.setattr(tod_gibbs, "simulate_tod", sim)
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
                tod=True, **kw)
            out["port" + tag] = loop.run(
                tcfg, nside=NSIDE, lmax=LMAX, synthetic=True, niter=niter,
                outdir=str(tdir), dtype=torch.float64, verbose=False,
                pol=True, tod=True, device="cpu", a_true=truth,
                draws=host_tod_replay(jcfg, tcfg, model, kw["pixind"],
                                      first=first), **kw)
    return out, seen


def _same_tod(got_path, ref_path, its, tol=1e-8):
    """Each TOD band's state, monopoles and bandpass shift, to tol in units
    of max(1, the value's max); where tol is looser than 1e-8 the noise-PSD
    grid cells (alpha, fknee) are not held: they flip under rounding."""
    with ChainFile(got_path, "r") as g, ChainFile(ref_path, "r") as r:
        for i in its:
            gt, rt = g.read_tod_state(i), r.read_tod_state(i)
            assert sorted(gt) == sorted(rt) and gt
            for band in rt:
                assert sorted(gt[band]) == sorted(rt[band]), band
                for k, v in rt[band].items():
                    if tol > 1e-8 and k in ("alpha", "fknee"):
                        continue
                    x = np.asarray(gt[band][k], np.float64)
                    y = np.asarray(v, np.float64)
                    assert x.shape == y.shape, (i, band, k)
                    assert np.all(np.abs(x - y) <= tol * np.maximum(
                        1.0, np.abs(y).max())), (i, band, k)


def _near(g, r, tol):
    """A sample to tol: alms of their max, D_l, indices, amplitudes and
    chi^2 in units of max(1, |value|), CG iterations within 10%."""
    for name, c in r["comps"].items():
        assert _rel(g["comps"][name]["alm"], c["alm"]) <= tol, name
        for k in ("Dl", "specind"):
            assert np.all(np.abs(g["comps"][name][k] - c[k]) <= tol
                          * np.maximum(1.0, np.abs(c[k]))), (name, k)
    for k in ("ptsrc_amps", "chisq"):
        a, b = np.asarray(g["aux"][k]), np.asarray(r["aux"][k])
        assert np.all(np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b))), k
    assert abs(int(g["aux"]["cg_iters"]) - int(r["aux"]["cg_iters"])) \
        <= 0.1 * int(r["aux"]["cg_iters"])


@pytest.mark.parametrize("name", list(CASES))
def test_host_loop_tod_chain_matches_run(tmp_path, name):
    """Samples 1-2 and, after a resume from the JAX chain's sample 1,
    samples 2-3 with their TOD states as run() writes them (1e-8), the
    accept / reject sequence, the bandpass and index-step acceptances, the
    4D maps; attempt 1's bandpass moves take the fast form."""
    out, seen = _runs(tmp_path, name)
    kw, over = CASES[name]
    for tag, its in (("", (1, 2)), ("3", (2, 3))):
        got = _samples(out["port" + tag].chain_path)
        ref = _samples(out["jax" + tag])
        assert sorted(got) == sorted(ref)
        if name == "scalar_mixed":
            for i in its:
                _near(got[i], ref[i], MIXED)
        else:
            _same_samples(got, ref, its)
        for i in its:
            assert np.abs(got[i]["aux"]["bp_delta"]
                          - ref[i]["aux"]["bp_delta"]).max() <= 1e-6
            for c, r in ref[i]["comps"].items():
                for k in r:
                    if k.startswith("theta_map"):
                        assert _rel(got[i]["comps"][c][k], r[k]) <= THETA
        _same_tod(out["port" + tag].chain_path, out["jax" + tag], its,
                  MIXED if name == "scalar_mixed" else 1e-8)
        seq = [r["ok"] for r in out["port" + tag].records]
        assert seq == _status(os.path.dirname(out["jax" + tag]))
    recs = out["port"].records + out["port3"].records
    bp = [r["accepted"] for rec in recs for r in rec["bp"].values()]
    forms = [r["form"] for r in recs[0]["bp"].values()]
    assert bp == seen["jax_bp"] and len(bp) >= 4
    assert seen["port"] == seen["jax"] and len(seen["jax"]) >= 4
    assert forms and set(forms) == {"fast"}
    if name == "pixind_bp_4d":
        assert {r["form"] for r in recs[1]["bp"].values()} == {"general"}
        for it in (1, 2):
            f = f"tod_4D_030_k{it:06d}.h5"
            with h5py.File(tmp_path / "port" / f, "r") as g, \
                    h5py.File(tmp_path / "jax" / f, "r") as r:
                assert sorted(g) == sorted(r) == ["det0", "det1"]
                for det in r:
                    for k in ("signal", "weight", "mean"):
                        assert _rel(g[det][k][()], r[det][k][()]) <= 1e-8
    else:
        assert out["port"].bands[2] is None
        assert out["port"].model.meta["nmaps"] == 1
        # T only, every block is usable: the monopoles move, zero-sum
        mono = out["port3"].bands[0].mono
        assert bool(torch.all(mono != 0)) and abs(float(mono.sum())) <= 1e-10
