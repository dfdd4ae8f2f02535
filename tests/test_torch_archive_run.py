"""run()'s host TOD loop from archives, float64 on the CPU: the port's chain
against commander_tpu.run.run(tod=True, dtype="float64") at nside 16 / lmax
32 (param_tutorial_full.txt --pol, cmb, synch and dust at scalar theta;
band 030 from its archives, bands 044 and 070 at map level), one
iteration, with run()'s draws replayed attempt by attempt.

Both packages read the same files, written by the port
(torch_tools/archives.py) from the TOD the synthetic command simulates
(32 scans x 2 detectors x 4096 samples, in two archive files, the
simulator's flagged samples on flag bit 1): BAND_TOD_FILELIST001 with
BAND_TOD_FLAG001 = 1, BAND_TOD_RIMO001 (sidelobe beams at lmax 12 with 2
beam modes, injected into the TOD from the band's true sky, and per-
detector bandpasses shifted by -1.5% and +1.5%, each detector's TOD
holding the sky of its bandpass offset by -0.15 and +0.15 GHz),
TOD_INCLUDE_ZODI (the zodi
template from the archives' satpos, injected too) and
BAND_SAMP_BANDPASS001: the sky-free pass that replaces band 030's map, the
warm start, then the iteration's pass on the detectors' skies, the
per-detector bandpass move and the band-level one. Here the port runs
run()'s form of the first pass (loop._REFERENCE_FORM; the port's own runs
on the band's input map, tests/test_torch_archive_run_maps.py). The
archives' orbital dipole is DIPOLE = 30 times the simulated one (the
satellite's velocity, in the TOD and in vsun): run()'s sky-free first pass
(_init_band_maps_from_tod) anchors the gain on the orbital dipole alone,
and on this sky at the simulated dipole its gains come out at -2.4 to 1.0,
its map reaches 5e33 and the chain diverges in both packages (run() to
NaN, the port to gains of 1e15; ROADMAP queue 3 item 25).

run()'s keys beyond test_torch_host_loop_tod.py's: the sky-free pass under
fold_in(key, 733), one split per archive band, with the band's draws at
sample_mono off; per attempt, after a band's pass split, one more split of
tkey into sample_bp_det's key, split in three per proposal (the normal of
the detectors' move and the accept uniform). Held to
test_torch_host_loop_sidelobes.py's bounds: the sample and the band's TOD
state (bp_delta_det included) to 1e-8, bp_delta to 1e-6, the accept /
reject sequence and the bandpass acceptances equal; both packages must have
evaluated the sidelobe term and the per-detector move (counted calls).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu.sampling import mh as jmh
from commander_tpu.tod import bandpass_mh as jbmh
from commander_tpu.tod import conviqt as JC
from commander_tpu.tod import process as JP
from commander_tpu_torch.driver import loop
from commander_tpu_torch.sampling import chisq as tchisq
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.tod import bandpass_mh as tbmh
from commander_tpu_torch.tod import process as TP
import test_torch_host_loop_tod as hlt
from test_torch_driver import (_cfgs, _port_model, _rel, _samples, _status,
                               _truth, step_draws, tod_draws_row)
from test_torch_host_loop_specind import specind_draws

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "torch_tools"))
import archives  # noqa: E402

torch.set_num_threads(2)

NSIDE, LMAX = 16, 32
SL = (12, 2)
# the sidelobe file's TOD size and components (its docstring: at 8 x 2048
# two float64 solvers part at 4e-5 of the alms)
OVER = ("--SYNTH_TOD_NSCAN=32", "--SYNTH_TOD_NTOD=4096", "--SYNTH_TOD_NDET=2",
        "--BAND_SAMP_BANDPASS001=.true.", "--BAND_TOD_TYPE002=none",
        "--BAND_TOD_TYPE003=none", "--INCLUDE_COMP04=.false.",
        "--INCLUDE_COMP05=.false.", "--INCLUDE_COMP06=.false.",
        "--INCLUDE_COMP07=.false.", "--INCLUDE_COMP08=.false.")
# the archives' orbital dipole, in units of the simulated one (module
# docstring)
DIPOLE = 30.0
T = torch.as_tensor


def replay(jcfg, tcfg, model, archive=(0,)):
    """draws(attempt, bands, npasses) of the port's host loop from
    archives: run()'s own (module docstring)."""
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.base_seed), 1)
    state_key = key
    skey = jax.random.fold_in(key, 552)
    tkey = jax.random.fold_in(key, 991)
    S = model.meta["nmaps"]
    made = {}

    def draws(attempt, bands=None, npasses=0):
        nonlocal state_key, skey, tkey
        if attempt in made:
            return made[attempt]
        if attempt == -1:
            rows = [b._replace(cfg=dataclasses.replace(b.cfg,
                                                       sample_mono=False))
                    if i in archive else None for i, b in enumerate(bands)]
            _, row = tod_draws_row(jax.random.fold_in(key, 733), rows)
            made[-1] = {"tod": row}
            return made[-1]
        d, state_key = step_draws(state_key, model)
        if attempt == 0:
            k, d["tod"] = jax.random.fold_in(key, 772), []
            for _ in range(npasses):
                k, row = tod_draws_row(k, bands)
                d["tod"].append(row)
            return d
        d["tod"], d["bp"], d["bp_det"] = [], [], []
        for b, band in enumerate(bands):
            if band is None:
                d["tod"].append(None)
                d["bp"].append(None)
                d["bp_det"].append(None)
                continue
            tkey, row = tod_draws_row(tkey, [band])
            d["tod"].append(row[0])
            det = None
            if jcfg.bands[b].sample_bandpass and band.det_bps is not None:
                tkey, kd = jax.random.split(tkey)
                det = []
                for _ in range(max(1, tcfg.tod_num_bp_prop)):
                    kd, k1, k2 = jax.random.split(kd, 3)
                    det.append({"eta": T(np.asarray(jax.random.normal(
                        k1, (band.block.ndet,), jnp.float64))),
                        "u": T(np.asarray(jax.random.uniform(
                            k2, (), jnp.float64)))})
            d["bp_det"].append(det)
            bp = None
            if jcfg.bands[b].sample_bandpass:
                tkey, kp, ka = jax.random.split(tkey, 3)
                bp = {"z": float(jax.random.normal(kp, (), jnp.float64)),
                      "u": T(np.asarray(jax.random.uniform(
                          ka, (), jnp.float64)))}
            d["bp"].append(bp)
        d["specind"], skey = specind_draws(skey, tcfg, model.pcfgs, NSIDE,
                                           LMAX, False, S)
        made[attempt] = d
        return d

    return draws


def _on_maps(j_init):
    """run()'s _init_band_maps_from_tod with its pass (the JAX process_tod)
    given the band's input map, sys.data's rows of band 0, in place of the
    zero sky: the reference's own pass on the port's form of the first
    pass."""
    def init(cfg, sys_, tod_blocks, nside, key):
        real = JP.process_tod

        def on_maps(tcfg0, block, tstate, sky, *a):
            return real(tcfg0, block, tstate,
                        sys_.data[0, :sky.shape[0]].astype(sky.dtype), *a)
        JP.process_tod = on_maps
        try:
            return j_init(cfg, sys_, tod_blocks, nside, key)
        finally:
            JP.process_tod = real
    return init


def _runs(root, dipole=DIPOLE, reference=True):
    """Both chains from the same archives (the orbital dipole at dipole
    times the simulated one); reference: the port in run()'s form of the
    first pass, else in its own with run()'s pass given the input map
    (_on_maps). Returns (run()'s chain path, the port's RunResult, the
    counted calls)."""
    jcfg, tcfg = _cfgs(*OVER)
    _, truth = _truth(jcfg, NSIDE, LMAX)
    model = _port_model(tcfg, truth, NSIDE, LMAX)
    arch = archives.write_archives(tcfg, model, str(root / "arch"), sl=SL,
                                   zodi=True, det_bp=True, nfiles=2,
                                   dipole=dipole)
    assert sorted(arch["bands"]) == [0]
    jcfg, tcfg = _cfgs(*OVER, *arch["overrides"])
    for b in (1, 2):
        jcfg.bands[b] = dataclasses.replace(jcfg.bands[b], tod_type="none")
    seen = {"jax_bp": [], "jax_sl": 0, "port_sl": 0, "jax_det": [],
            "port_det": 0, "port_det_sky": []}
    j_acc, j_det = jmh.accept_bandpass_tod, jbmh.sample_bp_det
    j_interp, t_interp = JC.conviqt_interp, TP.conviqt_interp_dets
    t_det, t_sky = tbmh.sample_bp_det, loop.det_sky

    def j_acc_spy(*a, **k):
        out = j_acc(*a, **k)
        seen["jax_bp"].append(bool(out[1]))
        return out

    def j_det_spy(*a, **k):
        out = j_det(*a, **k)
        seen["jax_det"].append(int(out[2]))
        return out

    def j_interp_spy(*a, **k):
        seen["jax_sl"] += 1
        return j_interp(*a, **k)

    def t_interp_spy(*a, **k):
        seen["port_sl"] += 1
        return t_interp(*a, **k)

    def t_det_spy(*a, **k):
        seen["port_det"] += 1
        return t_det(*a, **k)

    def t_sky_spy(*a, **k):
        out = t_sky(*a, **k)
        seen["port_det_sky"].append(tuple(out.shape))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmh, "accept_bandpass_tod", j_acc_spy)
        mp.setattr(jbmh, "sample_bp_det", j_det_spy)
        mp.setattr(JC, "conviqt_interp", j_interp_spy)
        mp.setattr(TP, "conviqt_interp_dets", t_interp_spy)
        mp.setattr(tbmh, "sample_bp_det", t_det_spy)
        mp.setattr(loop, "det_sky", t_sky_spy)
        mp.setattr(tchisq, "_REFERENCE_FORM", True)
        mp.setattr(tfg, "_amp_synth", tsht.alm2map)
        mp.setattr(loop, "_REFERENCE_FORM", reference)
        if not reference:
            mp.setattr(jrun, "_init_band_maps_from_tod",
                       _on_maps(jrun._init_band_maps_from_tod))
        _, jpath = jrun.run(jcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                            niter=1, outdir=str(root / "jax"),
                            dtype="float64", verbose=False, pol=True,
                            tod=True)
        port = loop.run(tcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                        niter=1, outdir=str(root / "port"),
                        dtype=torch.float64, verbose=False, pol=True,
                        tod=True, device="cpu", a_true=truth,
                        draws=replay(jcfg, tcfg, model))
    return jpath, port, seen


def test_run_from_archives_matches_run(tmp_path):
    hold(tmp_path, *_runs(tmp_path))


def hold(tmp_path, jpath, port, seen):
    """The port's chain held to run()'s (module docstring)."""
    band = port.bands[0]
    assert band.has_templates and band.sl_pix is not None
    assert band.zodi is not None and len(band.det_bps) == 2
    assert band.dets == ("030-0", "030-1")
    assert port.bands[1] is None and port.bands[2] is None
    # the terms in the passes, the detectors' skies and the per-detector
    # move were evaluated in both packages
    assert seen["port_sl"] >= 3 and seen["jax_sl"] > 0
    assert (2, 3, 12 * NSIDE ** 2) in seen["port_det_sky"]
    assert seen["port_det"] == len(seen["jax_det"]) == 1
    got, ref = _samples(port.chain_path), _samples(jpath)
    assert sorted(got) == sorted(ref) == [1]
    g, r = got[1], ref[1]
    assert set(g["comps"]) == set(r["comps"]) == {"cmb", "synch", "dust"}
    for name, c in r["comps"].items():
        assert _rel(g["comps"][name]["alm"], c["alm"]) <= 1e-8, name
        for k in ("Dl", "specind"):
            assert np.all(np.abs(g["comps"][name][k] - c[k]) <= 1e-8
                          * np.maximum(1.0, np.abs(c[k]))), (name, k)
    assert abs(g["aux"]["chisq"] - r["aux"]["chisq"]) <= 1e-8 * abs(
        r["aux"]["chisq"])
    assert int(g["aux"]["cg_iters"]) == int(r["aux"]["cg_iters"])
    assert np.abs(g["aux"]["bp_delta"] - r["aux"]["bp_delta"]).max() <= 1e-6
    # the band's TOD state, monopoles, bandpass shift and bp_delta_det
    hlt._same_tod(port.chain_path, jpath, (1,))
    assert [x["ok"] for x in port.records] == _status(str(tmp_path / "jax"))
    bp = [x["accepted"] for rec in port.records for x in rec["bp"].values()]
    assert bp == seen["jax_bp"] and len(bp) >= 1
    det = [x["accepted"] for rec in port.records
           for x in rec["bp_det"].values()]
    assert det == seen["jax_det"]
