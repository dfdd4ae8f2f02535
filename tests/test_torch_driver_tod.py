"""The port's --tod --f32 route (driver/loop.py: _tod_start, tod_phase and
the loop around them) against the JAX driver's, on the CPU.

The JAX side is commander_tpu.run.run(tod=True, dtype="float32") with its
deferred TOD route (fullgibbs="encoded", which the CPU needs to take it)
and OUTPUT_CHISQ_MAP on: run()'s own composition of that route
(run.py:2012-2021: gibbs_step on the map-level data, then 3 burn-in passes,
or 1 after a TOD state restored from the chain; per attempt the TOD pass on
the current model sky, scan rejection off on the first iteration, then the
fast path's full_gibbs_step). param_tutorial_full.txt --synthetic --pol at
nside 16 / lmax 32 with 8 scans x 2 detectors x 2048 samples per band; 2
iterations, then a resume to 3 from the JAX chain by both drivers. The port
gets run()'s draws (test_torch_driver.replay, the TOD passes included), the
index phase's spin-0 amplitude maps and the simulator's orbital dipole at 30
GHz, as run._setup_synthetic_tod makes it (two declared divergences,
ROADMAP queue 3).

The port runs twice, both with fullgibbs="encoded" as run() does: in
float32, the card's command-line route, and in float64 (the same code; the
port's "encoded" keeps this route in either dtype, where run() takes its
host loop in float64, held by tests/test_torch_host_loop_tod.py).
Tolerances (BOUNDS):
float32 from a float32-vs-float64 reading, the port's loop on this route
in both dtypes from the same draws: at most, over samples 1-2 of the fresh
chain, samples 2-3 of the resume and both warm starts, alms 0.28 of each
Stokes row's max (the T rows of synch and ame left free: their degenerate T
modes move by 1.2 of the max), chi^2 0.13, md amplitudes 0.029 and source
amplitudes 0.012 of their max, 1 CG iteration, TOD gains 0.033, sigma0
0.073, alpha 9, fknee 12 and the indices 6 grid steps: float32 rounding
alone parts these chains that far, and the port's float32 chain lies as far
from run()'s. The float64 run is the tight check of the glue: it lies within
alms 0.009, chi^2 7.3e-4, amplitudes 2e-4, TOD gains 3.4e-4, sigma0 0.02,
indices 0.04 grid steps of run()'s, the same CG iterations and alpha grid
steps, fknee within 7 of its 31 steps (its conditional is near flat at this
TOD length); its bounds are three times these.
"""
import os

import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu.sampling import gibbs as jgibbs
from commander_tpu_torch.driver import loop, model as tmodel
from commander_tpu_torch.driver.model import comp_to_diffuse, diffuse_configs
from commander_tpu_torch.io.chain import ChainFile
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import tod_gibbs
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.tod import sim as tsim
from test_torch_driver import NSIDE, LMAX, _cfgs, _rel, replay

torch.set_num_threads(2)

OVERRIDES = ("--SYNTH_TOD_NSCAN=8", "--SYNTH_TOD_NTOD=2048",
             "--SYNTH_TOD_NDET=2", "--OUTPUT_CHISQ_MAP=.true.")
ALPHA_STEP = 2.0 / 31
FKNEE_LOG_STEP = np.log(2.0 / 0.01) / 31
# the T rows the reading leaves free (their T modes are degenerate)
FREE_T = ("synch", "ame")


def _jax_run(jcfg, outdir, niter, rec, chain_from=None):
    """run() with its warm start recorded: the state of its gibbs_step and
    the TOD states after its burn-in."""
    real_step, real_burnin = jgibbs.gibbs_step, jrun._tod_burnin

    def step(*a, **k):
        st = real_step(*a, **k)
        rec.setdefault("state", st)
        return st

    def burnin(blocks, *a, **k):
        out = real_burnin(blocks, *a, **k)
        rec["tod"] = {b: blocks[b][2] for b in blocks}
        rec["npasses"] = k["npasses"]
        return out
    if chain_from:
        os.makedirs(outdir, exist_ok=True)
        with open(chain_from, "rb") as f, \
                open(os.path.join(outdir, "chain_c0001.h5"), "wb") as g:
            g.write(f.read())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgibbs, "gibbs_step", step)
        mp.setattr(jrun, "_tod_burnin", burnin)
        _, path = jrun.run(jcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                           niter=niter, outdir=str(outdir), dtype="float32",
                           verbose=False, pol=True, tod=True,
                           fullgibbs="encoded")
    return path


def _port_run(tcfg, jcfg, truth, outdir, niter, rec, dtype,
              chain_from=None, first=None):
    """The port's loop with run()'s draws and the warm start recorded, on
    run()'s deferred route (fullgibbs="encoded"), in float64 too: run()
    takes its host loop there, and this route's code is the float32
    one's."""
    real_sim, real_burnin = tsim.simulate_tod, tod_gibbs.tod_burnin

    def sim(*a, **k):
        # run._setup_synthetic_tod simulates the orbital dipole at the
        # simulator's default 30 GHz
        return real_sim(*a, **dict(k, nu=30e9))

    def burnin(*a, **k):
        bands, st = real_burnin(*a, **k)
        rec["state"], rec["tod"] = st, [b.state for b in bands]
        rec["npasses"] = k["npasses"]
        return bands, st
    model = tmodel.build_model(tcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                               dtype=dtype, pol=True, device="cpu",
                               a_true=truth)
    if chain_from:
        os.makedirs(outdir, exist_ok=True)
        with open(chain_from, "rb") as f, \
                open(os.path.join(outdir, "chain_c0001.h5"), "wb") as g:
            g.write(f.read())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfg, "_amp_synth", tsht.alm2map)
        mp.setattr(tod_gibbs, "simulate_tod", sim)
        mp.setattr(tod_gibbs, "tod_burnin", burnin)
        return loop.run(tcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                        niter=niter, outdir=str(outdir), dtype=dtype,
                        verbose=False, pol=True, tod=True, device="cpu",
                        draws=replay(jcfg, model, first=first),
                        a_true=truth, fullgibbs="encoded")


@pytest.fixture(scope="module")
def tod_chains(tmp_path_factory):
    """run()'s 2-iteration TOD chain and its resume to 3, and the port's in
    float32 and float64 from the same draws, with the warm starts
    recorded."""
    jcfg, tcfg = _cfgs(*OVERRIDES)
    out = jrun.build_model(jcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                           dtype="float32", pol=True)
    truth = out[7][0] + 1j * out[7][1]
    root = tmp_path_factory.mktemp("driver_tod")
    rec = {"jax": {}, "jax3": {}}
    paths = {"jax": _jax_run(jcfg, root / "jax", 2, rec["jax"])}
    paths["jax3"] = _jax_run(jcfg, root / "jax3", 3, rec["jax3"],
                             chain_from=paths["jax"])
    res = {}
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        rec[name], rec[name + "3"] = {}, {}
        res[name] = _port_run(tcfg, jcfg, truth, root / name, 2, rec[name],
                              dt)
        res[name + "3"] = _port_run(tcfg, jcfg, truth, root / (name + "3"),
                                    3, rec[name + "3"], dt,
                                    chain_from=paths["jax"], first=1)
    pc = diffuse_configs(tcfg)
    diffuse = [comp_to_diffuse(c) for c in pc]
    return dict(paths=paths, res=res, rec=rec, diffuse=diffuse,
                slots=tfg.make_index_slots(diffuse, pc))


def _read(path, its):
    with ChainFile(path, "r") as ch:
        return {i: (ch.read_sample(i), ch.read_tod_state(i)) for i in its}


def _tod_steps(a, b):
    """(gain, sigma0) relative to their max, (alpha, fknee) in grid steps:
    the worst over the bands of two {band: state} maps."""
    out = dict(gain=0.0, sigma0=0.0, alpha=0.0, fknee=0.0)
    for band in b:
        x, y = a[band], b[band]
        g = lambda k: (np.asarray(x[k], float), np.asarray(y[k], float))
        out["gain"] = max(out["gain"], _rel(*g("gain")))
        out["sigma0"] = max(out["sigma0"], _rel(*g("sigma0")))
        xa, ya = g("alpha")
        out["alpha"] = max(out["alpha"], np.abs(xa - ya).max() / ALPHA_STEP)
        xf, yf = g("fknee")
        out["fknee"] = max(out["fknee"], np.abs(np.log(xf / yf)).max()
                           / FKNEE_LOG_STEP)
    return out


def _sample_metrics(got, ref, slots, diffuse):
    """The worst departures of a sample from run()'s: alms relative to each
    Stokes row's max (FREE_T's T rows apart), chi^2, md and source
    amplitudes, CG iterations, the TOD state, the indices in grid steps."""
    (g, gt), (r, rt) = got, ref
    m = dict(alm=max(_rel(g["comps"][n]["alm"][s], r["comps"][n]["alm"][s])
                     for n in r["comps"] for s in range(3)
                     if not (s == 0 and n in FREE_T)))
    for k in ("chisq", "md_amps", "ptsrc_amps"):
        m[k] = _rel(np.asarray(g["aux"][k], float),
                    np.asarray(r["aux"][k], float))
    m["cg_iters"] = abs(int(g["aux"]["cg_iters"]) - int(r["aux"]["cg_iters"]))
    assert sorted(gt) == sorted(rt) == ["030", "044", "070"]
    m.update(_tod_steps(gt, rt))
    m["specind"] = max(
        abs(g["comps"][diffuse[s.ci].name]["specind"][s.which]
            - r["comps"][diffuse[s.ci].name]["specind"][s.which])
        / ((s.cfg.grid_max - s.cfg.grid_min) / (s.cfg.ngrid - 1))
        for s in slots)
    return m


# the bounds: float32 twice the float32-vs-float64 reading of the module
# docstring (over the fresh chain, the resume and both warm starts);
# float64 three times the departures first measured here (run()'s float32
# route keeps its data and state in float64, its plan, mixing matrix and
# noise in float32), alpha within one grid step
BOUNDS = {
    "float32": dict(alm=0.6, chisq=0.3, md_amps=0.06, ptsrc_amps=0.03,
                    cg_iters=2, gain=0.07, sigma0=0.15, alpha=18, fknee=24,
                    specind=12),
    "float64": dict(alm=0.03, chisq=3e-3, md_amps=1e-3, ptsrc_amps=1e-3,
                    cg_iters=0, gain=1e-3, sigma0=0.06, alpha=1.001,
                    fknee=21, specind=0.15),
}


def _hold(m, bounds, where):
    over = {k: v for k, v in m.items() if not v <= bounds[k]}
    assert not over, (where, over, m)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tod_chain_matches_the_jax_driver(tod_chains, dtype):
    """Samples 1 and 2 of the TOD chain with their TOD states against
    run()'s at the bounds of BOUNDS; every attempt accepted by both."""
    res = tod_chains["res"][dtype]
    assert [r["ok"] for r in res.records] == [True, True]
    got = _read(res.chain_path, (1, 2))
    ref = _read(tod_chains["paths"]["jax"], (1, 2))
    for it in (1, 2):
        _hold(_sample_metrics(got[it], ref[it], tod_chains["slots"],
                              tod_chains["diffuse"]), BOUNDS[dtype], it)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tod_warm_start_matches(tod_chains, dtype):
    """The warm start of a fresh chain (gibbs_step on the map-level data,
    then 3 burn-in passes on its sky) and of the resume (1 pass on the TOD
    state restored from the chain): the amplitudes (FREE_T's T rows apart),
    the template and source amplitudes and the TOD states at the bounds of
    BOUNDS."""
    rec = tod_chains["rec"]
    for j, t in (("jax", dtype), ("jax3", dtype + "3")):
        js, ts = rec[j]["state"], rec[t]["state"]
        a, b = ts.a.numpy(), np.asarray(js.a)
        names = [d.name for d in tod_chains["diffuse"]]
        m = dict(alm=max(_rel(a[c, s], b[c, s]) for c, n in enumerate(names)
                         for s in range(3) if not (s == 0 and n in FREE_T)),
                 md_amps=_rel(ts.t.numpy(), np.asarray(js.t)),
                 ptsrc_amps=_rel(ts.p.numpy(), np.asarray(js.p)))
        m.update(_tod_steps(
            {b_: {k: getattr(st, k).numpy() for k in ("gain", "sigma0",
                                                      "alpha", "fknee")}
             for b_, st in enumerate(rec[t]["tod"])},
            {b_: {k: np.asarray(getattr(st, k)) for k in (
                "gain", "sigma0", "alpha", "fknee")}
             for b_, st in rec[j]["tod"].items()}))
        _hold(m, BOUNDS[dtype], t)
        assert rec[j]["npasses"] == rec[t]["npasses"] == \
            (3 if j == "jax" else 1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tod_resume_from_a_jax_chain_matches(tod_chains, dtype):
    """Resume to 3 iterations from the JAX driver's 2-sample TOD chain: both
    drop sample 2, restore the TOD state of sample 1 and burn in one pass,
    and write samples 2 and 3 at the bounds of BOUNDS."""
    res = tod_chains["res"][dtype + "3"]
    assert [r["it"] for r in res.records] == [2, 3]
    assert all(r["ok"] for r in res.records)
    status = open(os.path.join(os.path.dirname(res.chain_path),
                               "comm_status.txt")).read()
    assert "chain-restored" in status
    got = _read(res.chain_path, (2, 3))
    ref = _read(tod_chains["paths"]["jax3"], (2, 3))
    for it in (2, 3):
        _hold(_sample_metrics(got[it], ref[it], tod_chains["slots"],
                              tod_chains["diffuse"]), BOUNDS[dtype], it)
