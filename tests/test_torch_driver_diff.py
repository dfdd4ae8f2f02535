"""A differential (WMAP) band beside LFI bands in the program's loop, on the
CPU: the port's chain against commander_tpu.run.run(tod=True) at nside 8 /
lmax 16 (param_tutorial_full.txt --synthetic --pol, BAND_TOD_TYPE003 =
WMAP, 8 scans x 2 detectors x 2048 samples per LFI band and 4 x 2 x 1024
for the differential one, run.py:751-759), with run()'s draws replayed
(test_torch_host_loop_tod.host_tod_replay: the differential pass's draws
through process_tod_diff's own splits).

A differential band takes run() off its deferred fast route in either
dtype (_accel_tod_ok asks every band to be LFI, run.py:1727-1733): its
warm start and every attempt run on the host loop (the band's pass at
run.py:2092-2093), and so do the port's. Two cases:

  host_f64   float64: 2 iterations, then a resume to 3 from the JAX chain
             (each band's TOD state restored, the differential one's too),
             against run()'s; held to SPREAD (below);
  f32_route  --f32 with fullgibbs="encoded" (the card's command-line
             route): the port takes the host loop, as run() does (the
             port records the host loop's index step), 2 iterations, each
             sample held against run()'s float64 chain to 3x the distance
             between the port's own float32 and float64 chains (below).

SPREAD: the differential mapmaker runs to maxiter at the simulated
imbalance 0.01 (its map's monopole on each set of connected pixel pairs is
fixed through 2 x_im T alone; tests/test_torch_differential.py), so
rounding moves that band's map, and the whole model's CG carries it on:
run() against itself with its TOD data moved by 1e-12 parts by 5.7e-4 of
the alms, chi^2, md and source amplitudes (the largest, each of its max)
over samples 1-2 and by 8.7e-4 over the resume's 2-3, its TOD gains and
sigma0 by 1.6e-6 and 9.3e-6 (measured at this size: `PYTHONPATH=.
python3 tests/test_torch_driver_diff.py`, measure_spread). SPREAD is 10x
the larger alms figure; TOD_SPREAD 10x the fresh chain's 1.6e-6, which the
resume meets too (the noise-PSD grid cells not held). The port runs in
run()'s forms of the declared divergences (the model sky at the
pixel-mean F, the index phase's spin-0 amplitude maps, the LFI orbital
dipoles at 30 GHz).

The float32 chains part by rounding alone, by a sizeable share of the
alms' max at sample 2 in both packages (the whole model's CG amplifies the
differential map's rounding), so f32_route holds each sample of the port's
float32 chain to run()'s float64 one within 3x the port's own
float32-vs-float64 distance, measured in the test (run()'s float32 run is
not repeated here).
"""
import os
import shutil

import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu_torch.driver import loop
from commander_tpu_torch.sampling import chisq as tchisq
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import tod_gibbs
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.tod import sim as tsim
from test_torch_driver import _cfgs, _port_model, _rel, _samples, _status, \
    _truth
from test_torch_host_loop_tod import _same_tod, host_tod_replay

torch.set_num_threads(2)

NSIDE, LMAX = 8, 16
OVER = ("--SYNTH_TOD_NSCAN=8", "--SYNTH_TOD_NTOD=2048",
        "--SYNTH_TOD_NDET=2", "--BAND_TOD_TYPE003=WMAP")
# 10x run()'s own spread (module docstring)
SPREAD = 8.7e-3
TOD_SPREAD = 1.6e-5


def _jax(jcfg, outdir, niter, dtype, chain_from=None, **kw):
    if chain_from:
        os.makedirs(outdir)
        shutil.copy(chain_from, outdir / "chain_c0001.h5")
    _, path = jrun.run(jcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                       niter=niter, outdir=str(outdir), dtype=dtype,
                       verbose=False, pol=True, tod=True, **kw)
    return path


def _port(tcfg, jcfg, model, truth, outdir, niter, dtype, first=None, **kw):
    real_sim = tsim.simulate_tod

    def sim(*a, **k):
        # run._setup_synthetic_tod simulates every LFI dipole at 30 GHz
        return real_sim(*a, **dict(k, nu=30e9))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tchisq, "_REFERENCE_FORM", True)
        mp.setattr(tfg, "_amp_synth", tsht.alm2map)
        mp.setattr(tod_gibbs, "simulate_tod", sim)
        return loop.run(tcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                        niter=niter, outdir=str(outdir), dtype=dtype,
                        verbose=False, pol=True, tod=True, device="cpu",
                        a_true=truth, draws=host_tod_replay(
                            jcfg, tcfg, model, False, first=first), **kw)


def _dist(got, ref, its):
    """The largest departure over samples its of the alms, chi^2, md and
    source amplitudes, each relative to its max."""
    d = 0.0
    for i in its:
        g, r = got[i], ref[i]
        for name, c in r["comps"].items():
            d = max(d, _rel(g["comps"][name]["alm"], c["alm"]))
        for k in ("chisq", "md_amps", "ptsrc_amps"):
            d = max(d, _rel(g["aux"][k], r["aux"][k]))
    return d


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    """The configurations, the truth, the port's model and run()'s float64
    2-iteration chain, shared by both cases."""
    jcfg, tcfg = _cfgs(*OVER)
    _, truth = _truth(jcfg, NSIDE, LMAX)
    model = _port_model(tcfg, truth, NSIDE, LMAX)
    root = tmp_path_factory.mktemp("diff")
    return dict(jcfg=jcfg, tcfg=tcfg, truth=truth, model=model,
                path=_jax(jcfg, root / "jax", 2, "float64"),
                port=_port(tcfg, jcfg, model, truth, root / "port", 2,
                           torch.float64))


@pytest.mark.parametrize("case", ["host_f64", "f32_route"])
def test_differential_band_chain_matches_run(tmp_path, jax64, case):
    """The chain with a differential band beside two LFI bands against
    run()'s (module docstring: the route, the bounds); every TOD band's
    state as run() writes it, the differential one's from its half-size
    block; the accept / reject sequence."""
    jcfg, tcfg = jax64["jcfg"], jax64["tcfg"]
    truth, model, jpath = jax64["truth"], jax64["model"], jax64["path"]
    if case == "host_f64":
        res = jax64["port"]
        j3 = _jax(jcfg, tmp_path / "jax3", 3, "float64", chain_from=jpath)
        os.makedirs(tmp_path / "port3")
        shutil.copy(jpath, tmp_path / "port3" / "chain_c0001.h5")
        res3 = _port(tcfg, jcfg, model, truth, tmp_path / "port3", 3,
                     torch.float64, first=1)
        assert res.bands[2].kind == "diff" and res.bands[0].kind == "lfi"
        assert res.bands[2].block.tod.shape == (4, 2, 1024)
        assert res.host is not None and res3.warm["npasses"] == 1
        for r, path, its in ((res, jpath, (1, 2)), (res3, j3, (2, 3))):
            got, ref = _samples(r.chain_path), _samples(path)
            assert sorted(got) == sorted(ref)
            assert _dist(got, ref, its) <= SPREAD
            for i in its:
                assert int(got[i]["aux"]["cg_iters"]) \
                    == int(ref[i]["aux"]["cg_iters"])
            _same_tod(r.chain_path, path, its, TOD_SPREAD)
            assert [x["ok"] for x in r.records] \
                == _status(os.path.dirname(path))
        return
    res = _port(tcfg, jcfg, model, truth, tmp_path / "port32", 2,
                torch.float32, fullgibbs="encoded")
    # the host loop, as run() takes it: its index step records each
    # parameter's branch
    assert res.host is not None and all("specind" in r for r in res.records)
    assert res.bands[2].block.tod.dtype == torch.float32
    got, ref = _samples(res.chain_path), _samples(jpath)
    own = _samples(jax64["port"].chain_path)
    for i in (1, 2):
        reading = _dist(got, own, (i,))
        assert 1e-4 < reading < 1.0
        assert _dist(got, ref, (i,)) <= 3 * reading
    assert all(x["ok"] for x in res.records)


def _tod_dist(got_path, ref_path, its):
    """The largest departure of the TOD gains and sigma0 over samples its,
    each of max(1, its max)."""
    from commander_tpu_torch.io.chain import ChainFile

    d = 0.0
    with ChainFile(got_path, "r") as g, ChainFile(ref_path, "r") as r:
        for i in its:
            gt, rt = g.read_tod_state(i), r.read_tod_state(i)
            for band, st in rt.items():
                for k in ("gain", "sigma0"):
                    y = st[k]
                    d = max(d, float(abs(gt[band][k] - y).max()
                                     / max(1.0, abs(y).max())))
    return d


def measure_spread(root):
    """run()'s own spread here (module docstring): its float64 chain (2
    iterations, and a resume to 3) against the same with its TOD data
    moved by 1e-12. Prints the departures _dist and _tod_dist read."""
    import dataclasses

    jcfg, _ = _cfgs(*OVER)
    real = jrun._setup_synthetic_tod

    def moved(*a, **k):
        return {b: (v[0], dataclasses.replace(
            v[1], tod=v[1].tod * (1.0 + 1e-12)), *v[2:])
            for b, v in real(*a, **k).items()}

    paths = {}
    try:
        for tag, fn in (("ref", real), ("moved", moved)):
            jrun._setup_synthetic_tod = fn
            p = _jax(jcfg, root / tag, 2, "float64")
            paths[tag] = (p, _jax(jcfg, root / (tag + "3"), 3, "float64",
                                  chain_from=p))
    finally:
        jrun._setup_synthetic_tod = real
    for k, its in ((0, (1, 2)), (1, (2, 3))):
        g, r = paths["moved"][k], paths["ref"][k]
        print(f"samples {its}: alms / chi^2 / amplitudes "
              f"{_dist(_samples(g), _samples(r), its):.3g}, TOD gains and "
              f"sigma0 {_tod_dist(g, r, its):.3g}")


if __name__ == "__main__":
    # PYTHONPATH=. python3 tests/test_torch_driver_diff.py: the spread
    # behind SPREAD and TOD_SPREAD (float64 on the CPU, about two minutes)
    import pathlib
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    measure_spread(pathlib.Path(tempfile.mkdtemp()))
