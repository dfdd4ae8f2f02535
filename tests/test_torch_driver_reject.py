"""The reject rule of the port's program (commander_tpu_torch.driver.loop:
run()'s per-sample reject, run.py:2440-2456, commander.f90:229-251)
against the JAX driver's, float64 on the CPU, at nside 8 / lmax 16
(param_tutorial_full.txt --synthetic --pol), with run()'s draws replayed
(test_torch_driver.replay). Two cases: kept apart from
test_torch_driver.py so that the file's two JAX runs per case are dealt
beside tests/test_sharding.py (ROADMAP "Tier-1 verify").

Tolerances: the same accepted and rejected attempts, in the same order;
the chain samples and gains as test_torch_driver.py holds them (1e-8).
"""
import os

import numpy as np
import pytest
import torch

from test_torch_driver import (_cfgs, _jax_run, _port_model, _port_run,
                               _same_samples, _samples, _status, _truth)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rejects(tmp_path_factory):
    """At nside 8 / lmax 16 with CG_MAXITER 2 the CG stops with relres
    5.305e-7 .. 5.331e-7 (the sequence of attempts does not depend on the
    tolerance: a rejected draw is still the next state); CG_TOLERANCE
    5.314e-7 rejects some. Band 044 samples its gain (GLS). Both drivers
    run 4 iterations; then 2 with CG_CONVERGENCE_CRITERION fixed_iter and
    every band's gain: 030 on a calibration mask apodized by 300', 070 by
    the cross-C_l estimator."""
    from commander_tpu.io import fits as jfits

    root = tmp_path_factory.mktemp("rejects")
    mask = np.ones((1, 12 * 8 * 8))
    mask[0, :200] = 0.0
    jfits.write_map(str(root / "calib.fits"), mask)
    out = {}
    base = ("--CG_MAXITER=2", "--CG_TOLERANCE=5.314e-7",
            "--BAND_SAMP_GAIN002=.true.")
    # fixed_iter: also band 030's gain on an apodized calibration mask,
    # and band 070's by the cross-C_l estimator over l 2..12
    gains = ("--BAND_SAMP_GAIN001=.true.",
             f"--BAND_MASKFILE_CALIB001={root / 'calib.fits'}",
             "--BAND_GAIN_APOD_FWHM001=300", "--BAND_SAMP_GAIN003=.true.",
             "--BAND_GAIN_LMIN003=2", "--BAND_GAIN_LMAX003=12")
    for name, extra, niter in (("residual", (), 4),
                               ("fixed_iter", (
                                   "--CG_CONVERGENCE_CRITERION=fixed_iter",)
                                + gains, 2)):
        jcfg, tcfg = _cfgs(*base, *extra)
        _, truth = _truth(jcfg, 8, 16)
        model = _port_model(tcfg, truth, 8, 16)
        jpath = _jax_run(jcfg, root / f"jax_{name}", niter, nside=8, lmax=16)
        tres = _port_run(tcfg, jcfg, model, root / f"port_{name}", niter,
                         truth, nside=8, lmax=16)
        out[name] = (jpath, tres)
    return out


@pytest.mark.parametrize("crit", ["residual", "fixed_iter"])
def test_reject_rule_matches(rejects, crit):
    """The same accepted and rejected attempts as run.py:2440-2456, in
    order, and the same samples and gains; fixed_iter accepts all."""
    jpath, tres = rejects[crit]
    seq_j = _status(os.path.dirname(jpath))
    seq_t = [r["ok"] for r in tres.records]
    assert seq_t == seq_j == _status(os.path.dirname(tres.chain_path))
    if crit == "residual":
        assert not all(seq_t) and sum(seq_t) == 4
    else:
        assert seq_t == [True, True]
    got, ref = _samples(tres.chain_path), _samples(jpath)
    _same_samples(got, ref, sorted(ref))
    assert got[1]["gain"][1] != 1.0
    if crit == "fixed_iter":
        assert np.all(got[2]["gain"] != 1.0)
