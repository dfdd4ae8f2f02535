"""The TE-prior host loop on the file's whole model (ff and AME kept), a
case apart from tests/test_torch_host_loop_run.py's 1e-8 parity groups:
there the five components on three bands make the joint CG amplify
rounding ~1e8 (ROADMAP queue 3 item 10d), so the port is held to run()'s
own spread under a 1e-12 move of its data, float64 on the CPU at nside 8 /
lmax 16. One case, so that xdist deals the file after
tests/test_sharding.py (ROADMAP "Tier-1 verify").
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu_torch.driver import loop
from commander_tpu_torch.sampling import chisq as tchisq
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sphere import sht as tsht
from test_torch_driver import _cfgs, _port_model, _samples, _status, _truth
from test_torch_host_loop_run import GROUPS, LMAX, NSIDE, host_replay

torch.set_num_threads(2)


def _alm_spread(a, b, i):
    """max over components of |alm_a - alm_b| / max |alm_b| at sample i."""
    return max(float(np.abs(a[i]["comps"][c]["alm"] - b[i]["comps"][c]["alm"])
                     .max() / np.abs(b[i]["comps"][c]["alm"]).max())
               for c in b[i]["comps"])


def test_te_prior_whole_model_within_run_s_own_spread(tmp_path):
    """The pixind_te_resample group on the file's whole model (ff and ame
    kept), 2 iterations. run() against itself with its data moved by 1e-12
    of themselves: sample 1 agrees to 1e-9, sample 2 parts by 1e-5 of the
    alms or more (the joint CG under the TE prior amplifies rounding ~1e8,
    ROADMAP queue 3 item 10d). The port's chain with run()'s draws: sample
    1 to 1e-8 of run()'s, sample 2 no farther from run()'s than 10 times
    run()'s own parting, and the same accept / reject sequence."""
    _, over = GROUPS["pixind_te_resample"]
    over = [o for o in over if not o.startswith("--INCLUDE_COMP")]
    jcfg, tcfg = _cfgs(*over)
    _, truth = _truth(jcfg, NSIDE, LMAX)
    model = _port_model(tcfg, truth, NSIDE, LMAX)
    real = jrun.build_model

    def moved(*a, **k):
        out = list(real(*a, **k))
        out[1] = dataclasses.replace(out[1], data=out[1].data * (1 + 1e-12))
        return tuple(out)

    paths = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tchisq, "_REFERENCE_FORM", True)
        mp.setattr(tfg, "_amp_synth", tsht.alm2map)
        for tag in ("jax", "jax_moved"):
            mp.setattr(jrun, "build_model", moved if tag == "jax_moved"
                       else real)
            _, paths[tag] = jrun.run(
                jcfg, nside=NSIDE, lmax=LMAX, synthetic=True, niter=2,
                outdir=str(tmp_path / tag), dtype="float64", verbose=False,
                pol=True, pixind=True, te_cl=True)
        port = loop.run(
            tcfg, nside=NSIDE, lmax=LMAX, synthetic=True, niter=2,
            outdir=str(tmp_path / "port"), dtype=torch.float64,
            verbose=False, pol=True, device="cpu", a_true=truth,
            draws=host_replay(jcfg, tcfg, model, True, True), pixind=True,
            te_cl=True)
    ref, ref_moved = _samples(paths["jax"]), _samples(paths["jax_moved"])
    got = _samples(port.chain_path)
    assert len(ref[1]["comps"]) == 5
    own = _alm_spread(ref_moved, ref, 2)
    assert _alm_spread(ref_moved, ref, 1) <= 1e-9
    assert own >= 1e-5
    assert _alm_spread(got, ref, 1) <= 1e-8
    assert _alm_spread(got, ref, 2) <= 10 * own
    assert [r["ok"] for r in port.records] == _status(
        os.path.dirname(paths["jax"]))
