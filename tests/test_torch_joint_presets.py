"""The joint presets (entry.entry_joint, entry.tutorial_joint: the whole
8-component model of param_tutorial_full.txt from TOD) at nside 8 / lmax 16
on the CPU: their index slots against the JAX package's make_index_slots
on the components and index configs the JAX parameter parser reads from the
file, their rows against run.build_model's recipe, and a warm start and two
tod_gibbs_steps of entry_joint with the rows.
"""
import os

import numpy as np
import pytest
import torch

from commander_tpu.io.params import Params, lower_params
from commander_tpu.model.mixing import DiffuseComponent as JComp
from commander_tpu.sampling import tpu_gibbs
from commander_tpu_torch import entry
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import tod_gibbs
from test_torch_full_gibbs import _asdict

# small shapes: one torch thread, so that test workers sharing the cores
# do not oversubscribe them
torch.set_num_threads(1)

NSIDE, LMAX = 8, 16
TOD = dict(entry.TOD_NOISE, nscan=6, ndet=2, ntod=2048)


@pytest.fixture(scope="module")
def presets():
    return {p: entry.build_preset(p, torch.float64, "cpu", nside=NSIDE,
                                  lmax=LMAX, tod=TOD)
            for p in ("entry_joint", "tutorial_joint")}


def test_slots_are_the_files(presets):
    """make_index_slots(comps, pcfgs) of the JAX package, with the index
    configs lower_params reads from param_tutorial_full.txt: five slots,
    the same components, parameters, ranges and priors."""
    cfg = lower_params(Params.load(os.path.join(
        os.path.dirname(__file__), "..", "param_tutorial_full.txt")))
    pcfgs = [c for c in cfg.comps if c.cclass == "diffuse" and c.ctype
             not in ("md", "cmb_relquad", "template")]
    for pb in presets.values():
        assert [c.name for c in pb.comps] == [c.label for c in pcfgs]
        comps_j = [JComp(**_asdict(c)) for c in pb.comps]
        ref = tpu_gibbs.make_index_slots(comps_j, pcfgs)
        assert len(pb.slots) == len(ref) == 5
        for got, want in zip(pb.slots, ref):
            assert (got.ci, got.which) == (want.ci, want.which)
            assert _asdict(got.cfg) == _asdict(want.cfg)


def test_rows_follow_the_recipe(presets):
    """12 md rows (prior 0 +- 100) and a relquad row pinned at 1 (inverse
    std 1e6) on the bands' T planes, 20 sources on min(32, npix / 4)
    pixels with stamps of FWHM max(beam, 60') and SED (nu / 30 GHz)^-2.5,
    amplitudes 50 + 50 |N(0, 1)|; the simulated sky carries relquad at 1
    and the sources."""
    for name, pb in presets.items():
        ts, ps = pb.ts, pb.ps
        assert ts.ntemp == 13 and ts.planes.shape == (15, 12 * NSIDE ** 2)
        assert np.array_equal(ts.prior_istd.numpy(),
                              np.r_[np.full(12, 0.01), 1e6])
        assert ts.prior_mean.tolist() == [0.0] * 12 + [1.0]
        assert (ts.slots % 3 == 0).all()              # T planes only
        assert ps.pix.shape == (20, 32) and ps.stamp.shape[:2] == (3, 3)
        assert not bool(ps.stamp[:, 1:].any())
        assert bool((pb.p_true >= 50.0).all())
        assert pb.t_true.tolist() == [0.0] * 12 + [1.0]
        sums = ps.stamp[:, 0].sum(dim=-1)             # (B, nsrc)
        nu = torch.tensor([bp.nu_c for bp in pb.bps], dtype=torch.float64)
        ratio = (sums / sums[0]).numpy()
        want = ((nu / nu[0]) ** -2.5).numpy()[:, None]
        assert np.abs(ratio - want).max() <= 1e-12
        assert entry.PRESETS[name]["joint"]
    tj = entry.PRESETS["tutorial_joint"]
    assert (tj["nside"], tj["lmax"], tj["cg_tol"], tj["cg_maxiter"]) == (
        1024, 2000, 1e-6, 400)
    assert (tj["tod"]["nscan"], tj["tod"]["ndet"], tj["tod"]["ntod"]) == (
        96, 4, 131072)


def test_entry_joint_warm_start_and_steps(presets):
    """A warm start (one amplitude step, one TOD pass on the full model sky)
    and two tod_gibbs_steps: finite, the relquad amplitude at its pin, the
    state carrying t and p, the binned maps replacing the data."""
    pb = presets["entry_joint"]
    gen = torch.Generator()
    gen.manual_seed(0)
    sys0 = tfg.system_at(pb.sys, pb.comps, pb.bps, pb.slots, pb.thetas0)
    st = entry.prior_state(pb.cfg, pb.sys, pb.ts, pb.ps)
    assert st.t.shape == (13,) and st.p.shape == (20,)
    bands, st = tod_gibbs.tod_burnin(pb.cfg, pb.bands, sys0, pb.plan, st, gen,
                                     npasses=1, ts=pb.ts, ps=pb.ps)
    base, th = pb.sys, pb.thetas0
    for i in range(2):
        bands, base, st, th = tod_gibbs.tod_gibbs_step(
            pb.cfg, pb.comps, pb.bps, pb.slots, bands, base, pb.plan, st, th,
            first=i == 0, generator=gen, beam_consistent=True, ts=pb.ts,
            ps=pb.ps)
        assert abs(float(st.t[-1]) - 1.0) <= 1e-4
    assert torch.isfinite(torch.view_as_real(st.a)).all()
    assert torch.isfinite(st.t).all() and torch.isfinite(st.p).all()
    assert torch.isfinite(th).all() and st.it == 3
    assert all(s.cfg.grid_min <= t <= s.cfg.grid_max
               for s, t in zip(pb.slots, th.tolist()))
    assert not torch.equal(base.data, pb.sys.data)
