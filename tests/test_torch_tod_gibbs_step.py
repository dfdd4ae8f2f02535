"""A whole tod_gibbs_step against the JAX composition of
test_torch_tod_gibbs.py (run.py's TOD stage from process_tod, then
tpu_gibbs.full_gibbs_step), and the TOD monopoles carried over passes and
a step: float64 on the CPU on that file's problem (nside 16 / lmax 32, 4
bands of 32 scans x 2 detectors x 1024 samples), with the JAX keys' draws,
to 1e-8. Two cases, kept apart from test_torch_tod_gibbs.py so that they
are dealt beside tests/test_sharding.py (ROADMAP "Tier-1 verify").
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from commander_tpu.model.mixing import mixing_matrix as j_mixing_matrix
from commander_tpu.sampling import tpu_gibbs
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu.sphere.alm import triangle_mask as j_triangle_mask
from commander_tpu_torch import convert
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import tod_gibbs
from test_torch_full_gibbs import BINS, _asdict, _jax_draws
from test_torch_tod import _rel, jax_pass_draws
from test_torch_tod_gibbs import (ND, NPIX, _j_sky, _jax_mono_pass,
                                  _jax_step, _jax_tod_pass, problem)

torch.set_num_threads(1)


def test_tod_gibbs_step_matches_the_jax_composition(problem):
    """One tod_gibbs_step (first iteration: no scan rejection) from a
    nonzero amplitude state: the TOD pass on its model sky at theta0, the
    system update, then the three-slot full_gibbs_step with the maps."""
    pb, bands_j, bands_t = problem
    C, S, nl = pb.C, pb.S, pb.lmax + 1
    slots_j = tpu_gibbs.make_index_slots(pb.comps_j)
    slots_t = tfg.make_index_slots(pb.comps_t)
    start = [pb.comps_t[s.ci].theta0[s.which] for s in slots_t]
    a0 = np.asarray(j_random_alm_white(jax.random.PRNGKey(8), (C, S, nl, nl))
                    * jnp.asarray(j_triangle_mask(nl, nl))) \
        * np.sqrt(np.asarray(pb.sys_j.cl))[..., None]
    st_j = dataclasses.replace(tpu_gibbs.gibbs_mod.init_state(
        jax.random.PRNGKey(0), C, S, pb.lmax, len(BINS)), a=jnp.asarray(a0))

    # the JAX side: the model sky at theta0, the TOD stage, the sky step
    th0 = [(), tuple(start[:1]), tuple(start[1:])]
    F0 = np.asarray(j_mixing_matrix(pb.comps_j, pb.bps_j, thetas=th0))
    sys0 = dataclasses.replace(pb.sys_j, F=jnp.asarray(F0)[..., None])
    sky = _j_sky(sys0, pb.plan_j, st_j.a)
    tkey, key = jax.random.PRNGKey(21), jax.random.PRNGKey(42)
    bands_j1, data, inv_rms, keys = _jax_tod_pass(
        bands_j, pb.sys_j.data, pb.sys_j.inv_rms, sky, tkey, first=True)
    sys_j1 = dataclasses.replace(pb.sys_j, data=jnp.asarray(data),
                                 inv_rms=jnp.asarray(inv_rms),
                                 inv_rms2=jnp.asarray(inv_rms ** 2))
    new_j, th_j, _ = _jax_step(pb)(sys_j1, pb.plan_j, st_j,
                                   jnp.asarray(start, jnp.float64), key)

    # the port, with the JAX keys' draws
    draws = _jax_draws(key, pb, len(slots_t))
    draws["tod"] = [jax_pass_draws(k, cfg, bj, NPIX)
                    for k, (cfg, bj, _) in zip(keys, bands_j)]
    st_t = convert.gibbs_state(_asdict(st_j), device="cpu")
    bands, sys_t1, new_t, th_t = tod_gibbs.tod_gibbs_step(
        pb.gcfg_t, pb.comps_t, pb.bps_t, slots_t, bands_t, pb.sys_t,
        pb.plan_t, st_t, convert.thetas(start, device="cpu"), first=True,
        beam_consistent=True, draws=draws)

    assert _rel(sys_t1.data, data) <= 1e-8
    assert _rel(sys_t1.inv_rms, inv_rms) <= 1e-8
    assert _rel(sys_t1.inv_rms2, inv_rms ** 2) <= 1e-8
    hit = inv_rms > 0
    assert 0.5 < hit.mean() < 0.95         # partial coverage, as on real TOD
    for band, (_, _, st) in zip(bands, bands_j1):
        for f in dataclasses.fields(st):
            assert _rel(getattr(band.state, f.name),
                        getattr(st, f.name)) <= 1e-8
    for t, j, t0 in zip(th_t.tolist(), np.asarray(th_j), start):
        assert abs(t - j) <= 1e-8 * max(1.0, abs(t0))
    assert _rel(new_t.a.numpy(), new_j.a) <= 1e-8
    assert _rel(new_t.cl_bins.numpy(), new_j.cl_bins) <= 1e-8
    assert new_t.cg_iters == int(new_j.cg_iters) > 3




def test_monopoles_carry_over_passes_and_steps(problem):
    """With sample_mono: two TOD passes (the first without scan rejection)
    and then a tod_gibbs_step with first=False, each pass starting from the
    monopoles the one before drew (zeros at first), against the JAX
    composition that threads them as run.py does, given its keys' draws:
    the monopoles, maps and noise 1e-8, the step's amplitudes and theta as
    in the test above."""
    pb, bands_j, bands_t = problem
    C, S, nl = pb.C, pb.S, pb.lmax + 1
    slots_t = tfg.make_index_slots(pb.comps_t)
    start = [pb.comps_t[s.ci].theta0[s.which] for s in slots_t]
    a0 = np.asarray(j_random_alm_white(jax.random.PRNGKey(9), (C, S, nl, nl))
                    * jnp.asarray(j_triangle_mask(nl, nl))) \
        * np.sqrt(np.asarray(pb.sys_j.cl))[..., None]
    st_j = dataclasses.replace(tpu_gibbs.gibbs_mod.init_state(
        jax.random.PRNGKey(1), C, S, pb.lmax, len(BINS)), a=jnp.asarray(a0))
    th0 = [(), tuple(start[:1]), tuple(start[1:])]
    F0 = np.asarray(j_mixing_matrix(pb.comps_j, pb.bps_j, thetas=th0))
    sys0 = dataclasses.replace(pb.sys_j, F=jnp.asarray(F0)[..., None])
    sky = np.array(_j_sky(sys0, pb.plan_j, st_j.a))

    mono_j = [dataclasses.replace(c, sample_mono=True) for c, _, _ in bands_j]
    bj_m = [(c, bj, st) for c, (_, bj, st) in zip(mono_j, bands_j)]
    bt_m = [b._replace(cfg=dataclasses.replace(b.cfg, sample_mono=True),
                       mono=torch.zeros(ND, dtype=torch.float64))
            for b in bands_t]
    monos = [jnp.zeros(ND, jnp.float64) for _ in bands_j]
    data, inv_rms = np.asarray(pb.sys_j.data), np.asarray(pb.sys_j.inv_rms)
    sys_t = pb.sys_t
    for i, first in enumerate((True, False)):
        bj_m, monos, data, inv_rms, keys = _jax_mono_pass(
            bj_m, monos, data, inv_rms, sky, jax.random.PRNGKey(30 + i),
            first)
        draws = [jax_pass_draws(k, cfg, bj, NPIX)
                 for k, (cfg, bj, _) in zip(keys, bj_m)]
        assert all("mono" in d for d in draws)
        bt_m, sys_t = tod_gibbs.tod_pass(bt_m, sys_t, torch.as_tensor(sky),
                                         first=first, draws=draws)
        for band, m in zip(bt_m, monos):
            assert band.mono.shape == (ND,)
            assert _rel(band.mono, m) <= 1e-8
        assert float(np.abs(np.asarray(monos[0])).max()) > 0
        assert _rel(sys_t.data, data) <= 1e-8
        assert _rel(sys_t.inv_rms, inv_rms) <= 1e-8

    # the step: its TOD pass starts from the second pass's monopoles. With
    # scan rejection on, 76% of the pixels stay solved and the CG needs
    # more than the problem's 200 iterations to reach a level where two
    # float64 solvers agree to 1e-8 (it stops at relres 4e-8 there)
    gcfg_j = dataclasses.replace(pb.gcfg_j, cg_tol=1e-10, cg_maxiter=1000)
    gcfg_t = convert.gibbs_config(dataclasses.asdict(gcfg_j))
    tkey, key = jax.random.PRNGKey(32), jax.random.PRNGKey(43)
    bj_m, monos, data, inv_rms, keys = _jax_mono_pass(
        bj_m, monos, data, inv_rms, sky, tkey, first=False)
    sys_j1 = dataclasses.replace(pb.sys_j, data=jnp.asarray(data),
                                 inv_rms=jnp.asarray(inv_rms),
                                 inv_rms2=jnp.asarray(inv_rms ** 2))
    new_j, th_j, _ = _jax_step(pb, gcfg_j)(
        sys_j1, pb.plan_j, st_j, jnp.asarray(start, jnp.float64), key)
    draws = _jax_draws(key, pb, len(slots_t))
    draws["tod"] = [jax_pass_draws(k, cfg, bj, NPIX)
                    for k, (cfg, bj, _) in zip(keys, bj_m)]
    st_t = convert.gibbs_state(_asdict(st_j), device="cpu")
    bands, sys_t1, new_t, th_t = tod_gibbs.tod_gibbs_step(
        gcfg_t, pb.comps_t, pb.bps_t, slots_t, bt_m, sys_t, pb.plan_t,
        st_t, convert.thetas(start, device="cpu"), first=False,
        beam_consistent=True, draws=draws)
    for band, m in zip(bands, monos):
        assert _rel(band.mono, m) <= 1e-8
    assert _rel(sys_t1.data, data) <= 1e-8
    assert _rel(sys_t1.inv_rms, inv_rms) <= 1e-8
    for t, j, t0 in zip(th_t.tolist(), np.asarray(th_j), start):
        assert abs(t - j) <= 1e-8 * max(1.0, abs(t0))
    assert _rel(new_t.a.numpy(), new_j.a) <= 1e-8
    assert new_t.cg_relres <= 1e-10
    assert new_t.cg_iters == int(new_j.cg_iters)
