"""The joint amplitude system's two whole solves against the JAX package,
float64 on the CPU, on test_torch_joint.py's problem: the pinned relquad
row stopping the CG in both packages, and a gibbs_step with the template
and source rows with the JAX step's draws; kept apart from that file so
that they are dealt beside tests/test_sharding.py (ROADMAP "Tier-1
verify"). Tolerances as there.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from commander_tpu.sampling import gibbs as jgibbs
from commander_tpu_torch import convert
from commander_tpu_torch.sampling import gibbs as tgibbs
from commander_tpu_torch.sampling import joint as tjoint

from test_joint import LMAX
from test_torch_full_gibbs import BINS, _asdict
from test_torch_joint import (NL, _gcfg_j, _j_gibbs_step, _j_sample_joint_1e6,
                              _port, _rel, _with_priors, jax_rhs_draws,
                              joint_step_draws, pb)


def test_pinned_row_stops_the_cg_in_both_packages(pb):
    """The reference's fact: a template row pinned by inverse std 1e6 puts
    1e12 x its mean into the rhs, so |b| is that row's and the relative
    residual test passes after a few iterations while the diffuse block is
    still far from solved. The same draws (key 3) and tol 1e-6 in both
    packages: the same iteration counts, few with the pinned row."""
    key = jax.random.PRNGKey(3)
    counts = {}
    for pinned in (False, True):
        ts_j, ps_j = _with_priors(pb.ts_j, pb.ps_j, pinned=pinned)
        ts_j = dataclasses.replace(ts_j, prior_mean=jnp.zeros_like(
            ts_j.prior_mean).at[-1].set(1.0 if pinned else 0.0),
            prior_istd=jnp.zeros_like(ts_j.prior_istd).at[-1].set(
                1e6 if pinned else 0.0))
        ps_j = pb.ps_j
        ts_t, ps_t = _port(ts_j, ps_j)
        T = ts_t.ntemp
        draws = jax_rhs_draws(key, pb.sys_j.data.shape, (3, 1, NL, NL), T, 5)
        _, res_j = _j_sample_joint_1e6(pb.sys_j, pb.plan_j, ts_j, ps_j,
                                       key=key)
        _, res_t = tjoint.sample_joint(pb.sys_t, pb.plan_t, ts_t, ps_t,
                                       tol=1e-6, maxiter=500, **draws)
        assert res_t.iters == int(res_j.iters)
        assert res_t.rel_res == pytest.approx(float(res_j.rel_res), rel=1e-6)
        # the diffuse block's own relative residual at the solution
        b = tjoint.compute_rhs_joint(pb.sys_t, pb.plan_t, ts_t, ps_t,
                                     **draws)
        r = b - tjoint.apply_A_joint(pb.sys_t, pb.plan_t, ts_t, ps_t,
                                     res_t.x)
        rel_a = float(torch.sqrt(tjoint.alm_dot(r.a, r.a)
                                 / tjoint.alm_dot(b.a, b.a)))
        counts[pinned] = (res_t.iters, res_t.rel_res, rel_a)
    assert counts[False][0] > 15 and counts[False][2] < 1e-5
    assert counts[True][0] <= 3 and counts[True][1] <= 1e-6
    assert counts[True][2] > 1e-3, counts

def test_gibbs_step_with_joint_rows_matches(pb):
    """One gibbs_step with template and source rows (proper priors, no
    pinned row: a solve to 1e-12) from a nonzero (a, t, p), the port with
    the JAX step's draws: a, t, p and cl_bins to 1e-8."""
    ts_j, ps_j = _with_priors(pb.ts_j, pb.ps_j, pinned=False)
    ts_t, ps_t = _port(ts_j, ps_j)
    gcfg_j = _gcfg_j()
    T = ts_t.ntemp
    st_j = jgibbs.init_state(jax.random.PRNGKey(0), 3, 1, LMAX, len(BINS),
                             ntemp=T, nsrc=5)
    st_j = dataclasses.replace(st_j, t=jnp.linspace(-1.0, 1.0, T),
                               p=jnp.asarray(pb.p_true))
    key = st_j.key
    new_j = _j_gibbs_step(gcfg_j, pb.sys_j, pb.plan_j, st_j, ts_j, ps_j)
    ns = SimpleNamespace(sys_j=pb.sys_j, C=3, S=1, lmax=LMAX, gcfg_j=gcfg_j)
    # gibbs_step itself splits state.key; _jax_draws splits the key given
    draws = joint_step_draws(key, ns, 0, T, 5)
    st_t = convert.gibbs_state(_asdict(st_j), device="cpu")
    assert st_t.t.shape == (T,) and st_t.p.shape == (5,)
    new_t = tgibbs.gibbs_step(convert.gibbs_config(dataclasses.asdict(gcfg_j)),
                              pb.sys_t, pb.plan_t, st_t, draws=draws,
                              ts=ts_t, ps=ps_t)
    for k in ("a", "t", "p", "cl_bins"):
        assert _rel(getattr(new_t, k), getattr(new_j, k)) <= 1e-8, k
    # the md rows against the diffuse l <= 1 modes make this CG slow (50-100
    # iterations) and its last residuals differ by a few percent between
    # the two packages' roundings, so the step that crosses 1e-12 may come
    # one iteration apart
    assert abs(new_t.cg_iters - int(new_j.cg_iters)) <= 1
    assert new_t.cg_relres <= 1e-12 and new_t.cg_iters > 10
    # optimize: the Wiener mean, no draws
    opt_j = _j_gibbs_step(_gcfg_j(optimize=True), pb.sys_j, pb.plan_j,
                          st_j, ts_j, ps_j)
    opt_t = tgibbs.gibbs_step(
        convert.gibbs_config(dataclasses.asdict(_gcfg_j(optimize=True))),
        pb.sys_t, pb.plan_t, st_t, ts=ts_t, ps=ps_t)
    for k in ("a", "t", "p"):
        assert _rel(getattr(opt_t, k), getattr(opt_j, k)) <= 1e-8, k
