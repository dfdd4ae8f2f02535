"""The port's amplitude + C_ell Gibbs step against the JAX package, as a
whole, at nside 16 / lmax 32 with 3 bands, float64.

The JAX problem is built with __graft_entry__._build_problem's recipe and
carried across with commander_tpu_torch.convert. Tolerances: operator and
rhs 1e-10 relative (float64 transforms, different sum orders); the CG
solutions 1e-8 relative (tol-1e-12 solves of a well-conditioned system).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from commander_tpu.model.cl import bin_index_table as j_bin_index_table
from commander_tpu.sampling import amplitude as jamp
from commander_tpu.sampling import gibbs as jgibbs
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu_torch import convert, entry
from commander_tpu_torch.model import cl as tcl
from commander_tpu_torch.sampling import amplitude as tamp
from commander_tpu_torch.sampling import gibbs as tgibbs
from commander_tpu_torch.sphere import sht as tsht

NSIDE, LMAX = 16, 32


@pytest.fixture(scope="module")
def problem():
    plan_j, sys_j, cfg_j, _ = graft._build_problem(NSIDE, LMAX,
                                                   dtype="float64")
    sys_t = convert.amplitude_system(
        {f.name: getattr(sys_j, f.name) for f in dataclasses.fields(sys_j)})
    cfg_t = convert.gibbs_config(dataclasses.asdict(cfg_j))
    plan_t = tsht.get_plan(NSIDE, LMAX, dtype=torch.float64)
    return plan_j, sys_j, cfg_j, plan_t, sys_t, cfg_t


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def test_port_builds_the_same_problem(problem):
    _, _, cfg_j, _, sys_t, cfg_t = problem
    _, sys_b, cfg_b, _ = entry.build_problem(NSIDE, LMAX, dtype=torch.float64)
    for f in ("F", "bl", "inv_rms2", "inv_rms", "cl", "data", "tri"):
        np.testing.assert_allclose(getattr(sys_b, f).numpy(),
                                   getattr(sys_t, f).numpy(), rtol=1e-12)
    assert cfg_b == cfg_t


def test_apply_A_and_rhs_match(problem):
    plan_j, sys_j, _, plan_t, sys_t, _ = problem
    rng = np.random.default_rng(1)
    nl = LMAX + 1
    u = rng.standard_normal((3, 1, nl, nl)) \
        + 1j * rng.standard_normal((3, 1, nl, nl))
    Au_j = jamp.apply_A(sys_j, plan_j, jnp.asarray(u))
    Au_t = tamp.apply_A(sys_t, plan_t, torch.as_tensor(u))
    assert _rel(Au_t.numpy(), Au_j) <= 1e-10
    rhs_j = jamp.compute_rhs(sys_j, plan_j, key=None)
    rhs_t = tamp.compute_rhs(sys_t, plan_t)
    assert _rel(rhs_t.numpy(), rhs_j) <= 1e-10


def test_wiener_mean_matches(problem):
    plan_j, sys_j, _, plan_t, sys_t, _ = problem
    a_j, res_j = jamp.sample_amplitudes(sys_j, plan_j, key=None, tol=1e-12,
                                        maxiter=300)
    a_t, res_t = tamp.sample_amplitudes(sys_t, plan_t, tol=1e-12,
                                        maxiter=300)
    assert res_t.converged
    assert _rel(a_t.numpy(), a_j) <= 1e-8


def _jax_draws(state, sys_j, cfg_j):
    """JAX's draws inside gibbs_step, regenerated from state.key with JAX's
    own split sequence (gibbs.py:100,183-188; amplitude.py:289-345;
    cl.py:249)."""
    _, k_amp, k_cl = jax.random.split(state.key, 3)
    k1, k2 = jax.random.split(k_amp)
    C = state.a.shape[0]
    eta1 = jax.random.normal(k1, sys_j.data.shape, sys_j.data.dtype)
    eta2 = j_random_alm_white(k2, state.a.shape, sys_j.data.dtype) * sys_j.tri
    idx = j_bin_index_table(cfg_j.cl_cfg)
    nbins = len(cfg_j.cl_cfg.bin_starts)
    wl = 2.0 * np.arange(cfg_j.cl_cfg.lmax + 1) + 1.0
    shape = np.maximum(cfg_j.cl_alpha0
                       + np.bincount(idx, weights=wl, minlength=nbins) / 2.0,
                       0.5)
    S = state.a.shape[1]
    gamma = np.stack([np.asarray(jax.random.gamma(
        k, jnp.asarray(shape)[None, :].repeat(S, 0)))
        for k in jax.random.split(k_cl, C)])
    return {"eta1": torch.as_tensor(np.array(eta1)),
            "eta2": torch.as_tensor(np.array(eta2)),
            "gamma": torch.as_tensor(gamma)}


def test_gibbs_step_matches_with_jax_draws(problem):
    plan_j, sys_j, cfg_j, plan_t, sys_t, cfg_t = problem
    nbins = len(cfg_j.cl_cfg.bin_starts)
    st_j = jgibbs.init_state(jax.random.PRNGKey(0), ncomp=3, nmaps=1,
                             lmax=LMAX, nbins=nbins, cl0=100.0)
    new_j = jgibbs.gibbs_step(cfg_j, sys_j, plan_j, st_j)
    st_t = convert.gibbs_state({f.name: getattr(st_j, f.name)
                                for f in dataclasses.fields(st_j)})
    new_t = tgibbs.gibbs_step(cfg_t, sys_t, plan_t, st_t,
                              draws=_jax_draws(st_j, sys_j, cfg_j))
    assert _rel(new_t.a.numpy(), new_j.a) <= 1e-8
    assert _rel(new_t.cl_bins.numpy(), new_j.cl_bins) <= 1e-8
    assert new_t.cg_iters == int(new_j.cg_iters)
    assert new_t.it == 1


def test_gibbs_step_from_generator_is_seeded(problem):
    """The generator path: the same seed gives the same step, finite, with
    the CG converged."""
    _, _, _, plan_t, sys_t, cfg_t = problem
    st = entry.initial_state(cfg_t, sys_t)
    out = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(5)
        out.append(tgibbs.gibbs_step(cfg_t, sys_t, plan_t, st, g))
    assert torch.equal(out[0].a, out[1].a)
    assert torch.equal(out[0].cl_bins, out[1].cl_bins)
    assert out[0].cg_relres <= cfg_t.cg_tol
    assert torch.isfinite(out[0].cl_bins).all()


def test_gamma_sampler_moments():
    """Marsaglia-Tsang draws from a torch.Generator: mean and variance of
    Gamma(a) are a, to 4 standard errors, above and below shape 1."""
    g = torch.Generator()
    g.manual_seed(0)
    n = 200_000
    for a in (0.5, 1.0, 7.5):
        x = tcl.gamma_marsaglia_tsang(g, torch.full((n,), a,
                                                    dtype=torch.float64))
        assert (x > 0).all()
        assert abs(float(x.mean()) - a) <= 4 * np.sqrt(a / n)
        # var(sample variance) ~ (mu4 - a^2)/n with mu4 = 3a^2 + 6a
        assert abs(float(x.var()) - a) <= 4 * np.sqrt((2 * a * a + 6 * a) / n)
