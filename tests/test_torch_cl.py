"""The port's C_ell models and samplers (commander_tpu_torch.model.cl)
against the JAX package's, float64.

Deterministic functions: 1e-12 relative. Samplers: the JAX sampler's own
normal and gamma variates are regenerated from its key (with its split
sequence) and handed to the port, so the draws agree to 1e-10 (float64
linear algebra on 2x2 blocks in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.model import cl as jcl
from commander_tpu_torch import convert
from commander_tpu_torch.model import cl as tcl

LMAX = 16
BINS = (0, 2, 5, 9, 13)
KINDS = ("power_law", "power_law_gauss", "exp", "gauss")


def _alm(rng, nmaps=3, lmax=LMAX):
    nl = lmax + 1
    a = rng.standard_normal((nmaps, nl, nl)) \
        + 1j * rng.standard_normal((nmaps, nl, nl))
    a *= np.tril(np.ones((nl, nl)))
    a[..., 0] = a[..., 0].real
    return a


def _cfgs(**kw):
    return jcl.ClModelConfig(**kw), tcl.ClModelConfig(**kw)


def _close(got, ref, tol=1e-12):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("kind", KINDS + ("binned", "none"))
def test_cl_eval_matches_jax(kind):
    cj, ct = _cfgs(kind=kind, lmax=LMAX, nmaps=3, bin_starts=BINS,
                   ell_pivot=7)
    rng = np.random.default_rng(len(kind))
    if kind == "binned":
        params = {"cl_bins": rng.uniform(1, 2, (3, len(BINS)))}
    elif kind == "none":
        params = {"cl_fix": rng.uniform(1, 2, (3, LMAX + 1))}
    else:
        params = {"amp": np.array([1e3, 200.0, 100.0]),
                  "beta": np.array([60.0, 30.0, -0.5]) if kind == "gauss"
                  else np.array([-0.3, 0.0, 1.5])}
    ref = jcl.cl_eval(cj, {k: jnp.asarray(v) for k, v in params.items()})
    got = tcl.cl_eval(ct, {k: torch.as_tensor(v) for k, v in params.items()})
    _close(got, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_fixed_cl_from_config_matches_jax(kind):
    args = (kind, (1e3, 200.0, 100.0), (60.0, 30.0, 30.0), 50, LMAX, 3)
    got = tcl.fixed_cl_from_config(*args)
    assert isinstance(got, np.ndarray) and (got[1:, :2] == 0).all()
    _close(got, jcl.fixed_cl_from_config(*args))


def test_sqrtS_pair_and_spectra_match_jax():
    rng = np.random.default_rng(1)
    a = _alm(rng)
    cl = rng.uniform(0.5, 2, (3, LMAX + 1))
    cl[1:, :2] = 0.0
    for fn in ("apply_sqrtS", "apply_sqrtInvS"):
        _close(getattr(tcl, fn)(torch.as_tensor(cl), torch.as_tensor(a)),
               getattr(jcl, fn)(jnp.asarray(cl), jnp.asarray(a)))
    _close(tcl.sigma_ell_spectra(torch.as_tensor(a), LMAX),
           jcl.sigma_ell_spectra(jnp.asarray(a), LMAX))
    _close(tcl.sigma_ell_spectra(torch.as_tensor(a[:1]), LMAX),
           jcl.sigma_ell_spectra(jnp.asarray(a[:1]), LMAX))


def test_te_matrix_functions_match_jax():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((7, 3, 3))
    M = A @ np.swapaxes(A, -1, -2)
    M[0] = 0.0                      # a zero block (the l < 2 rows)
    R = tcl.sqrt_psd(torch.as_tensor(M))
    np.testing.assert_allclose((R @ R.transpose(-1, -2)).numpy(), M,
                               atol=1e-10)
    np.testing.assert_allclose(R.numpy(), np.asarray(jcl.sqrt_psd(
        jnp.asarray(M))), atol=1e-10)
    _, ct = _cfgs(kind="binned", lmax=LMAX, nmaps=3, bin_starts=BINS)
    idx = tcl.bin_index_table(ct)
    B2 = rng.standard_normal((len(BINS), 2, 2))
    cl_te = B2 @ np.swapaxes(B2, -1, -2) + np.eye(2)
    cl_b = rng.uniform(0.1, 1, len(BINS))
    _close(tcl.full_cl_matrix(torch.as_tensor(cl_te), torch.as_tensor(cl_b),
                              idx),
           jcl.full_cl_matrix(jnp.asarray(cl_te), jnp.asarray(cl_b),
                              jnp.asarray(idx)))
    a = _alm(rng)
    _close(tcl.apply_sqrtS_TE(torch.as_tensor(cl_te), torch.as_tensor(cl_b),
                              idx, torch.as_tensor(a)),
           jcl.apply_sqrtS_TE(jnp.asarray(cl_te), jnp.asarray(cl_b),
                              jnp.asarray(idx), jnp.asarray(a)))


def _jax_te_draws(key, nmodes):
    """The variates inside jcl.sample_cl_binned_invwishart_TE (its key
    splits, cl.py:309-321 and _wishart_bartlett :274-282)."""
    nbins = len(nmodes)
    k1, k2 = jax.random.split(key)
    nu = np.maximum(nmodes - 3.0, 2.1)
    normal, gamma_w = [], []
    for k, n in zip(jax.random.split(k1, nbins), nu):
        kA, kC = jax.random.split(k)
        gamma_w.append(np.asarray(jax.random.gamma(
            kC, jnp.asarray((n - np.arange(2.0)) / 2.0))))
        normal.append(np.asarray(jax.random.normal(kA, (1,), jnp.float64)))
    gamma_b = jax.random.gamma(k2, jnp.maximum((jnp.asarray(nmodes) - 2.0)
                                               / 2.0, 0.5))
    return {"normal": torch.as_tensor(np.stack(normal)),
            "gamma_w": torch.as_tensor(np.stack(gamma_w)),
            "gamma_b": torch.as_tensor(np.array(gamma_b))}


def test_invwishart_TE_matches_with_jax_draws():
    cj, ct = _cfgs(kind="binned", lmax=LMAX, nmaps=3, bin_starts=BINS)
    a = _alm(np.random.default_rng(3))
    a[1] += 0.6 * a[0]              # a real T-E correlation
    key = jax.random.PRNGKey(11)
    te_j, b_j = jcl.sample_cl_binned_invwishart_TE(key, cj, jnp.asarray(a))
    draws = _jax_te_draws(key, tcl.wishart_dof_check(ct))
    te_t, b_t = tcl.sample_cl_binned_invwishart_TE(ct, torch.as_tensor(a),
                                                   draws=draws)
    _close(te_t, te_j, 1e-10)
    _close(b_t, b_j, 1e-10)
    np.testing.assert_array_equal(tcl.wishart_dof_check(ct),
                                  jcl.wishart_dof_check(cj))


def test_wishart_bartlett_matches_with_jax_draws():
    """p = 3: the strict lower triangle is filled in row-major order."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((5, 3, 3))
    chol = np.linalg.cholesky(A @ np.swapaxes(A, -1, -2) + np.eye(3))
    key = jax.random.PRNGKey(5)
    ref = jcl._wishart_bartlett(key, jnp.asarray(chol), 9.0, 3)
    kA, kC = jax.random.split(key)
    df = 9.0 - np.arange(3.0)
    gamma = jax.random.gamma(kC, jnp.broadcast_to(df / 2.0, (5, 3)))
    normal = jax.random.normal(kA, (5, 3), jnp.float64)
    got = tcl._wishart_bartlett(torch.as_tensor(chol), 9.0, 3,
                                normal=torch.as_tensor(np.array(normal)),
                                gamma=torch.as_tensor(np.array(gamma)))
    _close(got, ref, 1e-10)


def test_invgamma_with_sample_flags_matches_jax():
    """Bin-file flags: only flagged (bin, Stokes) entries are redrawn."""
    rng = np.random.default_rng(6)
    flags = tuple(tuple(bool(x) for x in row)
                  for row in rng.integers(0, 2, (len(BINS), 3)))
    cj, ct = _cfgs(kind="binned", lmax=LMAX, nmaps=3, bin_starts=BINS,
                   sample_bins=flags)
    assert convert.cl_model_config(dataclasses.asdict(cj)) == ct
    a = _alm(rng)
    prev = rng.uniform(1, 2, (3, len(BINS)))
    key = jax.random.PRNGKey(7)
    ref = jcl.sample_cl_binned_invgamma(key, cj, jnp.asarray(a),
                                        prev_bins=jnp.asarray(prev))
    shape = np.maximum(-1.0 + tcl.wishart_dof_check(ct) / 2.0, 0.5)
    gamma = jax.random.gamma(key, jnp.asarray(shape)[None, :].repeat(3, 0))
    got = tcl.sample_cl_binned_invgamma(
        ct, torch.as_tensor(a), gamma=torch.as_tensor(np.array(gamma)),
        prev_bins=torch.as_tensor(prev))
    _close(got, ref, 1e-10)
    kept = ~np.asarray(flags).T
    assert kept.any() and (got.numpy()[kept] == prev[kept]).all()


def test_prior_draw_matches_jax():
    cj, ct = _cfgs(kind="binned", lmax=LMAX, nmaps=3, bin_starts=BINS)
    key = jax.random.PRNGKey(8)
    ref = jcl.sample_cl_prior(key, cj, 3, 4.0, 2.5)
    gamma = jax.random.gamma(key, jnp.full((3, len(BINS)), 4.0))
    got = tcl.sample_cl_prior(ct, 3, 4.0, 2.5,
                              gamma=torch.as_tensor(np.array(gamma)))
    _close(got, ref, 1e-10)


@pytest.mark.parametrize("kind", ["power_law", "exp", "gauss"])
def test_powerlaw_amp_matches_jax(kind):
    cj, ct = _cfgs(kind=kind, lmax=LMAX, nmaps=3, ell_pivot=5)
    a = _alm(np.random.default_rng(9))
    beta = np.array([-0.5, 0.3, 1.0])
    key = jax.random.PRNGKey(10)
    ref = jcl.sample_cl_powerlaw_amp(key, cj, jnp.asarray(a),
                                     jnp.asarray(beta))
    ell = np.arange(LMAX + 1)
    sh = max((np.sum((2.0 * ell + 1.0) * (ell >= 2)) - 2.0) / 2.0, 0.5)
    gamma = jax.random.gamma(key, jnp.full((3,), sh))
    got = tcl.sample_cl_powerlaw_amp(ct, torch.as_tensor(a),
                                     torch.as_tensor(beta),
                                     gamma=torch.as_tensor(np.array(gamma)))
    _close(got, ref, 1e-10)


def test_samplers_draw_from_a_generator():
    """Without ready-made variates the samplers draw from the generator:
    seeded, finite, positive definite; with neither they refuse."""
    _, ct = _cfgs(kind="binned", lmax=LMAX, nmaps=3, bin_starts=BINS)
    a = torch.as_tensor(_alm(np.random.default_rng(12)))
    out = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(3)
        te, b = tcl.sample_cl_binned_invwishart_TE(ct, a, generator=g)
        out.append((te, b, tcl.sample_cl_prior(ct, 3, 4.0, 2.5, generator=g),
                    tcl.sample_cl_powerlaw_amp(
                        dataclasses.replace(ct, kind="power_law"), a,
                        torch.zeros(3, dtype=torch.float64), generator=g)))
    for x, y in zip(*out):
        assert torch.equal(x, y) and torch.isfinite(x).all()
    te, b = out[0][:2]
    assert (torch.linalg.eigvalsh(te) > 0).all() and (b > 0).all()
    with pytest.raises(ValueError, match="generator"):
        tcl.sample_cl_binned_invwishart_TE(ct, a)
