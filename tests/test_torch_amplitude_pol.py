"""The port's polarized (T/Q/U) amplitude system and Gibbs step against the
JAX package's, float64, at nside 8 / lmax 16 with 2 bands and 2 components.

Three noise / prior variants: diagonal noise with a mask and an ell window;
2x2 QU covariance blocks (cov_qu); a TE-coupled prior (cl_mat). Tolerances:
operator and rhs 1e-10 relative (float64 transforms in another order of
sums), CG solutions and whole steps 1e-8 (tol-1e-12 solves).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.instrument import noise as jnoise
from commander_tpu.instrument.beam import gaussian_bl
from commander_tpu.model import cl as jcl
from commander_tpu.sampling import amplitude as jamp
from commander_tpu.sampling import chisq as jchisq
from commander_tpu.sampling import gibbs as jgibbs
from commander_tpu.sphere import sht as jsht
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu_torch import convert, entry
from commander_tpu_torch.instrument import noise as tnoise
from commander_tpu_torch.model import cl as tcl
from commander_tpu_torch.sampling import amplitude as tamp
from commander_tpu_torch.sampling import chisq as tchisq
from commander_tpu_torch.sampling import gibbs as tgibbs
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.sphere.alm import alm_dot

NSIDE, LMAX = 8, 16
NPIX = 12 * NSIDE * NSIDE
NL = LMAX + 1
B, C, S = 2, 2, 3
BINS = (0, 2, 5, 9, 13)
VARIANTS = ("diagonal", "cov_qu", "cl_mat")


def _inputs(variant):
    """Numpy inputs of build_system for one variant, from a seed."""
    rng = np.random.default_rng(VARIANTS.index(variant))
    F = np.abs(rng.standard_normal((B, C, S))) + 0.5
    bl = np.stack([gaussian_bl(600.0, LMAX), gaussian_bl(400.0, LMAX)])
    bl = np.broadcast_to(bl[:, None, :], (B, S, NL)).copy()
    ell = np.arange(NL)
    cl = np.broadcast_to(1e3 / (1 + ell * (ell + 1.0)), (C, S, NL)).copy()
    cl[:, 1:, :2] = 0.0
    rms = rng.uniform(3.0, 8.0, (B, S, NPIX))
    rms[0, :, :5] = 0.0                  # masked by rms <= 0
    data = rng.standard_normal((B, S, NPIX)) * 10
    kw = {}
    if variant == "diagonal":
        mask = (rng.uniform(size=(B, S, NPIX)) > 0.1).astype(np.float64)
        ell_mask = np.ones((C, S, NL))
        ell_mask[:, 1:, :2] = 0.0
        ell_mask[1, :, 12:] = 0.0
        kw = dict(mask=mask, ell_mask=ell_mask)
    elif variant == "cov_qu":
        a = rng.standard_normal((B, NPIX, 2, 2)) * 2
        kw = dict(cov_qu=np.einsum("bpik,bpjk->bpij", a, a)
                  + 25.0 * np.eye(2))
    else:
        tt = 100.0 / np.maximum(ell * (ell + 1.0), 1.0)
        tt[:2] = 0.0
        cl_mat = np.zeros((C, NL, 3, 3))
        cl_mat[:, :, 0, 0] = tt
        cl_mat[:, :, 1, 1] = 0.2 * tt
        cl_mat[:, :, 0, 1] = cl_mat[:, :, 1, 0] = 0.6 * np.sqrt(0.2) * tt
        cl_mat[:, :, 2, 2] = 0.05 * tt
        kw = dict(cl_mat=cl_mat)
    return (F, bl, rms, cl, data), kw


@pytest.fixture(scope="module")
def plans():
    return (jsht.get_plan(NSIDE, LMAX, spin2=True, dtype="float64",
                          tables=False),
            tsht.get_plan(NSIDE, LMAX, spin2=True, dtype=torch.float64,
                          device="cpu"))


@pytest.fixture(scope="module", params=VARIANTS)
def systems(request):
    args, kw = _inputs(request.param)
    sys_j = jamp.build_system(*(jnp.asarray(x) for x in args),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    sys_t = tamp.build_system(*(torch.as_tensor(x) for x in args),
                              **{k: torch.as_tensor(v)
                                 for k, v in kw.items()})
    return request.param, sys_j, sys_t


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _rand_u(seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((C, S, NL, NL)) \
        + 1j * rng.standard_normal((C, S, NL, NL))
    return u * np.tril(np.ones((NL, NL)))


def test_build_system_and_convert_match(systems):
    """build_system from the same numpy inputs, and convert.amplitude_system
    from the JAX system's fields, both give the JAX system's arrays."""
    variant, sys_j, sys_t = systems
    sys_c = convert.amplitude_system(_fields(sys_j), device="cpu")
    set_fields = {k for k, v in _fields(sys_j).items() if v is not None}
    assert {"cov_qu": {"inv_qu", "sqrt_inv_qu"}, "cl_mat": {"sqrtS_mat"},
            "diagonal": {"ell_mask"}}[variant] <= set_fields
    assert sys_j.F_pix is None           # the one field the port lacks
    for k in _fields(sys_t):
        ref = getattr(sys_j, k)
        for got in (getattr(sys_t, k), getattr(sys_c, k)):
            if ref is None:
                assert got is None
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=1e-10, atol=1e-12)


def test_noise_applications_match(systems):
    _, sys_j, sys_t = systems
    m = np.random.default_rng(5).standard_normal((B, S, NPIX))
    for fn in ("apply_invN", "apply_sqrt_invN"):
        assert _rel(getattr(tamp, fn)(sys_t, torch.as_tensor(m)),
                    getattr(jamp, fn)(sys_j, jnp.asarray(m))) <= 1e-12


def test_apply_A_and_rhs_match(plans, systems):
    _, sys_j, sys_t = systems
    pj, pt = plans
    u = _rand_u(1)
    assert _rel(tamp.apply_A(sys_t, pt, torch.as_tensor(u)),
                jamp.apply_A(sys_j, pj, jnp.asarray(u))) <= 1e-10
    assert _rel(tamp.compute_rhs(sys_t, pt),
                jamp.compute_rhs(sys_j, pj, key=None)) <= 1e-10


def test_operator_is_self_adjoint(plans, systems):
    """<u, A v> = <A u, v> under the eps metric, in the real-m0 subspace."""
    _, _, sys_t = systems
    _, pt = plans
    u, v = (torch.as_tensor(_rand_u(s)) for s in (2, 3))
    for x in (u, v):
        x[..., 0] = x[..., 0].real
    lhs = float(alm_dot(u, tamp.apply_A(sys_t, pt, v)))
    rhs = float(alm_dot(tamp.apply_A(sys_t, pt, u), v))
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)
    assert float(alm_dot(u, tamp.apply_A(sys_t, pt, u))) > 0


def test_wiener_mean_matches(plans, systems):
    _, sys_j, sys_t = systems
    pj, pt = plans
    a_j, _ = jamp.sample_amplitudes(sys_j, pj, key=None, tol=1e-12,
                                    maxiter=600)
    a_t, res = tamp.sample_amplitudes(sys_t, pt, tol=1e-12, maxiter=600)
    assert res.converged
    assert _rel(a_t, a_j) <= 1e-8


def test_sample_with_jax_draws_matches(plans, systems):
    """One fluctuation draw: eta1 goes through N^-1/2 (the QU blocks'
    transposed Cholesky factor where the system has them)."""
    _, sys_j, sys_t = systems
    pj, pt = plans
    key = jax.random.PRNGKey(4)
    a_j, _ = jamp.sample_amplitudes(sys_j, pj, key=key, tol=1e-12,
                                    maxiter=600)
    k1, k2 = jax.random.split(key)
    eta1 = jax.random.normal(k1, sys_j.data.shape, sys_j.data.dtype)
    eta2 = j_random_alm_white(k2, (C, S, NL, NL), sys_j.data.dtype)
    a_t, _ = tamp.sample_amplitudes(
        sys_t, pt, eta1=torch.as_tensor(np.array(eta1)),
        eta2=torch.as_tensor(np.array(eta2)), tol=1e-12, maxiter=600)
    assert _rel(a_t, a_j) <= 1e-8


def test_chisq_matches(plans, systems):
    _, sys_j, sys_t = systems
    pj, pt = plans
    a = _rand_u(6)
    a[..., 0] = a[..., 0].real
    c_j, map_j, n_j = jchisq.compute_chisq(sys_j, pj, jnp.asarray(a))
    c_t, map_t, n_t = tchisq.compute_chisq(sys_t, pt, torch.as_tensor(a))
    assert abs(float(c_t) - float(c_j)) <= 1e-10 * float(c_j)
    assert int(n_t) == int(n_j)
    assert _rel(map_t, map_j) <= 1e-10
    assert _rel(tchisq.compute_residual(sys_t, pt, torch.as_tensor(a), 1),
                jchisq.compute_residual(sys_j, pj, jnp.asarray(a),
                                        exclude=1)) <= 1e-10


# --- the whole polarized Gibbs step, per-component C_ell models ------------

def _gibbs_problem(optimize=False):
    """Component 0 binned (resampled), component 1 on a fixed gauss prior,
    E/B windowed off below l = 2: the shape of the tutorial_pol preset."""
    (F, bl, rms, cl, data), _ = _inputs("diagonal")
    cl[1] = jcl.fixed_cl_from_config("gauss", (1e3, 200.0, 100.0),
                                     (600.0, 300.0, 300.0), 50, LMAX, S)
    ell_mask = np.ones((C, S, NL))
    ell_mask[:, 1:, :2] = 0.0
    sys_j = jamp.build_system(*(jnp.asarray(x) for x in
                                (F, bl, rms, cl, data)),
                              ell_mask=jnp.asarray(ell_mask))
    kw = dict(kind="binned", lmax=LMAX, nmaps=S, bin_starts=BINS)
    cfg_j = jgibbs.GibbsConfig(
        cl_cfg=jcl.ClModelConfig(**kw), cg_tol=1e-12, cg_maxiter=600,
        optimize=optimize,
        cl_cfgs=(jcl.ClModelConfig(**kw),
                 jcl.ClModelConfig(kind="gauss", lmax=LMAX, nmaps=S)))
    sys_t = convert.amplitude_system(_fields(sys_j), device="cpu")
    cfg_t = convert.gibbs_config(dataclasses.asdict(cfg_j))
    assert [c.kind for c in cfg_t.cl_cfgs] == ["binned", "gauss"]
    st_j = jgibbs.init_state(jax.random.PRNGKey(0), ncomp=C, nmaps=S,
                             lmax=LMAX, nbins=len(BINS), cl0=100.0)
    st_t = convert.gibbs_state(_fields(st_j), device="cpu")
    return sys_j, cfg_j, st_j, sys_t, cfg_t, st_t


def _jax_draws(state, sys_j, cfg_j):
    """JAX's draws inside gibbs_step with cl_cfgs set, from state.key with
    its own split sequence (gibbs.py:100,190-200; amplitude.py:289-345)."""
    _, k_amp, k_cl = jax.random.split(state.key, 3)
    k1, k2 = jax.random.split(k_amp)
    eta1 = jax.random.normal(k1, sys_j.data.shape, sys_j.data.dtype)
    eta2 = j_random_alm_white(k2, state.a.shape, sys_j.data.dtype)
    gamma = np.ones(state.cl_bins.shape)
    for c, cc in enumerate(cfg_j.cl_cfgs):
        if cc.kind != "binned":
            continue
        shape = np.maximum(cfg_j.cl_alpha0 + jcl.wishart_dof_check(cc) / 2.0,
                           0.5)
        gamma[c] = np.asarray(jax.random.gamma(
            jax.random.fold_in(k_cl, c),
            jnp.asarray(shape)[None, :].repeat(S, 0)))
    return {"eta1": torch.as_tensor(np.array(eta1)),
            "eta2": torch.as_tensor(np.array(eta2)),
            "gamma": torch.as_tensor(gamma)}


@pytest.mark.parametrize("optimize", [False, True])
def test_polarized_gibbs_step_matches(plans, optimize):
    pj, pt = plans
    sys_j, cfg_j, st_j, sys_t, cfg_t, st_t = _gibbs_problem(optimize)
    new_j = jgibbs.gibbs_step(cfg_j, sys_j, pj, st_j)
    new_t = tgibbs.gibbs_step(cfg_t, sys_t, pt, st_t,
                              draws=_jax_draws(st_j, sys_j, cfg_j))
    assert _rel(new_t.a, new_j.a) <= 1e-8
    assert _rel(new_t.cl_bins, new_j.cl_bins) <= 1e-8
    # the fixed-prior component keeps its bins, E/B hold no power below 2
    assert torch.equal(new_t.cl_bins[1], st_t.cl_bins[1])
    assert float(new_t.a[:, 1:, :2].abs().max()) == 0.0
    assert new_t.it == 1


def test_run_chain_history(plans):
    _, pt = plans
    _, _, _, sys_t, cfg_t, st_t = _gibbs_problem()
    cfg_t = dataclasses.replace(cfg_t, cg_tol=1e-8)
    out = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(9)
        out.append(tgibbs.run_chain(cfg_t, sys_t, pt, st_t, 3, g))
    (fin, hist), (fin2, hist2) = out
    assert hist["cl_bins"].shape == (3, C, S, len(BINS))
    assert hist["cg_iters"].shape == hist["cg_relres"].shape == (3,)
    assert fin.it == 3 and torch.equal(hist["cl_bins"][-1], fin.cl_bins)
    assert torch.equal(fin.a, fin2.a)
    assert torch.equal(hist["cl_bins"], hist2["cl_bins"])
    assert float(hist["cg_relres"].max()) <= 1e-8


# --- noise objects ---------------------------------------------------------

def test_noise_objects_match():
    rng = np.random.default_rng(8)
    rms = rng.uniform(1, 3, (3, NPIX))
    rms[0, :4] = 0.0
    rms[1, 7] = np.inf
    mask = (rng.uniform(size=(3, NPIX)) > 0.2).astype(np.float64)
    m = rng.standard_normal((3, NPIX))
    nj = jnoise.DiagonalNoise.create(jnp.asarray(rms), jnp.asarray(mask),
                                     reg_noise=0.5)
    nt = tnoise.DiagonalNoise.create(rms, mask, reg_noise=0.5, device="cpu")
    nc = convert.diagonal_noise(_fields(nj), device="cpu")
    for n in (nt, nc):
        for fn in ("invN", "sqrt_invN", "N"):
            assert _rel(getattr(n, fn)(torch.as_tensor(m)),
                        getattr(nj, fn)(jnp.asarray(m))) <= 1e-12
        assert _rel(n.rms_map(), nj.rms_map()) <= 1e-12
    a = rng.standard_normal((NPIX, 2, 2))
    cov = np.einsum("pik,pjk->pij", a, a) + 4.0 * np.eye(2)
    qj = jnoise.QUCovNoise.create(jnp.asarray(rms[0] + 1.0),
                                  jnp.asarray(cov), jnp.asarray(mask))
    qt = tnoise.QUCovNoise.create(rms[0] + 1.0, cov, mask, device="cpu")
    qc = convert.qucov_noise(_fields(qj), device="cpu")
    for q in (qt, qc):
        for fn in ("invN", "sqrt_invN"):
            assert _rel(getattr(q, fn)(torch.as_tensor(m)),
                        getattr(qj, fn)(jnp.asarray(m))) <= 1e-10
    assert tnoise.QUCovNoise.create(rms[0] + 1.0, cov, device="cpu") \
        .mask.shape == (3, NPIX)


# --- presets ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["entry_pol", "tutorial_pol"])
def test_polarized_presets_build_and_step(name):
    """The polarized presets at a small size: shapes, the per-component
    C_ell models, the E/B window, and one seeded step with a finite state
    and a reduced chi-square."""
    plan, sys_t, cfg, comps = entry.build_preset(
        name, torch.float64, "cpu", nside=8, lmax=16)
    assert plan.otf_p2 is not None and sys_t.data.shape == (3, 3, NPIX)
    assert sys_t.cl.shape == (3, 3, NL) and cfg.cl_cfg.nmaps == 3
    assert float(sys_t.cl[:, 1:, :2].abs().max()) == 0.0
    if name == "tutorial_pol":
        assert [c.kind for c in cfg.cl_cfgs] == ["binned", "gauss", "gauss"]
        want = tcl.fixed_cl_from_config(
            "gauss", (1e7, 500.0, 500.0), (60.0, 30.0, 30.0), 50, LMAX, 3)
        np.testing.assert_allclose(sys_t.cl[2].numpy(), want, rtol=1e-12)
    else:
        assert cfg.cl_cfgs == ()
    g = torch.Generator()
    g.manual_seed(1)
    st = tgibbs.gibbs_step(cfg, sys_t, plan, entry.initial_state(cfg, sys_t),
                           g)
    assert st.cg_relres <= cfg.cg_tol
    assert torch.isfinite(torch.view_as_real(st.a)).all()
    assert torch.isfinite(st.cl_bins).all()
    chi2, _, ndof = tchisq.compute_chisq(sys_t, plan, st.a)
    assert 0.5 < float(chi2) / int(ndof) < 20.0


def test_cg_stops_when_the_residual_is_exhausted():
    """A float32 solve asked for a tolerance it cannot reach: once rz or
    p.Ap underflows to 0 the CG stops with a finite solution, short of
    maxiter (the next step would divide 0 by 0)."""
    plan, sys_t, cfg, _ = entry.build_preset(
        "tutorial_pol", torch.float32, "cpu", nside=16, lmax=32)
    g = torch.Generator()
    g.manual_seed(0)
    st = tgibbs.gibbs_step(cfg, sys_t, plan, entry.initial_state(cfg, sys_t),
                           g)
    deep = dataclasses.replace(cfg, cg_tol=1e-30, cg_maxiter=40)
    st = tgibbs.gibbs_step(deep, sys_t, plan, st, g)
    assert 10 <= st.cg_iters < 40
    assert st.cg_relres < 1e-6
    assert torch.isfinite(torch.view_as_real(st.a)).all()
