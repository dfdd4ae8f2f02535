"""The port's CG preconditioners against the JAX package, float64 on the CPU:
the pseudo-inverse (CG_PRECOND_TYPE = pseudoinv) and the dense low-ell block
(CG_LMAX_PRECOND) with the HEALPix RING/NEST and udgrade tables it degrades
the system with, on tests/test_precond.py's inhomogeneous-noise systems at
nside 8 / lmax 12: T only and T/Q/U (with a TE-coupled prior and the E/B
window below l = 2), each with and without unhit pixels (N^-1 = 0).

Tolerances: index tables equal; the degraded system's fields 1e-12; one
application of either preconditioner 1e-10 of its max (the JAX degraded plan
is a Legendre-table plan, the port's an on-the-fly recurrence; the two
transforms agree to ~1e-14, and the dense low-ell inverse carries that
through its condition number, ~1e3 here); sample_amplitudes with the JAX
key's draws 1e-8 (two float64 CGs to relres 1e-10 with the same iteration
count); each preconditioner's solution against the diagonal one's 1e-7,
as tests/test_precond.py holds the JAX package.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from commander_tpu.sampling import amplitude as jamp
from commander_tpu.sampling import gibbs as jgibbs
from commander_tpu.sphere import healpix as jhp
from commander_tpu.sphere import sht as jsht
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu_torch import convert
from commander_tpu_torch.sampling import amplitude as tamp
from commander_tpu_torch.sampling import gibbs as tgibbs
from commander_tpu_torch.sphere import healpix as thp
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.sphere.alm import alm_dot
from test_torch_gibbs import _jax_draws, _rel

torch.set_num_threads(1)

NSIDE, LMAX, NBAND, NCOMP = 8, 12, 3, 2
L_LOWL = 4                 # nside_lo 2, lmax_lo 5 by the default rule
VARIANTS = [(1, False), (1, True), (3, False), (3, True)]


def _inputs(S, unhit):
    """tests/test_precond.py:_make_system's system, made with numpy: rms
    0.3-5 per pixel, Gaussian 2-degree beams, Cl = 100 / (l (l + 1)) from
    l = 2; unhit: 30% of each band's pixels without data."""
    npix, nl = 12 * NSIDE ** 2, LMAX + 1
    rng = np.random.default_rng(7)
    F = 1.0 + rng.uniform(0.2, 1.0, (NBAND, NCOMP))
    ell = np.arange(nl)
    bl = np.exp(-0.5 * ell * (ell + 1) * np.radians(2.0) ** 2)
    bl = np.broadcast_to(bl, (NBAND, S, nl)).copy()
    rms = np.ones((NBAND, S, npix)) * rng.uniform(0.3, 5.0, (NBAND, 1, npix))
    if unhit:
        rms = np.where(rng.random((NBAND, 1, npix)) < 0.3, np.inf, rms)
    cl = np.zeros((NCOMP, S, nl))
    cl[:, :, 2:] = 100.0 / (ell[2:] * (ell[2:] + 1.0))
    kw = dict(F=F, bl=bl, rms=rms, cl=cl,
              data=rng.normal(0.0, 1.0, (NBAND, S, npix)))
    if S == 3:
        cl_mat = np.zeros((NCOMP, nl, 3, 3))
        for s in range(3):
            cl_mat[:, :, s, s] = cl[:, s]
        cl_mat[:, :2, 1:, 1:] = 0.0
        cl_mat[:, :, 0, 1] = cl_mat[:, :, 1, 0] = 0.5 * np.sqrt(
            cl_mat[:, :, 0, 0] * cl_mat[:, :, 1, 1])
        ell_mask = np.ones((NCOMP, 3, nl))
        ell_mask[:, 1:, :2] = 0.0
        kw.update(cl_mat=cl_mat, ell_mask=ell_mask)
    return kw


def _fields(sys):
    return {f.name: None if getattr(sys, f.name) is None
            else np.asarray(getattr(sys, f.name))
            for f in dataclasses.fields(sys)}


@pytest.fixture(scope="module")
def plans():
    for S in (1, 3):
        # the JAX degraded plan, built and cached once outside any jit (the
        # JAX lowres_system builds it inside the jitted calls below, and its
        # cache would otherwise keep the first trace's values)
        jsht.get_plan(2, 5, spin2=S == 3)
    return {S: (jsht.get_plan(NSIDE, LMAX, spin2=S == 3),
                tsht.get_plan(NSIDE, LMAX, spin2=S == 3, device="cpu"))
            for S in (1, 3)}


def _systems(plans, S, unhit):
    kw = _inputs(S, unhit)
    sys_j = jamp.build_system(*(jnp.asarray(kw[k]) for k in (
        "F", "bl", "rms", "cl", "data")), cl_mat=kw.get("cl_mat"),
        ell_mask=kw.get("ell_mask"))
    sys_t = convert.amplitude_system(_fields(sys_j), device="cpu")
    return S, unhit, plans[S][0], sys_j, plans[S][1], sys_t


def _ids(variants):
    return [f"S{s}-{'unhit' if u else 'full'}" for s, u in variants]


@pytest.fixture(scope="module", params=VARIANTS, ids=_ids(VARIANTS))
def systems(request, plans):
    return _systems(plans, *request.param)


def _residual(S, seed):
    rng = np.random.default_rng(seed)
    shape = (NCOMP, S, LMAX + 1, LMAX + 1)
    r = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return r * np.tril(np.ones(shape[-2:]))


# --------------------------------------------------------------------------
# HEALPix tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nside", [1, 2, 4, 8, 16])
def test_ring_nest_tables_match(nside):
    for fn in ("ring2nest_table", "nest2ring_table"):
        got, ref = getattr(thp, fn)(nside), getattr(jhp, fn)(nside)
        assert got.dtype == np.int64 and np.array_equal(got, np.asarray(ref))
    r2n = thp.ring2nest_table(nside)
    assert np.array_equal(thp.nest2ring_table(nside)[r2n],
                          np.arange(12 * nside ** 2))


@pytest.mark.parametrize("nside_in", [1, 2, 4, 8, 16])
def test_udgrade_indices_match(nside_in):
    for nside_out in (1, 2, 4, 8, 16):
        got = thp.udgrade_indices(nside_in, nside_out)
        ref = np.asarray(jhp.udgrade_indices(nside_in, nside_out))
        assert got.shape == ref.shape and np.array_equal(got, ref)
        if nside_out < nside_in:
            # every input pixel is the child of exactly one output pixel
            assert np.array_equal(np.sort(got.ravel()),
                                  np.arange(12 * nside_in ** 2))


# --------------------------------------------------------------------------
# Low-ell packing and the degraded system
# --------------------------------------------------------------------------

@pytest.mark.parametrize("L", [0, 3, 6])
def test_pack_unpack_lowl_match_and_round_trip(L):
    nl = 9
    r = _residual(3, 10 + L)[..., :nl, :nl]
    r[..., 0] = r[..., 0].real
    v_j = np.asarray(jamp.pack_lowl(jnp.asarray(r), L))
    v_t = tamp.pack_lowl(torch.as_tensor(r), L)
    assert v_t.shape[-1] == (L + 1) ** 2
    assert _rel(v_t.numpy(), v_j) <= 1e-15
    back_j = np.asarray(jamp.unpack_lowl(jnp.asarray(v_j), NCOMP, 3, L, nl,
                                         nl, jnp.complex128))
    back_t = tamp.unpack_lowl(v_t, L, nl, nl, torch.complex128)
    assert _rel(back_t.numpy(), back_j) <= 1e-15
    # the round trip keeps the l <= L triangle and zeroes the rest
    want = r * (np.arange(nl) <= L)[:, None]
    assert np.abs(back_t.numpy() - want).max() <= 1e-14
    # the eps metric is the plain dot of the packed vectors
    a = torch.as_tensor(want)
    assert abs(float(alm_dot(a, a)) - float(torch.sum(v_t * v_t))) \
        <= 1e-12 * float(torch.sum(v_t * v_t))
    # batched: the same per leading entry
    vb = tamp.pack_lowl(torch.stack([torch.as_tensor(r)] * 2), L)
    assert torch.equal(vb[1], v_t)


def test_lowres_system_matches(systems):
    S, _, _, sys_j, _, sys_t = systems
    nside_lo, lmax_lo = tamp.lowl_grid(L_LOWL, LMAX + 1)
    assert (nside_lo, lmax_lo) == (2, 5)
    lo_j, _ = jamp.lowres_system(sys_j, nside_lo, lmax_lo)
    lo_t, plan_lo = tamp.lowres_system(sys_t, nside_lo, lmax_lo)
    assert (plan_lo.nside, plan_lo.lmax) == (nside_lo, lmax_lo)
    assert (plan_lo.otf_p2 is not None) == (S == 3)
    for f in dataclasses.fields(lo_t):
        got, ref = getattr(lo_t, f.name), getattr(lo_j, f.name)
        if f.name == "ell_mask" and ref is not None:
            ref = np.asarray(ref)[..., :lmax_lo + 1]   # the port cuts it
        if ref is None:
            assert got is None, f.name
            continue
        ref = np.asarray(ref)
        assert tuple(got.shape) == ref.shape, f.name
        scale = max(np.abs(ref).max(), 1e-300)
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * scale, f.name
    assert lo_t.sqrtS_mat is not None if S == 3 else lo_t.sqrtS_mat is None


@pytest.mark.parametrize("L", [2, 8, 16, 32, 64])
def test_lowl_grid_rule(L):
    """JAX's default degraded grid (amplitude.py:522-524), never nside 1."""
    nside_lo = max(2, int(2 ** np.ceil(np.log2(max(L, 2)))) // 2)
    assert tamp.lowl_grid(L, 2001) == (nside_lo,
                                       min(2 * L, 3 * nside_lo - 1, 2000))
    assert tamp.lowl_grid(L, 2001)[0] >= 2
    assert tamp.lowl_grid(L, 2001)[1] >= L


# --------------------------------------------------------------------------
# The applications
# --------------------------------------------------------------------------

# the JAX sides jitted whole (op by op, each application compiles ~9 s)
_JAX_APPLY = {
    "pseudoinv": jax.jit(lambda sys, plan, r: jamp.
                         build_preconditioner_pseudoinv(sys, plan)(r)),
    "lowl": jax.jit(lambda sys, plan, r: jamp.build_preconditioner_lowl(
        sys, plan, L_LOWL)(r)),
}

@pytest.mark.parametrize("kind", ["pseudoinv", "lowl"])
def test_preconditioner_application_matches(systems, kind):
    S, _, plan_j, sys_j, plan_t, sys_t = systems
    r = _residual(S, 3)
    if kind == "pseudoinv":
        z_j = _JAX_APPLY["pseudoinv"](sys_j, plan_j, jnp.asarray(r))
        M_t = tamp.build_preconditioner_pseudoinv(sys_t, plan_t)
    else:
        z_j = _JAX_APPLY["lowl"](sys_j, plan_j, jnp.asarray(r))
        M_t = tamp.build_preconditioner_lowl(sys_t, plan_t, L_LOWL)
    z_j = np.asarray(z_j)
    z_t = M_t(torch.as_tensor(r)).numpy()
    assert _rel(z_t, z_j) <= 1e-10


def test_batched_operator_is_the_operator_per_column(systems):
    """apply_A over a leading column axis (the low-ell block's chunks) is
    apply_A on each column."""
    S, _, _, _, plan_t, sys_t = systems
    u = torch.as_tensor(np.stack([_residual(S, 20 + k) for k in range(3)]))
    got = tamp.apply_A(sys_t, plan_t, u)
    for k in range(3):
        ref = tamp.apply_A(sys_t, plan_t, u[k])
        assert float((got[k] - ref).abs().max()) \
            <= 1e-13 * float(ref.abs().max())


# the diagonal preconditioner's Wiener mean per system, solved once
_DIAG_SOLUTIONS = {}


def test_batched_operator_with_qu_blocks(plans):
    """The same with the QU covariance blocks in N^-1."""
    _, plan_t = plans[3]
    kw = _inputs(3, False)
    rng = np.random.default_rng(9)
    npix = kw["rms"].shape[-1]
    c = rng.uniform(-0.3, 0.3, (NBAND, npix))
    cov = np.stack([np.stack([np.ones_like(c), c], -1),
                    np.stack([c, np.ones_like(c)], -1)], -2) \
        * kw["rms"][:, 1, :, None, None] ** 2
    sys_t = tamp.build_system(*(torch.as_tensor(kw[k]) for k in (
        "F", "bl", "rms", "cl", "data")), cov_qu=torch.as_tensor(cov))
    u = torch.as_tensor(np.stack([_residual(3, 30 + k) for k in range(2)]))
    got = tamp.apply_A(sys_t, plan_t, u)
    for k in range(2):
        ref = tamp.apply_A(sys_t, plan_t, u[k])
        assert float((got[k] - ref).abs().max()) \
            <= 1e-13 * float(ref.abs().max())


@pytest.mark.parametrize("kind", ["pseudoinv", "lowl"])
def test_preconditioner_symmetric_positive_and_solves(systems, kind):
    """Under alm_dot each preconditioner is symmetric and positive, and the
    CG it drives reaches the diagonal preconditioner's solution."""
    S, unhit, _, _, plan_t, sys_t = systems
    kw = dict(precond="pseudoinv") if kind == "pseudoinv" \
        else dict(lowl_lmax=L_LOWL)
    M = tamp.build_precond(sys_t, plan_t, **kw)
    tri = sys_t.tri
    r1, r2 = (tamp.real_m0(torch.as_tensor(_residual(S, s)) * tri)
              for s in (4, 5))
    a, b = float(alm_dot(r1, M(r2))), float(alm_dot(M(r1), r2))
    assert abs(a - b) <= 1e-10 * abs(a)
    assert float(alm_dot(r1, M(r1))) > 0 and float(alm_dot(r2, M(r2))) > 0
    if (S, unhit) not in _DIAG_SOLUTIONS:
        _DIAG_SOLUTIONS[S, unhit] = tamp.sample_amplitudes(
            sys_t, plan_t, tol=1e-10, maxiter=400)
    a_d, res_d = _DIAG_SOLUTIONS[S, unhit]
    a_p, res_p = tamp.sample_amplitudes(sys_t, plan_t, tol=1e-10,
                                        maxiter=400, **kw)
    assert res_d.converged and res_p.converged
    assert float((a_p - a_d).abs().max()) <= 1e-7


def _jax_amp_draws(key, sys_j):
    """sample_amplitudes' eta1, eta2 from its key (amplitude.py:289-345)."""
    k1, k2 = jax.random.split(key)
    C, S = sys_j.F.shape[1], sys_j.bl.shape[1]
    nl = sys_j.tri.shape[0]
    eta1 = jax.random.normal(k1, sys_j.data.shape, sys_j.data.dtype)
    eta2 = j_random_alm_white(k2, (C, S, nl, nl), sys_j.data.dtype) \
        * sys_j.tri
    return torch.as_tensor(np.array(eta1)), torch.as_tensor(np.array(eta2))


@pytest.mark.parametrize("kind,variant", [("pseudoinv", (1, True)),
                                          ("lowl", (3, False))],
                         ids=["pseudoinv-S1-unhit", "lowl-S3-full"])
def test_sample_amplitudes_matches_with_jax_draws(plans, kind, variant):
    """The pseudo-inverse on the T-only partial-sky system, the low-ell
    block on the T/Q/U one (the diagonal preconditioner's draws are held by
    test_torch_gibbs.py and test_torch_amplitude_pol.py)."""
    S, unhit, plan_j, sys_j, plan_t, sys_t = _systems(plans, *variant)
    kw = dict(precond="pseudoinv") if kind == "pseudoinv" \
        else dict(lowl_lmax=L_LOWL)
    key = jax.random.PRNGKey(11)
    a_j, res_j = jax.jit(partial(jamp.sample_amplitudes, tol=1e-10,
                                 maxiter=400, **kw))(sys_j, plan_j, key)
    eta1, eta2 = _jax_amp_draws(key, sys_j)
    a_t, res_t = tamp.sample_amplitudes(sys_t, plan_t, eta1=eta1, eta2=eta2,
                                        tol=1e-10, maxiter=400, **kw)
    # the stopping test may fall one iteration apart where relres crosses
    # 1e-10 between two iterations (the low-ell block's two inverses differ
    # at ~1e-13); the solutions agree all the same
    assert res_t.converged and abs(res_t.iters - int(res_j.iters)) <= 1
    assert _rel(a_t.numpy(), a_j) <= 1e-8


def test_unknown_preconditioner_is_refused(plans):
    _, plan_t = plans[1]
    kw = _inputs(1, False)
    sys_t = tamp.build_system(*(torch.as_tensor(kw[k]) for k in (
        "F", "bl", "rms", "cl", "data")))
    with pytest.raises(ValueError, match="unknown preconditioner"):
        tamp.sample_amplitudes(sys_t, plan_t, precond="jacobi")


# --------------------------------------------------------------------------
# The Gibbs step and its configuration
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gibbs_problem():
    plan_j, sys_j, cfg_j, _ = graft._build_problem(8, 16, dtype="float64")
    sys_t = convert.amplitude_system(_fields(sys_j), device="cpu")
    plan_t = tsht.get_plan(8, 16, dtype=torch.float64, device="cpu")
    return plan_j, sys_j, cfg_j, plan_t, sys_t


@pytest.mark.parametrize("setting", [dict(cg_precond="pseudoinv"),
                                     dict(cg_lmax_precond=L_LOWL)])
def test_gibbs_step_with_preconditioner_matches(gibbs_problem, setting):
    plan_j, sys_j, cfg_j, plan_t, sys_t = gibbs_problem
    cfg_j = dataclasses.replace(cfg_j, **setting)
    cfg_t = convert.gibbs_config(dataclasses.asdict(cfg_j))
    for k, v in setting.items():
        assert getattr(cfg_t, k) == v
    st_j = jgibbs.init_state(jax.random.PRNGKey(3), ncomp=3, nmaps=1,
                             lmax=16, nbins=len(cfg_j.cl_cfg.bin_starts),
                             cl0=100.0)
    new_j = jax.jit(partial(jgibbs.gibbs_step, cfg_j))(sys_j, plan_j, st_j)
    st_t = convert.gibbs_state({f.name: getattr(st_j, f.name)
                                for f in dataclasses.fields(st_j)},
                               device="cpu")
    new_t = tgibbs.gibbs_step(cfg_t, sys_t, plan_t, st_t,
                              draws=_jax_draws(st_j, sys_j, cfg_j))
    assert new_t.cg_iters == int(new_j.cg_iters)
    assert _rel(new_t.a.numpy(), new_j.a) <= 1e-8
    assert _rel(new_t.cl_bins.numpy(), new_j.cl_bins) <= 1e-8


def test_gibbs_config_carries_the_preconditioner(gibbs_problem):
    cfg_j = gibbs_problem[2]
    d = dataclasses.asdict(dataclasses.replace(
        cfg_j, cg_precond="pseudoinv", cg_lmax_precond=16))
    cfg_t = convert.gibbs_config(d)
    assert (cfg_t.cg_precond, cfg_t.cg_lmax_precond) == ("pseudoinv", 16)
    base = convert.gibbs_config(dataclasses.asdict(cfg_j))
    assert (base.cg_precond, base.cg_lmax_precond) == ("diagonal", -1)
    with pytest.raises(ValueError, match="cg_precond"):
        convert.gibbs_config(dict(d, cg_precond="jacobi"))
    with pytest.raises(NotImplementedError, match="groups"):
        convert.gibbs_config(dict(d, groups=(("cmb",),)))
