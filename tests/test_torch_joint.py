"""The port's joint amplitude system (sampling/joint.py) and the modules it
brought (healpix.ang2pix_ring, model/relquad.py, ops/powell.py, pcg on a
JointState, GibbsState.t / .p) against the JAX package, float64 on the CPU.

The problem is tests/test_joint.py's (nside 8 / lmax 16, 3 bands, CMB +
synchrotron + dust, 12 md templates, 5 sources with Gaussian stamps),
converted into the port; where priors matter the rows get proper priors
and a pinned relquad row (mean 1, inverse std 1e6, as run.py:497 gives a
prior rms of 0). Draws are regenerated from the JAX keys in the reference's
order. Tolerances: ang2pix identical integers; relquad and the builders
1e-12; template and source products and adjoints 1e-12; operator, rhs and
preconditioner 1e-10; Wiener mean 1e-8; the draws outside the CG 1e-8; a
whole gibbs_step with the JAX step's draws 1e-8.

The pinned-row solve and the whole gibbs_step with the rows are
tests/test_torch_joint_step.py (two cases, dealt beside
tests/test_sharding.py).
"""
import dataclasses
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.model import relquad as jrq
from commander_tpu.model.cl import ClModelConfig as JClModelConfig
from commander_tpu.ops import powell as jpowell
from commander_tpu.sampling import gibbs as jgibbs
from commander_tpu.sampling import joint as jjoint
from commander_tpu.sphere import healpix as jhp
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu_torch import convert
from commander_tpu_torch.model import relquad as trq
from commander_tpu_torch.ops import powell as tpowell
from commander_tpu_torch.sampling import gibbs as tgibbs
from commander_tpu_torch.sampling import joint as tjoint
from commander_tpu_torch.sphere import healpix as thp
from commander_tpu_torch.sphere import sht as tsht
from test_joint import NPIX, NSIDE, LMAX, _joint_setup
from test_torch_full_gibbs import BINS, _asdict, _jax_draws

# small shapes: one torch thread, so that test workers sharing the cores
# do not oversubscribe them
torch.set_num_threads(1)

NL = LMAX + 1
FREQS = (30e9, 100e9, 353e9)


def _rel(got, ref):
    ref = np.asarray(ref)
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _with_priors(ts_j, ps_j, seed=7, pinned=True):
    """The md rows with Gaussian priors plus (pinned) a relquad row at mean
    1, inverse std 1e6; the sources with Gaussian priors."""
    rng = np.random.default_rng(seed)
    T = ts_j.maps.shape[0]
    maps, mean, istd = ts_j.maps, rng.standard_normal(T), \
        1.0 / (50.0 + 50.0 * rng.random(T))
    if pinned:
        row = np.zeros((1,) + ts_j.maps.shape[1:])
        for b, nu in enumerate(FREQS):
            row[0, b, 0] = jrq.relquad_template(NSIDE, nu)
        maps = jnp.concatenate([maps, jnp.asarray(row)])
        mean, istd = np.r_[mean, 1.0], np.r_[istd, 1e6]
    nsrc = ps_j.pix.shape[0]
    ts2 = jjoint.TemplateSet(maps=maps, prior_mean=jnp.asarray(mean),
                             prior_istd=jnp.asarray(istd))
    ps2 = dataclasses.replace(
        ps_j, prior_mean=jnp.asarray(5.0 * rng.random(nsrc)),
        prior_istd=jnp.asarray(1.0 / (2.0 + rng.random(nsrc))))
    return ts2, ps2


def _port(ts_j, ps_j):
    return (convert.template_set(_asdict(ts_j), device="cpu"),
            convert.ptsrc_set(_asdict(ps_j), NPIX, device="cpu"))


@pytest.fixture(scope="module")
def pb():
    plan_j, sys_j, ts_j, ps_j, _, t_true, p_true = _joint_setup()
    ts_p, ps_p = _with_priors(ts_j, ps_j)
    ts_t, ps_t = _port(ts_j, ps_j)
    tsp_t, psp_t = _port(ts_p, ps_p)
    return SimpleNamespace(
        plan_j=plan_j, sys_j=sys_j, ts_j=ts_j, ps_j=ps_j, ts_p=ts_p,
        ps_p=ps_p, t_true=t_true, p_true=p_true,
        plan_t=tsht.get_plan(NSIDE, LMAX, dtype=torch.float64, device="cpu"),
        sys_t=convert.amplitude_system(_asdict(sys_j), device="cpu"),
        ts_t=ts_t, ps_t=ps_t, tsp_t=tsp_t, psp_t=psp_t)


def jax_rhs_draws(k_amp, data_shape, a_shape, ntemp=0, nsrc=0):
    """The draws of commander_tpu compute_rhs_joint(..., key=k_amp), in its
    split order, as the port's eta1, eta2, eta_t, eta_p."""
    k1, k2 = jax.random.split(k_amp)
    out = {"eta1": jax.random.normal(k1, data_shape, jnp.float64),
           "eta2": j_random_alm_white(k2, a_shape, jnp.float64)}
    if ntemp:
        kt, k2 = jax.random.split(k2)
        out["eta_t"] = jax.random.normal(kt, (ntemp,), jnp.float64)
    if nsrc:
        kp, k2 = jax.random.split(k2)
        out["eta_p"] = jax.random.normal(kp, (nsrc,), jnp.float64)
    return {k: torch.as_tensor(np.array(v)) for k, v in out.items()}


def jax_rows(nside, freqs, fwhm, nmaps=1, nsrc=6, seed=0):
    """The joint presets' rows (entry.joint_rows) built by the JAX package at
    a test's size: md per band with prior 0 +- 100, a relquad row pinned at
    1, nsrc sources of SED (nu / 30 GHz)^-2.5 with flat priors. Returns
    (ts, ps, t_true, p_true, their signal (B, nmaps, P))."""
    npix, B = 12 * nside * nside, len(freqs)
    md = np.asarray(jjoint.make_md_templates(nside, B, nmaps=nmaps).maps)
    row = np.zeros((1, B, nmaps, npix))
    for b, nu in enumerate(freqs):
        row[0, b, 0] = jrq.relquad_template(nside, nu)
    ts = jjoint.TemplateSet(
        maps=jnp.asarray(np.concatenate([md, row])),
        prior_mean=jnp.asarray(np.r_[np.zeros(4 * B), 1.0]),
        prior_istd=jnp.asarray(np.r_[np.full(4 * B, 0.01), 1e6]))
    rng = np.random.default_rng([seed, 2])
    F_src = np.stack([(nu / 30e9) ** -2.5 * np.ones(nsrc) for nu in freqs])
    ps = jjoint.gaussian_stamp_ptsrc(
        nside, rng.choice(npix, size=nsrc, replace=False), F_src,
        np.maximum(np.asarray(fwhm), 60.0), nmaps=nmaps, npatch=16)
    p_true = np.abs(rng.standard_normal(nsrc)) * 50.0 + 50.0
    t_true = np.r_[rng.standard_normal(4 * B) * 3.0, 1.0]
    extra = jjoint._templates_fwd(ts, jnp.asarray(t_true)) \
        + jjoint._ptsrc_fwd(ps, jnp.asarray(p_true), npix)
    return ts, ps, t_true, p_true, np.asarray(extra)


def joint_step_draws(key, pb_ns, nslot, ntemp, nsrc):
    """_jax_draws (eta1, eta2, gamma, u of gibbs_step / full_gibbs_step with
    `key`) plus eta_t, eta_p of the joint rhs under its k_amp."""
    draws = _jax_draws(key, pb_ns, nslot)
    k_amp = jax.random.split(key, 3)[1]
    draws.update(jax_rhs_draws(k_amp, pb_ns.sys_j.data.shape,
                               (pb_ns.C, pb_ns.S, pb_ns.lmax + 1,
                                pb_ns.lmax + 1), ntemp, nsrc))
    return draws


# ---------------------------------------------------------------------------
# the host modules: ang2pix_ring, relquad, powell, the builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nside", [1, 2, 16, 1024])
def test_ang2pix_ring_matches(nside):
    rng = np.random.default_rng(nside)
    theta = np.r_[np.arccos(rng.uniform(-1, 1, 4000)), 0.0, np.pi,
                  np.arccos(2.0 / 3.0), np.arccos(-2.0 / 3.0)]
    phi = np.r_[rng.uniform(-2 * np.pi, 4 * np.pi, 4000), 0.0, 2 * np.pi,
                np.pi / 2, 3 * np.pi]
    got = thp.ang2pix_ring(nside, theta, phi)
    ref = jhp.ang2pix_ring(nside, theta, phi)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert thp.ang2pix_ring(nside, 0.3, 1.0) == jhp.ang2pix_ring(nside, 0.3,
                                                                 1.0)
    # pixel centres map to themselves
    th, ph = thp.pix2ang_ring(min(nside, 16))
    assert np.array_equal(thp.ang2pix_ring(min(nside, 16), th, ph),
                          np.arange(th.size))


def test_relquad_matches():
    assert _rel(trq.dipole_unit_vector(), jrq.dipole_unit_vector()) <= 1e-12
    for nu in (30e9, 70e9, 353e9):
        assert _rel(trq.relquad_template(NSIDE, nu),
                    jrq.relquad_template(NSIDE, nu)) <= 1e-12
    assert _rel(trq.solar_dipole_map(NSIDE),
                jrq.solar_dipole_map(NSIDE)) <= 1e-12


def test_powell_matches():
    f = lambda x: float((x[0] - 1.5) ** 2 + 3 * (x[1] + 0.5) ** 2
                        + 0.4 * x[0] * x[1] + np.cos(x[0]))
    got, ref = tpowell.powell(f, [0.2, 0.1]), jpowell.powell(f, [0.2, 0.1])
    assert np.array_equal(got[0], ref[0]) and got[1:] == ref[1:]


@pytest.mark.parametrize("nmaps", [1, 3])
def test_builders_match(nmaps):
    md_t = tjoint.make_md_templates(NSIDE, 3, nmaps=nmaps, device="cpu")
    md_j = jjoint.make_md_templates(NSIDE, 3, nmaps=nmaps)
    assert md_t.ntemp == 12 and md_t.planes.shape == (12, NPIX)
    assert _rel(md_t.dense(), md_j.maps) <= 1e-12
    rng = np.random.default_rng(5)
    src_pix = rng.choice(NPIX, size=6, replace=False)
    F_src = rng.random((3, 6)) + 0.5
    fwhm = np.array([600.0, 420.0, 300.0])
    ps_t = tjoint.gaussian_stamp_ptsrc(NSIDE, src_pix, F_src, fwhm,
                                       nmaps=nmaps, npatch=24, device="cpu")
    ps_j = jjoint.gaussian_stamp_ptsrc(NSIDE, src_pix, F_src, fwhm,
                                       nmaps=nmaps, npatch=24)
    assert np.array_equal(ps_t.pix.numpy(), np.asarray(ps_j.pix))
    assert _rel(ps_t.stamp, ps_j.stamp) <= 1e-12


# ---------------------------------------------------------------------------
# the products, the operator, the rhs, the preconditioner, the solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nmaps", [1, 3])
def test_products_and_adjoints_match(pb, nmaps):
    """_templates_fwd / _adj and _ptsrc_fwd / _adj against the JAX einsums
    and scatter, for T and T/Q/U maps (random templates on every plane of
    one band, md elsewhere; overlapping source stamps)."""
    rng = np.random.default_rng(11 + nmaps)
    md = np.asarray(jjoint.make_md_templates(NSIDE, 3, nmaps=nmaps).maps)
    extra = np.zeros((2, 3, nmaps, NPIX))
    extra[0, 1] = rng.standard_normal((nmaps, NPIX))
    extra[1, :, 0] = rng.standard_normal((3, NPIX))
    ts_j = jjoint.TemplateSet(maps=jnp.asarray(np.concatenate([md, extra])),
                              prior_mean=jnp.zeros(14),
                              prior_istd=jnp.zeros(14))
    src_pix = np.r_[rng.choice(NPIX, size=4, replace=False), 0, 1]
    ps_j = jjoint.gaussian_stamp_ptsrc(NSIDE, src_pix, rng.random((3, 6)),
                                       np.array([900.0, 600.0, 400.0]),
                                       nmaps=nmaps, npatch=32)
    ps_j = dataclasses.replace(ps_j, stamp=jnp.asarray(
        rng.standard_normal(ps_j.stamp.shape)))
    ts_t, ps_t = _port(ts_j, ps_j)
    assert ts_t.planes.shape[0] == 12 + nmaps + 3
    flat = ps_t.flat.numpy()
    assert np.unique(flat).size < flat.size           # stamps overlap
    t = rng.standard_normal(14)
    p = rng.standard_normal(6)
    m = rng.standard_normal((3, nmaps, NPIX))
    T = torch.as_tensor
    assert _rel(tjoint._templates_fwd(ts_t, T(t)),
                jjoint._templates_fwd(ts_j, jnp.asarray(t))) <= 1e-12
    assert _rel(tjoint._templates_adj(ts_t, T(m)),
                jjoint._templates_adj(ts_j, jnp.asarray(m))) <= 1e-12
    assert _rel(tjoint._ptsrc_fwd(ps_t, T(p), NPIX),
                jjoint._ptsrc_fwd(ps_j, jnp.asarray(p), NPIX)) <= 1e-12
    assert _rel(tjoint._ptsrc_adj(ps_t, T(m)),
                jjoint._ptsrc_adj(ps_j, jnp.asarray(m))) <= 1e-12
    with pytest.raises(ValueError, match="pixels"):
        tjoint._ptsrc_fwd(ps_t, T(p), 4 * NPIX)


def _random_state(seed, C, T, nsrc):
    g = torch.Generator()
    g.manual_seed(seed)
    tri = torch.tril(torch.ones(NL, NL, dtype=torch.float64))
    a = tjoint.amp.real_m0(tjoint.random_alm_white(
        g, (C, 1, NL, NL)) * tri)
    return tjoint.JointState(
        a=a, t=torch.randn(T, generator=g, dtype=torch.float64),
        p=torch.randn(nsrc, generator=g, dtype=torch.float64))


# JAX references jitted once (configs static, arrays as arguments)
_j_sample_joint_1e6 = jax.jit(partial(jjoint.sample_joint, tol=1e-6,
                                      maxiter=500))
_j_gibbs_step = jax.jit(jgibbs.gibbs_step, static_argnums=0)


def test_operator_rhs_and_preconditioner_match(pb):
    """apply_A_joint, compute_rhs_joint with the JAX key's draws (and the
    Wiener rhs), and the preconditioner's application, against the JAX
    package's, with priors and a pinned row: 1e-10 of each block's max."""
    ts_j, ps_j, ts_t, ps_t = pb.ts_p, pb.ps_p, pb.tsp_t, pb.psp_t
    x = _random_state(3, 3, ts_t.ntemp, 5)
    x_j = jjoint.JointState(a=jnp.asarray(x.a.numpy()),
                            t=jnp.asarray(x.t.numpy()),
                            p=jnp.asarray(x.p.numpy()))
    key = jax.random.PRNGKey(3)
    # the JAX side under one jit (system, plan, rows as arguments)
    A_j, rhs_j, rhs0_j, M_j = jax.jit(lambda s, pl, ts, ps, x, k: (
        jjoint.apply_A_joint(s, pl, ts, ps, x),
        jjoint.compute_rhs_joint(s, pl, ts, ps, k),
        jjoint.compute_rhs_joint(s, pl, ts, ps, None),
        jjoint.build_joint_preconditioner(s, pl, ts, ps)(x)))(
        pb.sys_j, pb.plan_j, ts_j, ps_j, x_j, key)
    got = tjoint.apply_A_joint(pb.sys_t, pb.plan_t, ts_t, ps_t, x)
    for k in ("a", "t", "p"):
        assert _rel(getattr(got, k), getattr(A_j, k)) <= 1e-10, k
    draws = jax_rhs_draws(key, pb.sys_j.data.shape, (3, 1, NL, NL),
                          ts_t.ntemp, 5)
    for ref, dr in ((rhs_j, draws), (rhs0_j, {})):
        got = tjoint.compute_rhs_joint(pb.sys_t, pb.plan_t, ts_t, ps_t,
                                       **dr)
        for k in ("a", "t", "p"):
            assert _rel(getattr(got, k), getattr(ref, k)) <= 1e-10, k
    M_t = tjoint.build_joint_preconditioner(pb.sys_t, pb.plan_t, ts_t, ps_t)
    got, ref = M_t(x), M_j
    for k in ("a", "t", "p"):
        assert _rel(getattr(got, k), getattr(ref, k)) <= 1e-10, k


def test_operator_is_self_adjoint_and_positive(pb):
    """Under joint_dot, with every kind of row: <u, A v> = <A u, v> to 1e-12
    and <u, A u> > 0, and the preconditioner likewise."""
    A = partial(tjoint.apply_A_joint, pb.sys_t, pb.plan_t, pb.tsp_t,
                pb.psp_t)
    M = tjoint.build_joint_preconditioner(pb.sys_t, pb.plan_t, pb.tsp_t,
                                          pb.psp_t)
    u, v = (_random_state(s, 3, pb.tsp_t.ntemp, 5) for s in (1, 2))
    for op in (A, M):
        lhs = float(tjoint.joint_dot(u, op(v)))
        rhs = float(tjoint.joint_dot(op(u), v))
        assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
        assert float(tjoint.joint_dot(u, op(u))) > 0


def test_wiener_mean_matches(pb):
    """sample_joint without draws (md rows and sources with proper priors:
    flat md priors leave the monopole and dipole degenerate with the
    diffuse l <= 1 modes up to the 1e-12 ridge, and two solvers' answers
    part along them): both CGs to 1e-12, the solutions to 1e-8."""
    ts_j, ps_j = _with_priors(pb.ts_j, pb.ps_j, pinned=False)
    ts_t, ps_t = _port(ts_j, ps_j)
    x_t, res_t = tjoint.sample_joint(pb.sys_t, pb.plan_t, ts_t, ps_t,
                                     tol=1e-12, maxiter=2000)
    x_j, res_j = jax.jit(partial(jjoint.sample_joint, tol=1e-12,
                                 maxiter=2000))(pb.sys_j, pb.plan_j, ts_j,
                                                ps_j, key=None)
    assert res_t.converged and bool(res_j.converged)
    for k in ("a", "t", "p"):
        assert _rel(getattr(x_t, k), getattr(x_j, k)) <= 1e-8, k
    # the sky the solution makes is the data's at the noise level
    sky = tjoint._band_maps(pb.sys_t, pb.plan_t, tjoint.JointState(
        tjoint.amp.real_m0(res_t.x.a), res_t.x.t, res_t.x.p), ts_t, ps_t)
    assert float(torch.std(pb.sys_t.data - sky)) < 2.0 * 5.0


# ---------------------------------------------------------------------------
# the draws outside the CG
# ---------------------------------------------------------------------------

def test_template_amp_masked_matches():
    rng = np.random.default_rng(0)
    T, d = rng.standard_normal(NPIX), rng.standard_normal(NPIX)
    inv2 = 1.0 / (0.1 + rng.random(NPIX))
    mask = (np.arange(NPIX) % 3 != 0).astype(float)
    key = jax.random.PRNGKey(4)
    z = torch.as_tensor(np.array(jax.random.normal(key, (), jnp.float64)))
    J, P = jnp.asarray, torch.as_tensor
    for kw in ({}, dict(prior_mean=1.5, prior_std=0.2)):
        ref = jjoint.sample_template_amp_masked(key, J(d), J(T), J(inv2),
                                                J(mask), **kw)
        got = tjoint.sample_template_amp_masked(P(d), P(T), P(inv2),
                                                P(mask), z=z, **kw)
        assert abs(float(got) - float(ref)) <= 1e-8 * abs(float(ref))
        mean_j = jjoint.sample_template_amp_masked(None, J(d), J(T), J(inv2),
                                                   J(mask), sample=False,
                                                   **kw)
        mean_t = tjoint.sample_template_amp_masked(P(d), P(T), P(inv2),
                                                   P(mask), sample=False,
                                                   z=z, **kw)
        assert abs(float(mean_t) - float(mean_j)) <= 1e-8 * abs(
            float(mean_j))


def test_ptsrc_alpha_and_optimize_match(pb):
    """sample_ptsrc_alpha with the JAX key's uniforms (with and without the
    per-source prior) and the Powell fit optimize_ptsrc, on unit stamps and
    a residual with the sources at their amplitudes removed."""
    ps_unit_j = jjoint.gaussian_stamp_ptsrc(
        NSIDE, np.asarray(pb.ps_j.pix[:, 0]), np.ones((3, 5)),
        np.array([600.0, 420.0, 300.0]), npatch=32)
    ps_unit_t = convert.ptsrc_set(_asdict(ps_unit_j), NPIX, device="cpu")
    nur = np.array(FREQS) / 30e9
    rng = np.random.default_rng(9)
    alphas = rng.uniform(-0.5, 0.5, 5)
    amps = np.asarray(pb.p_true) + 10.0
    sky = jjoint._ptsrc_fwd(jjoint.restamp_ptsrc(ps_unit_j, nur,
                                                 jnp.asarray(alphas + 0.2)),
                            jnp.asarray(amps), NPIX)
    res = np.asarray(sky) + rng.standard_normal(sky.shape) \
        - np.asarray(jjoint._ptsrc_fwd(jjoint.restamp_ptsrc(
            ps_unit_j, nur, jnp.asarray(alphas)), jnp.asarray(amps), NPIX))
    inv2 = np.asarray(pb.sys_j.inv_rms2)
    grid = np.linspace(-1.5, 1.5, 48)
    key = jax.random.PRNGKey(6)
    u = jax.random.uniform(key, (5, 1), jnp.float64)[:, 0]
    J, P = jnp.asarray, lambda x: torch.as_tensor(np.array(x))
    for prior in (None, (rng.uniform(-0.3, 0.3, 5), np.full(5, 2.0))):
        pm, pi = (None, None) if prior is None else prior
        ref = jjoint.sample_ptsrc_alpha(
            key, ps_unit_j, J(nur), J(res), J(amps), J(alphas), J(inv2),
            J(grid), None if pm is None else J(pm),
            None if pi is None else J(pi))
        got = tjoint.sample_ptsrc_alpha(
            ps_unit_t, P(nur), P(res), P(amps), P(alphas), P(inv2), P(grid),
            None if pm is None else P(pm), None if pi is None else P(pi),
            u=P(np.array(u)))
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-8
    # restamp against the JAX product
    assert _rel(tjoint.restamp_ptsrc(ps_unit_t, P(nur), P(alphas)).stamp,
                jjoint.restamp_ptsrc(ps_unit_j, nur, J(alphas)).stamp) <= 1e-12
    a_t, al_t = tjoint.optimize_ptsrc(ps_unit_t, P(nur), P(res), P(amps),
                                      P(alphas), P(inv2))
    a_j, al_j = jjoint.optimize_ptsrc(ps_unit_j, J(nur), J(res), J(amps),
                                      J(alphas), J(inv2))
    assert _rel(a_t, a_j) <= 1e-8 and _rel(al_t, al_j) <= 1e-8


# ---------------------------------------------------------------------------
# the Gibbs step, convert, the refusal
# ---------------------------------------------------------------------------

def _gcfg_j(**kw):
    return jgibbs.GibbsConfig(
        cl_cfg=JClModelConfig(kind="binned", lmax=LMAX, nmaps=1,
                              bin_starts=BINS), cg_tol=1e-12,
        cg_maxiter=1000, **kw)


@pytest.mark.parametrize("setting", [dict(cg_precond="pseudoinv"),
                                     dict(cg_lmax_precond=4)])
def test_joint_rows_refuse_another_preconditioner(pb, setting):
    """The JAX joint solve ignores cg_precond / cg_lmax_precond (it always
    takes the diagonal block); the port refuses them rather than ignore
    them, and takes them without joint rows."""
    cfg = dataclasses.replace(convert.gibbs_config(dataclasses.asdict(
        _gcfg_j())), cg_maxiter=3, **setting)
    st = tgibbs.init_state(3, 1, LMAX, len(BINS), device="cpu", ntemp=12,
                           nsrc=5)
    g = torch.Generator()
    g.manual_seed(0)
    for kw in (dict(ts=pb.ts_t), dict(ps=pb.ps_t),
               dict(ts=pb.ts_t, ps=pb.ps_t)):
        with pytest.raises(ValueError, match="diagonal"):
            tgibbs.gibbs_step(cfg, pb.sys_t, pb.plan_t, st, g, **kw)
    assert tgibbs.gibbs_step(cfg, pb.sys_t, pb.plan_t, st, g).it == 1


def test_convert_round_trips(pb):
    """TemplateSet (dense -> planes -> dense), PtsrcSet, JointState and
    GibbsState.t / .p; a system with QU covariance blocks is refused."""
    ts_t = pb.tsp_t
    assert _rel(ts_t.dense(), pb.ts_p.maps) == 0.0
    assert ts_t.planes.shape == (15, NPIX)        # 12 md + relquad x 3
    for k in ("prior_mean", "prior_istd"):
        assert _rel(getattr(ts_t, k), getattr(pb.ts_p, k)) == 0.0
    for k in ("pix", "stamp", "prior_mean", "prior_istd"):
        assert np.array_equal(getattr(pb.psp_t, k).numpy(),
                              np.asarray(getattr(pb.ps_p, k)))
    js = convert.joint_state(dict(a=np.ones((3, 1, NL, NL), complex),
                                  t=np.arange(3.0), p=None), device="cpu")
    assert js.p is None and js.t.tolist() == [0.0, 1.0, 2.0]
    st_j = jgibbs.init_state(jax.random.PRNGKey(0), 3, 1, LMAX, len(BINS),
                             ntemp=4, nsrc=2)
    st_t = convert.gibbs_state(_asdict(st_j), device="cpu")
    assert st_t.t.shape == (4,) and st_t.p.shape == (2,)
    st0 = tgibbs.init_state(3, 1, LMAX, len(BINS), device="cpu")
    assert st0.t is None and st0.p is None
    qu = dataclasses.replace(pb.sys_t, inv_qu=torch.zeros(3, NPIX, 2, 2))
    with pytest.raises(NotImplementedError, match="QU"):
        tjoint.compute_rhs_joint(qu, pb.plan_t, pb.ts_t, None)


def test_ptsrc_forward_adds_each_pixel_once_in_order(pb):
    """The sorted runs: every flat index once in uniq, the runs' lengths
    the multiplicities, and the forward map equal to a plain numpy
    accumulation in stamp order."""
    ps = pb.ps_t
    flat = ps.flat.numpy()
    uniq, counts = np.unique(flat, return_counts=True)
    assert np.array_equal(ps.uniq.numpy(), uniq)
    assert np.array_equal(np.diff(ps.offsets.numpy()), counts)
    p = torch.linspace(1.0, 2.0, 5, dtype=torch.float64)
    ref = np.zeros(3 * NPIX)
    np.add.at(ref, flat, (ps.stamp * p[None, None, :, None]).reshape(-1)
              .numpy())
    assert np.array_equal(tjoint._ptsrc_fwd(ps, p, NPIX).reshape(-1).numpy(),
                          ref)
