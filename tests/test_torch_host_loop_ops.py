"""Two of the host loop's parts against the JAX package, float64 on the
CPU, on test_torch_host_loop.py's problems: the pixel-mixing operator
(F_pix) and the sources' spectral-index step; kept apart from that file so
that they are dealt beside tests/test_sharding.py (ROADMAP "Tier-1
verify"). Tolerances as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from commander_tpu.sampling import amplitude as jamp
from commander_tpu.sampling import chisq as jchisq
from commander_tpu.sampling import gibbs as jgibbs
from commander_tpu.sampling import joint as jjoint
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu_torch.driver import loop
from commander_tpu_torch.sampling import amplitude as tamp
from commander_tpu_torch.sampling import gibbs as tgibbs
from commander_tpu_torch.sampling import joint as tjoint
from commander_tpu_torch.sphere.alm import alm_dot

from test_torch_driver import PARAMS
from test_torch_host_loop import (LMAX, NPIX, NSIDE, T, _catalog, _models,
                                  _pixmix_systems, _rel, reference_form, world)


def test_pixel_mixing_operator_matches(world):
    """_forward_pixmix / _T, apply_A, compute_rhs with the JAX key's draws,
    joint.apply_A_joint and lowres_system with F_pix, to 1e-10; the pair is
    adjoint, and the preconditioner stays on the mean F."""
    sys_j, sys_t = _pixmix_systems(world)
    plan_j, plan_t = world["jout"][0], world["model"].plan
    rng = world["rng"]
    C, S, nl = sys_j.F.shape[1], 3, LMAX + 1
    tri = np.tril(np.ones((nl, nl)))
    u = (rng.standard_normal((C, S, nl, nl))
         + 1j * rng.standard_normal((C, S, nl, nl))) * tri
    u[..., 0] = u[..., 0].real
    g = rng.standard_normal((3, S, NPIX))
    fwd = jax.jit(jamp._forward_pixmix)(sys_j, plan_j, jnp.asarray(u))
    got = tamp._forward_pixmix(sys_t, plan_t, T(u))
    assert _rel(got, fwd) <= 1e-10
    adj = jax.jit(jamp._forward_pixmix_T)(sys_j, plan_j, jnp.asarray(g))
    got_T = tamp._forward_pixmix_T(sys_t, plan_t, T(g))
    assert _rel(got_T, adj) <= 1e-10
    # <F a, g> = <a, F^T g> under the eps metric of the alms
    lhs = float(torch.sum(got * T(g)))
    rhs = float(alm_dot(T(u), got_T))
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)
    assert _rel(tamp.apply_A(sys_t, plan_t, T(u)),
                jax.jit(jamp.apply_A)(sys_j, plan_j, jnp.asarray(u))) \
        <= 1e-10
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    eta1 = jax.random.normal(k1, sys_j.data.shape, jnp.float64)
    eta2 = j_random_alm_white(k2, (C, S, nl, nl), jnp.float64)
    assert _rel(tamp.compute_rhs(sys_t, plan_t, eta1=T(np.asarray(eta1)),
                                 eta2=T(np.asarray(eta2))),
                jax.jit(jamp.compute_rhs)(sys_j, plan_j, key)) <= 1e-10
    # the joint operator: template and source rows beside the pixel mixing
    ts_j, ps_j = world["jout"][9], world["jout"][10]
    ts_t, ps_t = world["model"].ts, world["model"].ps
    t = rng.standard_normal(ts_t.ntemp)
    p = rng.standard_normal(ps_t.pix.shape[0])
    ref = jax.jit(jjoint.apply_A_joint)(sys_j, plan_j, ts_j, ps_j,
                                        jjoint.JointState(
                                            a=jnp.asarray(u),
                                            t=jnp.asarray(t),
                                            p=jnp.asarray(p)))
    out = tjoint.apply_A_joint(sys_t, plan_t, ts_t, ps_t, tjoint.JointState(
        a=T(u), t=T(t), p=T(p)))
    for f in ("a", "t", "p"):
        assert _rel(getattr(out, f), getattr(ref, f)) <= 1e-10, f
    lo_j, _ = jamp.lowres_system(sys_j, 4, 8)
    lo_t, _ = tamp.lowres_system(sys_t, 4, 8)
    assert _rel(lo_t.F_pix, lo_j.F_pix) <= 1e-12
    # the diagonal preconditioner reads the pixel mean F, as the JAX one
    r = T(u)
    assert _rel(tamp.build_preconditioner(sys_t, plan_t)(r),
                jamp.build_preconditioner(sys_j, plan_j)(jnp.asarray(u))) \
        <= 1e-10

def test_ptsrc_alpha_step_matches(tmp_path, reference_form):
    """loop.ptsrc_alpha_step against run.py:2337-2372 composed from the JAX
    package's functions, with its key's uniforms: the new alphas (the
    sources with alpha rms 0 stay), the remade stamps and their priors
    1e-10; then python -m commander_tpu_torch with the catalog draws them
    in its host loop."""
    cat = _catalog(tmp_path / "cat.txt", NSIDE)
    jout, model, jcfg, tcfg = _models(f"--COMP_CATALOG05={cat}")
    plan_j, sys_j, _, _, _, _, meta_j, truth_j, _, ts_j, ps_j, _ = jout
    rng = np.random.default_rng(4)
    t = rng.standard_normal(ts_j.maps.shape[0])
    p = np.asarray(ps_j.prior_mean) + 5 * rng.standard_normal(
        ps_j.pix.shape[0])
    a_j = jnp.asarray(truth_j[0] + 1j * truth_j[1])
    st_j = jgibbs.GibbsState(a=a_j, cl_bins=None, key=None, it=0,
                             cg_iters=0, cg_relres=0.0, t=jnp.asarray(t),
                             p=jnp.asarray(p))
    res = sys_j.data - jchisq.sky_signal(sys_j, plan_j, a_j) \
        - jjoint._templates_fwd(ts_j, st_j.t) \
        - jjoint._ptsrc_fwd(ps_j, st_j.p, NPIX)
    rms = np.asarray(meta_j["ptsrc_alpha_rms"])
    free = rms > 0
    pk = jax.random.PRNGKey(6)
    alphas = np.asarray(meta_j["ptsrc_alpha"], float)
    new = np.asarray(jjoint.sample_ptsrc_alpha(
        pk, meta_j["ptsrc_unit"], jnp.asarray(meta_j["ptsrc_nuratio"]), res,
        st_j.p, jnp.asarray(alphas), sys_j.inv_rms2,
        jnp.linspace(-4.0, 1.0, 64), prior_mean=jnp.asarray(alphas),
        prior_istd=jnp.asarray(np.where(free, 1.0 / np.maximum(rms, 1e-30),
                                        1e30))))
    ref_alpha = np.where(free, new, alphas)
    ref_ps = jjoint.restamp_ptsrc(meta_j["ptsrc_unit"],
                                  jnp.asarray(meta_j["ptsrc_nuratio"]),
                                  jnp.asarray(ref_alpha))
    u = T(np.asarray(jax.random.uniform(pk, (len(alphas), 1),
                                        jnp.float64))[:, 0])
    st_t = tgibbs.GibbsState(a=model.truth, cl_bins=None, t=T(t), p=T(p))
    model2, _ = loop.ptsrc_alpha_step(
        model, tgibbs.GibbsConfig(cl_cfg=model.cl_cfg), model.sys, st_t,
        None, u)
    got = model2.meta["ptsrc_alpha"]
    assert np.abs(got - ref_alpha).max() <= 1e-10
    assert np.array_equal(got[~free], alphas[~free])
    assert not np.allclose(got[free], alphas[free])
    assert _rel(model2.ps.stamp, ref_ps.stamp) <= 1e-10
    assert torch.equal(model2.ps.prior_istd, model.meta["ptsrc_unit"]
                       .prior_istd)
    from commander_tpu_torch import run as trun
    (r,) = trun.main([PARAMS, "--synthetic", "--pol", "--cpu", "--nside",
                      str(NSIDE), "--lmax", str(LMAX), "--niter", "1",
                      "--outdir", str(tmp_path / "out"), "--pixind",
                      f"--COMP_CATALOG05={cat}"])
    from commander_tpu_torch.io.chain import ChainFile
    with ChainFile(r.chain_path, "r") as ch:
        aux = ch.read_sample(1)["aux"]
    assert np.array_equal(aux["ptsrc_alpha"][~free], alphas[~free])
    assert not np.allclose(aux["ptsrc_alpha"][free], alphas[free])
