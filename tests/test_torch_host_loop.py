"""run()'s host loop in the port, part by part, against the JAX package,
float64 on the CPU at nside 8 / lmax 16 (param_tutorial_full.txt, T/Q/U):

  * the pixel-mixing operator (amplitude._forward_pixmix and its
    transpose, apply_A, compute_rhs, joint.apply_A_joint, lowres_system
    with F_pix) to 1e-10 of the max, and its adjointness;
  * the model sky under F_pix: the port's form (the operator's own forward
    map) against the reference's (the pixel mean F), and the size of the
    difference (ROADMAP queue 3 item 10);
  * driver/specind: rebuild_mixing in its three cases (1e-12), pixreg_ids
    from its three sources (exact); specind_step branch by branch is in
    tests/test_torch_host_loop_specind.py;
  * the RESAMPLE_CMB move and the sources' alpha draw with the JAX keys'
    draws (1e-10), map-valued mixing in pixel chunks;
  * the resume seed: a resumed chain's first draws are not the fresh
    chain's;
  * the float32 CG at nside 1024's signal-to-noise per mode: it fails in
    both packages where float64 converges (ROADMAP queue 3 item 10e).

The JAX side runs as the JAX package's own tests run it (no Pallas kernel is
reached at this size: the Legendre tables serve the transforms).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu.sampling import amplitude as jamp
from commander_tpu.sampling import chisq as jchisq
from commander_tpu.sampling import gibbs as jgibbs
from commander_tpu.sampling import joint as jjoint
from commander_tpu.sampling import mh as jmh
from commander_tpu.sphere import sht as jsht
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu_torch import convert
from commander_tpu_torch.driver import loop
from commander_tpu_torch.driver import specind as tspec
from commander_tpu_torch.model import mixing as tmix
from commander_tpu_torch.sampling import amplitude as tamp
from commander_tpu_torch.sampling import chisq as tchisq
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import gibbs as tgibbs
from commander_tpu_torch.sampling import joint as tjoint
from commander_tpu_torch.sampling import mh as tmh
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.sphere.alm import alm_dot
from test_torch_driver import PARAMS, _cfgs, _port_model, _truth

torch.set_num_threads(2)

NSIDE, LMAX = 8, 16
NPIX = 12 * NSIDE ** 2
T = torch.as_tensor


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _abs(got, ref):
    """max |got - ref| in units of max(1, |ref|)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    assert np.shape(got) == np.shape(ref), (np.shape(got), np.shape(ref))
    return float(np.max(np.abs(got - ref) / np.maximum(1.0, np.abs(ref))))


def _fields(obj):
    return {f.name: (None if getattr(obj, f.name) is None
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


@pytest.fixture
def reference_form(monkeypatch):
    """run()'s forms of the two declared divergences: the model sky under
    F_pix at the pixel mean F, the index phase's amplitude maps by the
    spin-0 transform."""
    monkeypatch.setattr(tchisq, "_REFERENCE_FORM", True)
    monkeypatch.setattr(tfg, "_amp_synth", tsht.alm2map)


def _models(*overrides, data_dir=None):
    """(JAX build_model tuple, port Model, jcfg, tcfg) at NSIDE / LMAX."""
    jcfg, tcfg = _cfgs(*overrides)
    jout, truth = _truth(jcfg, NSIDE, LMAX)
    return jout, _port_model(tcfg, truth, NSIDE, LMAX), jcfg, tcfg


@pytest.fixture(scope="module")
def world():
    jout, model, jcfg, tcfg = _models()
    rng = np.random.default_rng(41)
    # indices with spread: synch beta and dust beta as maps
    maps = {(1, 0): -3.1 + 0.3 * np.tanh(rng.standard_normal(NPIX)),
            (2, 0): 1.6 + 0.2 * np.tanh(rng.standard_normal(NPIX))}
    return dict(jout=jout, model=model, jcfg=jcfg, tcfg=tcfg, maps=maps,
                rng=rng)


def _thetas(diffuse, maps, to=lambda x: x):
    return [[to(maps[(ci, j)]) if (ci, j) in maps else t
             for j, t in enumerate(d.theta0)]
            for ci, d in enumerate(diffuse)]


def _pixmix_systems(w):
    """The JAX system with F_pix from _rebuild_mixing at the map thetas,
    and its port copy (convert.amplitude_system)."""
    jout = w["jout"]
    sys_j = jrun._rebuild_mixing(
        jout[2], jout[3], [tuple(t) for t in _thetas(jout[2], w["maps"])],
        None, jout[1])
    return sys_j, convert.amplitude_system(_fields(sys_j), device="cpu")


# --- the pixel-mixing operator ----------------------------------------------

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


def test_pixel_mixing_sky_form(world):
    """The model sky under F_pix (ROADMAP queue 3 item 10): the port's is
    the operator's forward map _forward_pixmix; with _REFERENCE_FORM it is
    run()'s, the projection at the pixel mean F (1e-10 against
    commander_tpu's sky_signal). On index maps with a spread of ~0.3 (synch
    and dust beta) the two differ by 13-17% of the sky's max per band at
    nside 8 (the size is printed); the test holds it above 0.1%."""
    sys_j, sys_t = _pixmix_systems(world)
    plan_j, plan_t = world["jout"][0], world["model"].plan
    a = world["model"].truth
    port = tchisq.sky_signal(sys_t, plan_t, a, exclude=0)
    a0 = a.clone()
    a0[0] = 0
    assert torch.equal(port, tamp._forward_pixmix(sys_t, plan_t, a0))
    jt = world["jout"][7]
    ref = jchisq.sky_signal(sys_j, plan_j, jnp.asarray(jt[0] + 1j * jt[1]),
                            exclude=0)
    tchisq._REFERENCE_FORM = True
    try:
        mean_f = tchisq.sky_signal(sys_t, plan_t, a, exclude=0)
    finally:
        tchisq._REFERENCE_FORM = False
    assert _rel(mean_f, ref) <= 1e-10
    size = [float(torch.max(torch.abs(port[b] - mean_f[b]))
                  / torch.max(torch.abs(port[b]))) for b in range(3)]
    print(f"F_pix sky: |forward map - mean-F projection| / max, per band "
          f"{['%.3g' % x for x in size]}")
    assert min(size) > 1e-3


# --- driver/specind: mixing rebuild and region ids --------------------------

@pytest.mark.parametrize("case", ["scalar", "per_stokes", "map"])
def test_rebuild_mixing_matches(world, case):
    """F from scalar thetas, per Stokes from per-group scalars, F_pix and its
    mean from maps (a map in a higher Stokes group too): 1e-12."""
    jout, model = world["jout"], world["model"]
    diffuse_j, bps_j = jout[2], jout[3]
    maps = world["maps"] if case == "map" else {(1, 0): -2.95}
    th_j = _thetas(diffuse_j, maps)
    th_t = _thetas(model.diffuse, maps,
                   lambda x: T(np.asarray(x, np.float64)))
    pol_j = pol_t = poltypes = None
    if case != "scalar":
        poltypes = [[2 if (ci, j) == (1, 0) else 1 for j in range(len(d))]
                    for ci, d in enumerate(th_j)]
        v = maps[(1, 0)] + 0.05 if case == "map" else -2.8
        pol_j = {(1, 0): [v]}
        pol_t = {(1, 0): [T(np.asarray(v, np.float64))]}
    ref = jrun._rebuild_mixing(diffuse_j, bps_j, [tuple(t) for t in th_j],
                               None, jout[1], thetas_pol=pol_j,
                               poltypes=poltypes)
    got = tspec.rebuild_mixing(model.diffuse, model.bps, th_t, model.sys,
                               thetas_pol=pol_t, poltypes=poltypes)
    assert _rel(got.F, ref.F) <= 1e-12
    if case == "map":
        assert _rel(got.F_pix, ref.F_pix) <= 1e-12
    else:
        assert got.F_pix is None and ref.F_pix is None
    if case == "per_stokes":
        assert not np.allclose(np.asarray(ref.F)[:, 1, 0],
                               np.asarray(ref.F)[:, 1, 1])


def _region_map(path, nside, nreg, zeros=True):
    """A 1-indexed region map (0 = not sampled) written as FITS."""
    from commander_tpu.io import fits as jfits
    npix = 12 * nside ** 2
    m = 1 + (np.arange(npix) * nreg) // npix
    if zeros:
        m[::7] = 0
    jfits.write_map(str(path), m[None].astype(np.float64))
    return str(path)


@pytest.mark.parametrize("source", ["file_down", "file_up", "healpix",
                                    "bands"])
def test_pixreg_ids_match(world, tmp_path, source):
    """The region ids of every source, exactly: a region map at nside 16
    (ud-graded down) or 4 (copied up), HEALPix pixels (npr 48), equal-count
    latitude bands (npr 5). A named map that is missing raises, and warns
    in a synthetic run."""
    npr = {"healpix": 48, "bands": 5}.get(source, 6)
    info = {}
    if source.startswith("file"):
        ns = 16 if source == "file_down" else 4
        info["pixreg_map"] = os.path.basename(
            _region_map(tmp_path / "reg.fits", ns, npr))
    plan = world["jout"][0]
    ref = jrun._pixreg_ids(plan, info, npr, data_dir=str(tmp_path))
    got = tspec.pixreg_ids(NSIDE, info, npr, data_dir=str(tmp_path))
    assert got.dtype == np.int32 and np.array_equal(got, ref)
    assert (got.min() == -1) == source.startswith("file")
    if source == "bands":
        missing = {"pixreg_map": "nope.fits"}
        with pytest.raises(FileNotFoundError):
            tspec.pixreg_ids(NSIDE, missing, npr, data_dir=str(tmp_path))
        with pytest.warns(UserWarning, match="synthetic run"):
            assert np.array_equal(tspec.pixreg_ids(
                NSIDE, missing, npr, str(tmp_path), synthetic=True), ref)


# --- the MH move, the sources' indices, chunked mixing -----------------------

def test_joint_alm_cl_move_matches(world):
    """mh.sample_joint_alm_cl with the JAX key's draws, accepted and
    rejected: (a', cl_bins', accepted) to 1e-10."""
    jout, model = world["jout"], world["model"]
    jt = jout[7]
    a_j = jnp.asarray(jt[0] + 1j * jt[1])
    C, S = a_j.shape[:2]
    bins = np.abs(world["rng"].standard_normal((C, S, 10))) + 1.0
    cc = model.cl_cfgs[0]
    for step, key in ((0.05, jax.random.PRNGKey(8)),
                      (3.0, jax.random.PRNGKey(9))):
        ref = jmh.sample_joint_alm_cl(key, jout[11][0], jout[1], jout[0],
                                      a_j, jnp.asarray(bins), 0, step)
        k1, k2 = jax.random.split(key)
        draws = {"eps": T(np.asarray(jax.random.normal(
            k1, (S, 10), jnp.float64))),
            "u": T(np.asarray(jax.random.uniform(k2, (), jnp.float64)))}
        got = tmh.sample_joint_alm_cl(cc, model.sys, model.plan, model.truth,
                                      T(bins), 0, step, draws=draws)
        assert bool(got[2]) == bool(ref[2])
        assert _rel(got[0], ref[0]) <= 1e-10
        assert _rel(got[1], ref[1]) <= 1e-10


def _catalog(path, nside, n=6):
    rng = np.random.default_rng(2)
    rows = []
    for i in range(n):
        rows.append(f"{rng.uniform(0, 360):.3f} {rng.uniform(-60, 60):.3f} "
                    f"{rng.uniform(50, 150):.2f} 20.0 "
                    f"{rng.uniform(-0.8, 0.2):.3f} 0.0 "
                    f"{0.3 if i % 3 else 0.0:.2f}")
    path.write_text("\n".join(rows) + "\n")
    return str(path)


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


def test_mixing_element_of_maps_in_pixel_chunks(monkeypatch):
    """A map-valued theta with a multi-frequency bandpass goes through the
    pixels in chunks: the values of one piece."""
    from commander_tpu_torch.instrument.bandpass import tophat_bandpass
    comp = tmix.DiffuseComponent("dust", "MBB", 545e9, theta0=(1.6, 19.6))
    bp = tophat_bandpass(353e9, 0.2)
    beta = T(np.random.default_rng(1).uniform(1.2, 2.0, 1000))
    whole = tmix.mixing_element(comp, bp, (beta, 19.6), device="cpu")
    nfreq = bp.weights(0.0, device="cpu")[0].shape[-1]
    monkeypatch.setattr(tmix, "MIX_CHUNK_BYTES", 8 * nfreq * 77)
    part = tmix.mixing_element(comp, bp, (beta, 19.6), device="cpu")
    assert nfreq > 1 and torch.equal(part, whole)


# --- the resume seed ---------------------------------------------------------

def test_resumed_chain_does_not_repeat_the_fresh_draws(tmp_path,
                                                       monkeypatch):
    """A resume seeds its generator with the resume point folded in (as
    run() folds it into its state key): its first attempt's draws are not
    the fresh chain's first attempt's, and two resumes draw the same."""
    import shutil

    seen = []
    real = loop.sky_phase

    def spy(cfg, model, gcfg, slots, sys, state, thetas, gains, it, masks,
            generator, *a):
        clone = torch.Generator().set_state(generator.get_state())
        seen.append(torch.rand(4, generator=clone, dtype=torch.float64))
        return real(cfg, model, gcfg, slots, sys, state, thetas, gains, it,
                    masks, generator, *a)

    monkeypatch.setattr(loop, "sky_phase", spy)
    argv = [PARAMS, "--synthetic", "--cpu", "--nside", "4", "--lmax", "8"]
    from commander_tpu_torch import run as trun
    trun.main(argv + ["--niter", "2", "--outdir", str(tmp_path / "f")])
    fresh = seen[:]
    for k in ("r1", "r2"):
        os.makedirs(tmp_path / k)
        shutil.copy(tmp_path / "f" / "chain_c0001.h5", tmp_path / k)
        trun.main(argv + ["--niter", "3", "--outdir", str(tmp_path / k)])
    r1, r2 = seen[2:4], seen[4:6]
    assert len(fresh) == 2 and len(r1) == 2
    assert not torch.equal(r1[0], fresh[0])
    assert torch.equal(r1[0], r2[0])
    assert loop.chain_seed(4321, 1, 1) != loop.chain_seed(4321, 1)


# --- float32 at full width's signal-to-noise ---------------------------------

@pytest.mark.parametrize("noise", [1.0, 1.0 / 128])
def test_float32_cg_at_full_width_signal_to_noise(world, noise):
    """The file's whole model (five components on three bands, T/Q/U) with
    its noise rms scaled by `noise`: 1/128 gives each mode at nside 8 the
    signal-to-noise of nside 1024 at the file's rms (12 * 1024^2 / 768 =
    128^2 times the pixels). There the directions the data fix weigh ~1e8
    against those the priors alone fix, past what float32 vectors hold:
    the port's float32 CG breaks down or stalls and the JAX package's
    stalls, far from the tolerance, where float64 converges in a few
    iterations in both; at the file's own rms float32 converges too."""
    f = _fields(world["jout"][1])
    f["inv_rms2"] = f["inv_rms2"] / noise ** 2
    f["inv_rms"] = f["inv_rms"] / noise
    rng = np.random.default_rng(5)
    C, S, nl = f["F"].shape[1], 3, LMAX + 1
    eta1 = rng.standard_normal(f["data"].shape)
    eta2 = (rng.standard_normal((C, S, nl, nl))
            + 1j * rng.standard_normal((C, S, nl, nl))) * np.tril(
                np.ones((nl, nl)))
    eta2[..., 0] = eta2[..., 0].real
    f32 = {k: (v.astype(np.float32) if v is not None and v.dtype == np.float64
               else v) for k, v in f.items()}
    got = {}
    for name, fields, dt in (("f64", f, torch.float64),
                             ("f32", f32, torch.float32)):
        sys_t = convert.amplitude_system(fields, device="cpu")
        plan_t = tsht.get_plan(NSIDE, LMAX, spin2=True, dtype=dt,
                               device="cpu")
        cdt = torch.complex128 if dt == torch.float64 else torch.complex64
        _, res = tamp.sample_amplitudes(sys_t, plan_t, eta1=T(eta1).to(dt),
                                        eta2=T(eta2).to(cdt), tol=1e-6,
                                        maxiter=100)
        got["port_" + name] = res
        sys_j = jamp.AmplitudeSystem(**{
            k: None if v is None else jnp.asarray(v)
            for k, v in fields.items()})
        plan_j = jsht.get_plan(NSIDE, LMAX, spin2=True,
                               dtype="float64" if dt == torch.float64
                               else "float32")
        _, res_j = jax.jit(lambda s, p: jamp.sample_amplitudes(
            s, p, jax.random.PRNGKey(1), tol=1e-6, maxiter=100))(sys_j, plan_j)
        got["jax_" + name] = res_j
    for k in ("port_f64", "jax_f64"):
        assert bool(got[k].converged) and int(got[k].iters) <= 10, k
    if noise == 1.0:
        for k in ("port_f32", "jax_f32"):
            assert bool(got[k].converged) and int(got[k].iters) <= 10, k
    else:
        for k in ("port_f32", "jax_f32"):
            assert float(got[k].rel_res) > 1e-3, (k, float(got[k].rel_res))
