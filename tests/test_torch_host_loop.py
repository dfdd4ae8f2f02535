"""run()'s host loop in the port, part by part, against the JAX package,
float64 on the CPU at nside 8 / lmax 16 (param_tutorial_full.txt, T/Q/U):

  * the pixel-mixing operator (amplitude._forward_pixmix and its
    transpose, apply_A, compute_rhs, joint.apply_A_joint, lowres_system
    with F_pix) to 1e-10 of the max, and its adjointness, with the sources'
    alpha draw (tests/test_torch_host_loop_ops.py);
  * the model sky under F_pix: the port's form (the operator's own forward
    map) against the reference's (the pixel mean F), and the size of the
    difference (ROADMAP queue 3 item 10);
  * driver/specind: rebuild_mixing in its three cases (1e-12), pixreg_ids
    from its three sources (exact); specind_step branch by branch is in
    tests/test_torch_host_loop_specind.py;
  * the RESAMPLE_CMB move with the JAX keys' draws (1e-10), map-valued
    mixing in pixel chunks;
  * the resume seed: a resumed chain's first draws are not the fresh
    chain's;
  * the float32 CG at nside 1024's signal-to-noise per mode: it fails in
    both packages where float64 converges (ROADMAP queue 3 item 10e;
    tests/test_torch_host_loop_f32.py).

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
from commander_tpu.sampling import chisq as jchisq
from commander_tpu.sampling import mh as jmh
from commander_tpu_torch import convert
from commander_tpu_torch.driver import loop
from commander_tpu_torch.driver import specind as tspec
from commander_tpu_torch.model import mixing as tmix
from commander_tpu_torch.sampling import amplitude as tamp
from commander_tpu_torch.sampling import chisq as tchisq
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import mh as tmh
from commander_tpu_torch.sphere import sht as tsht
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

