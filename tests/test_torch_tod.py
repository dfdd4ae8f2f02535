"""The port's TOD layer (commander_tpu_torch.tod) against the JAX package's
(commander_tpu.tod), float64 on the CPU, at nside 16 with 4 scans x 2
detectors x 1024 samples, temperature only and T/Q/U.

Every function gets the same numpy inputs on both sides; a sampler gets the
JAX key's own draws, regenerated through the function's jax.random splits.
Tolerance: 1e-10 of the reference's max for each function, 1e-8 for a whole
process_tod pass.
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.sphere import healpix as jhp
from commander_tpu.tod import maps4d as jmaps4d
from commander_tpu.tod import model as JM
from commander_tpu.tod import process as JP
from commander_tpu.tod import sim as JS
from commander_tpu_torch import convert
from commander_tpu_torch.sphere import healpix as thp
from commander_tpu_torch.tod import maps4d as tmaps4d
from commander_tpu_torch.tod import model as TM
from commander_tpu_torch.tod import process as TP
from commander_tpu_torch.tod import sim as TS

# small shapes: one torch thread, so that test workers sharing the cores
# do not oversubscribe them
torch.set_num_threads(1)

NSIDE = 16
NPIX = 12 * NSIDE * NSIDE
NS, ND, NT = 4, 2, 1024
F64 = jnp.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _t(x):
    return torch.as_tensor(np.array(x))


def _block_dict(bj):
    d = {k: np.asarray(getattr(bj, k))
         for k in ("tod", "pix", "psi", "mask", "vsun")}
    return dict(d, fsamp=bj.fsamp)


def _sim(nside, pol, seed=1):
    S = 3 if pol else 1
    rng = np.random.default_rng(0)
    sky = rng.standard_normal((3, 12 * nside * nside)) * 50.0 \
        + np.array([100.0, 0.0, 0.0])[:, None]
    bj, truth = JS.simulate_tod(nside, sky[:S], nscan=NS, ndet=ND, ntod=NT,
                                sigma0=0.5, gain0=1.07, fknee=0.3, pol=pol,
                                seed=seed)
    return dict(sky=sky[:S], bj=bj, truth=truth,
                bt=convert.tod_block(_block_dict(bj), device="cpu"),
                pvec=jhp.pix2vec_ring(nside), rng=rng)


@pytest.fixture(scope="module")
def sims():
    return {False: _sim(NSIDE, False), True: _sim(NSIDE, True),
            "mono": _sim(2, False), "mono_pol": _sim(2, True)}


# ---------------------------------------------------------------------------
# geometry and the simulator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nside", [1, 16])
def test_pixel_angles_and_vectors_match(nside):
    for a, b in zip(thp.pix2ang_ring(nside), jhp.pix2ang_ring(nside)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(thp.pix2vec_ring(nside),
                                  jhp.pix2vec_ring(nside))


@pytest.mark.parametrize("pol", [False, True])
def test_simulator_matches(sims, pol):
    """The same numpy draws in the same order and the same nearest-centre
    pointing: the JAX simulator's bits, through the port's projection."""
    s = sims[pol]
    pj, psj = JS.great_circle_scans(NSIDE, NS, ND, NT, seed=1)
    pt, pst = TS.great_circle_scans(NSIDE, NS, ND, NT, seed=1)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(pst, psj)
    bt, tt = TS.simulate_tod(NSIDE, s["sky"], nscan=NS, ndet=ND, ntod=NT,
                             sigma0=0.5, gain0=1.07, fknee=0.3, pol=pol,
                             seed=1, device="cpu")
    assert bt.pix.dtype == torch.int32 and bt.tod.dtype == torch.float64
    for k in ("tod", "pix", "psi", "mask", "vsun"):
        assert _rel(getattr(bt, k), getattr(s["bj"], k)) <= 1e-10, k
    for k in ("ncorr", "s_sky", "s_orb"):
        assert _rel(tt[k], s["truth"][k]) <= 1e-10, k


# ---------------------------------------------------------------------------
# pointing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sky", "sky_per_det", "orbital_dipole",
                                  "orbital_dipole_4pi"])
@pytest.mark.parametrize("pol", [False, True])
def test_pointing_matches(sims, pol, case):
    s = sims[pol]
    bj, bt = s["bj"], s["bt"]
    if case == "sky":
        ref = JM.project_sky(jnp.asarray(s["sky"]), bj.pix, bj.psi, pol)
        got = TM.project_sky(_t(s["sky"]), bt.pix, bt.psi, pol)
    elif case == "sky_per_det":
        maps = s["sky"][None] * np.array([1.0, 1.1])[:, None, None]
        ref = JM.project_sky(jnp.asarray(maps), bj.pix, bj.psi, pol)
        got = TM.project_sky(_t(maps), bt.pix, bt.psi, pol)
    elif case == "orbital_dipole":
        ref = JM.orbital_dipole(bj.vsun, jnp.asarray(s["pvec"]), 44e9,
                                bj.pix)
        got = TM.orbital_dipole(bt.vsun, _t(s["pvec"]), 44e9, bt.pix)
    else:
        th, ph = jhp.pix2ang_ring(NSIDE)
        beam = np.exp(-th ** 2 / (2 * 0.05 ** 2)) * (1 + 0.1 * np.cos(ph))
        mj = JM.beam_moments_orbdipole(jnp.asarray(beam),
                                       jnp.asarray(s["pvec"]))
        mt = TM.beam_moments_orbdipole(_t(beam), _t(s["pvec"]))
        for a, b in zip(mt, mj):
            assert _rel(a, b) <= 1e-10
        R = (_t(th[:5]), _t(ph[:5]), _t(th[5:10]))
        assert _rel(TM._euler_zyz(*R), JM._euler_zyz(
            *(jnp.asarray(np.asarray(x)) for x in R))) <= 1e-10
        ref = JM.orbital_dipole_4pi(bj.vsun, jnp.asarray(th), jnp.asarray(ph),
                                    bj.psi, bj.pix, mj, 70e9)
        got = TM.orbital_dipole_4pi(bt.vsun, _t(th), _t(ph), bt.psi, bt.pix,
                                    mt, 70e9)
    assert _rel(got, ref) <= 1e-10


# ---------------------------------------------------------------------------
# noise: 1/f PSD, n_corr, the PSD sampler
# ---------------------------------------------------------------------------

def _noise_inputs(s):
    bj = s["bj"]
    resid = bj.tod - 1.07 * (jnp.asarray(s["truth"]["s_sky"])
                             + jnp.asarray(s["truth"]["s_orb"]))
    mask = np.asarray(bj.mask).copy()
    mask[1, 0, 300:420] = 0.0          # a gap for the Woodbury solve
    par = lambda v: np.full((NS, ND), v) * (1 + 0.1 * np.arange(ND))
    return (np.asarray(resid), mask, par(0.5), par(-1.5), par(0.3), bj.fsamp)


def _normal(key, shape):
    return np.array(jax.random.normal(key, shape, F64))


@pytest.mark.parametrize("name", ["psd_1f", "sample_ncorr", "mirror",
                                  "ncorr_sm_mean", "ncorr_sm_draw",
                                  "inv_N_white", "noise_psd",
                                  "noise_psd_fixed_sigma0"])
def test_noise_functions_match(sims, name):
    resid, mask, s0, al, fk, fs = _noise_inputs(sims[True])
    J = lambda *a: tuple(jnp.asarray(x) for x in a)
    T = lambda *a: tuple(_t(x) for x in a)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    if name == "psd_1f":
        f = np.fft.rfftfreq(NT, 1.0 / fs)
        ref = JM.psd_1f(*J(f, s0, al, fk))
        got = TM.psd_1f(*T(f, s0, al, fk))
    elif name == "sample_ncorr":
        shp = (NS, ND, NT // 2 + 1)
        ref = JM.sample_ncorr(key, *J(resid, mask, s0, al, fk), fs)
        got = TM.sample_ncorr(*T(resid, mask, s0, al, fk), fs,
                              eta=T(_normal(k1, shp), _normal(k2, shp)))
    elif name == "mirror":
        fm = np.random.default_rng(1).random((NS, ND, NT + 1))
        ref = JM._mirror_fourier_apply(*J(resid, fm))
        got = TM._mirror_fourier_apply(*T(resid, fm))
    elif name == "ncorr_sm_mean":
        ref = JM.sample_ncorr_sm(None, *J(resid, mask, s0, al, fk), fs)
        got = TM.sample_ncorr_sm(*T(resid, mask, s0, al, fk), fs)
    elif name == "ncorr_sm_draw":
        shp = resid.shape
        ref = JM.sample_ncorr_sm(key, *J(resid, mask, s0, al, fk), fs,
                                 n_iter=9)
        got = TM.sample_ncorr_sm(*T(resid, mask, s0, al, fk), fs, n_iter=9,
                                 draws=T(_normal(k1, shp), _normal(k2, shp)))
    elif name == "inv_N_white":
        ref = JM.multiply_inv_N_white(*J(resid, mask, s0))
        got = TM.multiply_inv_N_white(*T(resid, mask, s0))
    else:
        fix = s0 * 1.2 if name == "noise_psd_fixed_sigma0" else None
        cfg = JP.TodConfig(nside=NSIDE, nu=30e9)
        ga, gf = np.asarray(cfg.alpha_grid), np.asarray(cfg.fknee_grid)
        npair = np.maximum((mask[..., 1:] * mask[..., :-1]).sum(-1), 1.0)
        ref = JM.sample_noise_psd(key, *J(resid, mask), fs, *J(ga, gf),
                                  sigma0_fix=None if fix is None
                                  else jnp.asarray(fix))
        got = TM.sample_noise_psd(
            *T(resid, mask), fs, *T(ga, gf), sigma0_fix=fix,
            gamma=np.array(jax.random.gamma(k1, jnp.asarray(npair / 2.0))),
            u=np.array(jax.random.uniform(k2, (NS, ND, 1), F64))[..., 0])
        for g, r in zip(got, ref):
            assert _rel(g, r) <= 1e-10
        # the draws are grid points, and they differ between (scan, det)
        assert len(set(got[1].reshape(-1).tolist()) | set(
            got[2].reshape(-1).tolist())) > 2
        return
    assert _rel(got, ref) <= 1e-10


# ---------------------------------------------------------------------------
# gain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["perscan", "perscan_prior", "smooth",
                                  "wiener_mean", "wiener_draw", "abscal",
                                  "relcal"])
def test_gain_functions_match(sims, name):
    s = sims[True]
    bj = s["bj"]
    s_ref = np.asarray(s["truth"]["s_sky"] + s["truth"]["s_orb"])
    tod, mask = np.asarray(bj.tod), np.asarray(bj.mask)
    s0 = np.full((NS, ND), 0.5) * (1 + 0.2 * np.arange(ND))
    key = jax.random.PRNGKey(11)
    g = 1.0 + 0.01 * np.random.default_rng(2).standard_normal((16, ND))
    sg = 0.003 * (1 + np.arange(ND))[None, :] * np.ones((16, 1))
    if name.startswith("perscan"):
        kw = dict(prior_mean=1.0, prior_istd=30.0) \
            if name == "perscan_prior" else {}
        ref = JM.sample_gain_perscan(key, *map(jnp.asarray, (
            tod, s_ref, mask, s0)), **kw)
        got = TM.sample_gain_perscan(*map(_t, (tod, s_ref, mask, s0)),
                                     eta=_normal(key, (NS, ND)), **kw)
    elif name == "smooth":
        ref = JM.smooth_gain(jnp.asarray(g), 5)
        got = TM.smooth_gain(_t(g), 5)
    elif name.startswith("wiener"):
        sample = name == "wiener_draw"
        kr, ki = jax.random.split(key)
        shp = (16 // 2 + 1, ND)
        ref = JM.smooth_gain_wiener(key, jnp.asarray(g), jnp.asarray(sg),
                                    sample=sample)
        got = TM.smooth_gain_wiener(
            _t(g), _t(sg), sample=sample,
            eta=(_normal(kr, shp), _normal(ki, shp)) if sample else None)
    elif name == "abscal":
        ref = JM.sample_abscal(key, *map(jnp.asarray, (tod, s_ref, mask,
                                                        s0)))
        got = TM.sample_abscal(*map(_t, (tod, s_ref, mask, s0)),
                               eta=_normal(key, ()))
    else:
        resid = tod - 1.07 * s_ref
        ref = JM.sample_relcal(key, *map(jnp.asarray, (resid, s_ref, mask,
                                                        s0)))
        got = TM.sample_relcal(*map(_t, (resid, s_ref, mask, s0)),
                               eta=_normal(key, (ND,)))
        assert abs(float(got.sum())) <= 1e-12
    assert _rel(got, ref) <= 1e-10


# ---------------------------------------------------------------------------
# mapmaking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pol", [False, True])
def test_mapmaking_matches(sims, pol):
    """bin_tod's packed planes, the closed-form solves with their
    determinant check, pack_sym3, and the monopole system and its draw."""
    s = sims[pol]
    bj, bt = s["bj"], s["bt"]
    iv = np.full((NS, ND), 4.0) * (1 + np.arange(ND))
    iv[0, 1] = 0.0                      # a rejected (scan, det)
    key = jax.random.PRNGKey(5)
    Aj, bj_ = JM.bin_tod(bj.tod, bj.pix, bj.psi, bj.mask, jnp.asarray(iv),
                         NPIX, pol)
    At, bt_ = TM.bin_tod(bt.tod, bt.pix, bt.psi, bt.mask, _t(iv), NPIX, pol,
                         runs=TM.pixel_runs(bt.pix, NPIX, chunk=1000))
    assert At.dtype == torch.float64
    assert _rel(At, Aj) <= 1e-10 and _rel(bt_, bj_) <= 1e-10
    outs_j = JM.finalize_binned_map(key, Aj, bj_)
    outs_t = TM.finalize_binned_map(At, bt_,
                                    eta=_normal(key, tuple(bj_.shape)))
    for a, b in zip(outs_t, outs_j):
        assert _rel(a, b) <= 1e-10
    hit = outs_t[1][0] > 0
    assert 0 < float(hit.double().mean()) < 1
    if pol:
        # the determinant check rejects some hit pixels
        assert int((At[0] > 0).sum()) > int(hit.sum())
        A3 = np.random.default_rng(3).standard_normal((7, 3, 3))
        A3 = A3 + A3.transpose(0, 2, 1)
        assert _rel(TM.pack_sym3(_t(A3)), JM.pack_sym3(jnp.asarray(A3))) == 0
    Amj, bmj = JM.bin_tod_mono(bj.tod, bj.pix, bj.psi, bj.mask,
                               jnp.asarray(iv), NPIX, pol)
    Amt, bmt = TM.bin_tod_mono(bt.tod, bt.pix, bt.psi, bt.mask, _t(iv),
                               NPIX, pol)
    assert _rel(Amt, Amj) <= 1e-10 and _rel(bmt, bmj) <= 1e-10


@pytest.mark.parametrize("case", ["T", "T_degenerate", "TQU"])
def test_sample_mono_matches(sims, case):
    """The monopole draw on a usable system, and on a degenerate one (Q ~ 0:
    the previous monopoles are kept), at nside 2, where every hit pixel's
    Stokes block is well conditioned: the reference solves singular blocks
    (fewer than three angles) without a guard, and two LU solvers give
    different garbage there."""
    s = sims["mono_pol" if case == "TQU" else "mono"]
    bj = s["bj"]
    k = 3 if case == "TQU" else 1
    npix = 12 * 2 ** 2
    iv = np.full((NS, ND), 4.0)
    if case == "T_degenerate":
        iv[:] = 0.0
    tod = np.asarray(bj.tod) + np.array([0.4, -0.4])[None, :, None]
    A, b = JM.bin_tod_mono(jnp.asarray(tod), bj.pix, bj.psi, bj.mask,
                           jnp.asarray(iv), npix, k == 3)
    key = jax.random.PRNGKey(9)
    m0 = np.array([0.1, -0.1])
    mj, okj = JM.sample_mono(key, A, b, k, mono0=jnp.asarray(m0))
    mt, okt = TM.sample_mono(_t(A), _t(b), k, mono0=m0,
                             eta=_normal(key, (ND - 1,)))
    assert float(okt) == float(okj) == (0.0 if case == "T_degenerate"
                                        else 1.0)
    assert _rel(mt, mj) <= 1e-10


def test_bin_4d_matches(sims):
    s = sims[True]
    bj, bt = s["bj"], s["bt"]
    iv = np.full((NS, ND), 2.0)
    ref = jmaps4d.bin_4d(bj.tod, bj.pix, bj.psi, bj.mask, jnp.asarray(iv),
                         NPIX, 8)
    got = tmaps4d.bin_4d(bt.tod, bt.pix, bt.psi, bt.mask, _t(iv), NPIX, 8)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= 1e-10


# ---------------------------------------------------------------------------
# the whole pass
# ---------------------------------------------------------------------------

def jax_pass_draws(key, cfg, bj, npix):
    """process_tod's draws from its key, through the reference's splits."""
    k_g, k_n, k_p, k_b, k_a, k_r, k_w = jax.random.split(key, 7)
    Ns, Nd, Nt = bj.tod.shape
    d = {"gain": _normal(k_g, (Ns, Nd)), "abscal": _normal(k_a, ()),
         "relcal": _normal(k_r, (Nd,))}
    kr, ki = jax.random.split(k_w)
    d["smooth"] = (_normal(kr, (Ns // 2 + 1, Nd)),
                   _normal(ki, (Ns // 2 + 1, Nd)))
    k1, k2 = jax.random.split(k_p)
    m2 = bj.mask[..., 1:] * bj.mask[..., :-1]
    npair = jnp.maximum(jnp.sum(m2, -1), 1.0)
    d["psd_gamma"] = np.array(jax.random.gamma(k1, npair / 2.0))
    d["psd_u"] = np.array(jax.random.uniform(k2, (Ns, Nd, 1), F64))[..., 0]
    k1, k2 = jax.random.split(k_n)
    shp = (Ns, Nd, Nt) if cfg.ncorr_exact else (Ns, Nd, Nt // 2 + 1)
    d["ncorr"] = (_normal(k1, shp), _normal(k2, shp))
    if cfg.sample_mono:
        k_b, k_m = jax.random.split(k_b)
        d["mono"] = _normal(k_m, (Nd - 1,))
    d["bin"] = _normal(k_b, (3 if cfg.pol else 1, npix))
    return d


def _states(bj, rng):
    st = JP.init_tod_state(bj)
    st = dataclasses.replace(st, n_corr=jnp.asarray(
        0.1 * rng.standard_normal(bj.tod.shape)))
    return st, convert.tod_state({f.name: np.asarray(getattr(st, f.name))
                                  for f in dataclasses.fields(st)},
                                 device="cpu")


@pytest.mark.parametrize("variant", ["plain", "ncorr_exact", "sample_mono",
                                     "s_extra"])
@pytest.mark.parametrize("pol", [False, True])
def test_process_tod_matches(sims, pol, variant):
    """One TOD pass with the JAX key's draws: the new state and every
    product to 1e-8 (polarized with sample_mono at nside 2, see
    test_sample_mono_matches)."""
    s = sims["mono_pol" if pol and variant == "sample_mono" else pol]
    nside = 2 if pol and variant == "sample_mono" else NSIDE
    npix = 12 * nside * nside
    bj, bt = s["bj"], s["bt"]
    rng = np.random.default_rng(4)
    cfg = JP.TodConfig(nside=nside, nu=44e9, pol=pol,
                       ncorr_exact=variant == "ncorr_exact",
                       sample_mono=variant == "sample_mono",
                       chisq_reject_sigma=3.0)
    st_j, st_t = _states(bj, rng)
    sky = s["sky"] * 1.01
    extra = rng.standard_normal(bj.tod.shape) if variant == "s_extra" \
        else None
    mono = np.array([0.3, -0.2]) if variant == "sample_mono" else None
    opt_j = lambda x: None if x is None else jnp.asarray(x)
    opt_t = lambda x: None if x is None else _t(x)
    key = jax.random.PRNGKey(3)
    new_j, prod_j = JP.process_tod(cfg, bj, st_j, jnp.asarray(sky),
                                   jnp.asarray(s["pvec"]), key, None,
                                   opt_j(extra), opt_j(mono))
    cfg_t = convert.tod_config(dataclasses.asdict(cfg))
    new_t, prod_t = TP.process_tod(cfg_t, bt, st_t, _t(sky), _t(s["pvec"]),
                                   s_extra=opt_t(extra), mono=opt_t(mono),
                                   draws=jax_pass_draws(key, cfg, bj, npix))
    for f in dataclasses.fields(new_j):
        assert _rel(getattr(new_t, f.name), getattr(new_j, f.name)) <= 1e-8
    # mono_ok (sample_mono's usable flag) is the port's own product
    assert set(prod_t) - {"mono_ok"} == set(prod_j)
    assert ("mono_ok" in prod_t) == (variant == "sample_mono")
    for k in prod_j:
        assert _rel(prod_t[k], prod_j[k]) <= 1e-8, k
    # the pass moved the state, and the (tight) chi^2 cut is exercised
    assert float((new_t.n_corr - st_t.n_corr).abs().max()) > 0
    if variant == "plain":
        assert 0.0 <= float(prod_t["accept"].mean()) <= 1.0


@pytest.mark.parametrize("pol", [False, True])
def test_chisq_static_signal_and_init_state_match(sims, pol):
    s = sims[pol]
    bj, bt = s["bj"], s["bt"]
    cfg = JP.TodConfig(nside=NSIDE, nu=70e9, pol=pol)
    cfg_t = convert.tod_config(dataclasses.asdict(cfg))
    st_j, st_t = _states(bj, np.random.default_rng(6))
    mono = np.array([0.2, 0.1])
    pv = s["pvec"]
    assert _rel(TP.static_signal(cfg_t, bt, _t(pv), mono=_t(mono)),
                JP.static_signal(cfg, bj, jnp.asarray(pv),
                                 mono=jnp.asarray(mono))) <= 1e-10
    for per_det in (False, True):
        got = TP.tod_chisq(cfg_t, bt, st_t, _t(s["sky"]), _t(pv),
                           mono=_t(mono), per_det=per_det)
        ref = JP.tod_chisq(cfg, bj, st_j, jnp.asarray(s["sky"]),
                           jnp.asarray(pv), mono=jnp.asarray(mono),
                           per_det=per_det)
        assert _rel(got, ref) <= 1e-10
    for f in dataclasses.fields(st_j):
        if f.name != "n_corr":
            assert _rel(getattr(TP.init_tod_state(bt), f.name),
                        getattr(JP.init_tod_state(bj), f.name)) <= 1e-10


def test_polarized_tod_pass_updates_the_system_as_run_py(sims):
    """tod_pass on a T/Q/U system against run.py's update
    (run.py:2187-2201) of process_tod's products, with scan rejection on:
    where a pixel's 3x3 system was solved every Stokes row takes the binned
    map and 1/rms, elsewhere inv_rms 0 and the old data."""
    from commander_tpu_torch.sampling import amplitude as tamp
    from commander_tpu_torch.sampling import tod_gibbs

    s = sims[True]
    bj = s["bj"]
    rng = np.random.default_rng(1)
    data = s["sky"][None] + rng.standard_normal((1, 3, NPIX))
    cfg = JP.TodConfig(nside=NSIDE, nu=44e9, pol=True)
    st_j, st_t = _states(bj, rng)
    key = jax.random.PRNGKey(4)
    _, prod = JP.process_tod(cfg, bj, st_j, jnp.asarray(s["sky"]),
                             jnp.asarray(s["pvec"]), key)
    pm, pr = np.asarray(prod["map"]), np.asarray(prod["rms"])
    d_j, rms = data.copy(), np.ones_like(data)
    for s_i in range(3):
        hit = pr[s_i] > 0
        d_j[0, s_i, hit] = pm[s_i][hit]
        rms[0, s_i, hit] = pr[s_i][hit]
        rms[0, s_i, ~hit] = 0.0
    ir_j = np.where(rms > 0, 1.0 / np.where(rms > 0, rms, 1.0), 0.0)
    sys_t = tamp.build_system(np.ones((1, 1)), np.ones((1, 3, 9)),
                              np.ones_like(data), np.ones((1, 3, 9)),
                              torch.as_tensor(data))
    band = tod_gibbs.TodBand(convert.tod_config(dataclasses.asdict(cfg)),
                             s["bt"], st_t, {})
    _, sys_1 = tod_gibbs.tod_pass(
        [band], sys_t, _t(s["sky"])[None],
        draws=[jax_pass_draws(key, cfg, bj, NPIX)])
    assert _rel(sys_1.data, d_j) <= 1e-8
    assert _rel(sys_1.inv_rms, ir_j) <= 1e-8
    assert _rel(sys_1.inv_rms2, ir_j ** 2) <= 1e-8
    solved = ir_j[0, 0] > 0
    assert (ir_j[0, 1:] > 0).tolist() == [solved.tolist()] * 2
    assert 0.05 < solved.mean() < 0.9


def test_sidelobe_term_is_refused(sims):
    """A band that carries sidelobe inputs refuses a pass without their
    f-maps (tod_gibbs.band_sl_fmaps makes them); with them the pass adds
    the term (tests/test_torch_conviqt_zodi.py holds it against JAX)."""
    from commander_tpu_torch.sampling import tod_gibbs
    from commander_tpu_torch.sphere import sht as tsht

    s = sims[False]
    cfg = TP.TodConfig(nside=NSIDE, nu=30e9)
    band = tod_gibbs.TodBand(cfg, s["bt"], TP.init_tod_state(s["bt"]), {},
                             sl_blm=torch.zeros(ND, 5, 2,
                                                dtype=torch.complex128),
                             sl_plan=tsht.get_plan(2, 4, device="cpu"),
                             sl_tables=[], sl_pix=s["bt"].pix // 64)
    assert band.has_templates
    with pytest.raises(ValueError, match="f-maps"):
        tod_gibbs._band_pass(band, _t(s["sky"]), True, torch.Generator(),
                             None)
    fm = torch.zeros(ND, 2, 2, 48, dtype=torch.float64)
    fm[:, 0, 0] = 1.0
    _, prod = tod_gibbs._band_pass(band, _t(s["sky"]), True,
                                   torch.Generator().manual_seed(0), None, fm)
    assert torch.isfinite(prod["map"]).all()
    assert _rel(TP.static_signal(cfg, s["bt"], _t(s["pvec"]), fm,
                                 sl_pix=band.sl_pix)
                - TP.static_signal(cfg, s["bt"], _t(s["pvec"])),
                np.ones(s["bj"].tod.shape)) <= 1e-12


def test_convert_round_trip(sims):
    bj = sims[True]["bj"]
    bt = convert.tod_block(dict(_block_dict(bj), satpos=np.ones((NS, 2))),
                           device="cpu")
    assert bt.pix.dtype == torch.int32 and bt.satpos.shape == (NS, 2)
    assert (bt.nscan, bt.ndet, bt.ntod) == (NS, ND, NT)
    for k in ("tod", "pix", "psi", "mask", "vsun"):
        np.testing.assert_array_equal(getattr(bt, k).numpy(),
                                      np.asarray(getattr(bj, k)))
    cfg = JP.TodConfig(nside=8, nu=30e9, pol=True, ncorr_exact=True,
                       fknee_grid=(0.1, 0.2))
    # mono_guard is the port's own field, off unless asked for
    got = dataclasses.asdict(convert.tod_config(dataclasses.asdict(cfg)))
    assert got.pop("mono_guard") is False
    assert got == dataclasses.asdict(cfg)
    st = JP.init_tod_state(bj)
    st_t = convert.tod_state({f.name: np.asarray(getattr(st, f.name))
                              for f in dataclasses.fields(st)}, device="cpu")
    for f in dataclasses.fields(st):
        np.testing.assert_array_equal(getattr(st_t, f.name).numpy(),
                                      np.asarray(getattr(st, f.name)))
    moved = bt.to("cpu", torch.float32)
    assert moved.tod.dtype == torch.float32 and moved.pix.dtype == torch.int32


@pytest.mark.parametrize("chunk", [2, 64])
def test_pixel_runs_sum_each_pixel_in_sample_order(chunk):
    """The sorted runs give every pixel's sum, empty runs 0, and keep the
    samples of a pixel in their original order (a stable sort), in one
    chunk or in chunks of pixels."""
    keys = torch.tensor([3, 1, 3, 0, 1, 3], dtype=torch.int32)
    runs = TM.pixel_runs(keys, 5, chunk=chunk)
    assert runs.order.tolist() == [3, 1, 4, 0, 2, 5]
    assert runs.offsets.tolist() == [0, 1, 3, 3, 6, 6]
    assert len(runs.chunks) == (3 if chunk == 2 else 1)
    assert [c[2:] for c in runs.chunks] == (
        [(0, 1), (1, 3), (3, 6)] if chunk == 2 else [(0, 6)])
    v = torch.arange(6, dtype=torch.float64) + 1.0
    got = TM._run_sums(runs, lambda idx: torch.stack(
        [v.index_select(0, idx), v.index_select(0, idx) ** 2], 1), 2)
    assert got.tolist() == [[4.0, 7.0, 0.0, 10.0, 0.0],
                            [16.0, 29.0, 0.0, 46.0, 0.0]]


def test_tod_path_has_no_float_atomics():
    """index_add_, scatter_add_ and index_put_ with accumulate add with
    float atomics on the card (bits that vary from run to run): the TOD
    path uses none of them."""
    pat = re.compile(r"index_add|scatter_add|scatter_reduce|"
                     r"accumulate\s*=\s*True|bincount")
    files = [os.path.join(ROOT, "commander_tpu_torch", "tod", n)
             for n in ("model.py", "process.py", "sim.py", "maps4d.py",
                       "differential.py")]
    files.append(os.path.join(ROOT, "commander_tpu_torch", "sampling",
                              "tod_gibbs.py"))
    for path in files:
        with open(path) as f:
            src = "\n".join(ln.split("#")[0] for ln in f.read().splitlines())
        src = re.sub(r'"""[\s\S]*?"""', "", src)
        assert pat.search(src) is None, path
