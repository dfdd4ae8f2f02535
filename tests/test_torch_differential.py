"""The port's differential-horn (WMAP-style) TOD (commander_tpu_torch.tod.
differential) against the JAX package's (commander_tpu.tod.differential),
float64 on the CPU, at nside 16 with 4 scans x 2 detectors x 1024 samples,
temperature only and T/Q/U.

Every part gets the same numpy inputs on both sides; the samplers get the
JAX key's own draws, regenerated through process_tod_diff's jax.random
splits (jax_diff_pass_draws). Tolerances: the projection and its adjoint to
1e-12 of the reference's max, and adjointness to 1e-12 of the inner
product (both are sums of a few products per sample, float64 rounding);
the mapmaker 1e-10 with the same CG iteration count (its tol 1e-8 stops
both solvers at the same iteration, and their iterates differ by the
summation order of the adjoint's float64 sums: ~1e-15 of the map after
its ~40 iterations); sample_imbalance 1e-12 (a ratio of two sums);
the simulator's data bit for bit (the same numpy draws, the same
gathers and cosines); a whole pass 1e-8 (as a process_tod pass is held:
the mapmaker's CG and the noise-PSD grid's exponentials amplify 1e-14 by
up to 1e5). Each JAX reference is jitted once.

On T/Q/U the mapmaker's map is held to 10x the JAX map's own move under
a 1e-14 move of the data (4e-7 of its max for the mapmaker alone, 2e-4
for the pass), measured in the test: the pixels seen at fewer than three
angles leave Q and U to the CG's rounding, while the rest of the pass
stays at 1e-8.

The parity cases simulate an imbalance x_im0 = 0.2. At the reference's own
0.01 the map's monopole on each connected set of pixel pairs is fixed only
through 2 x_im T, so the mapmaker stops at maxiter 150 at relres ~5e-5 in
both packages, and the reference's own map moves by ~1.6e-5 of its max
under a 1e-14 move of the data (measured at this size):
test_mapmaker_at_the_reference_imbalance holds the port to 10x that.

Also held here: the reference's general bandpass form cannot take a
differential block (ROADMAP queue 3 item 17), and the differential pass
removes an orbital dipole its simulation never adds (item 16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.sphere import healpix as jhp
from commander_tpu.tod import differential as JD
from commander_tpu.tod import process as JP
from commander_tpu_torch import convert
from commander_tpu_torch.tod import differential as TD
from commander_tpu_torch.tod import model as TM

torch.set_num_threads(1)

NSIDE = 16
NPIX = 12 * NSIDE * NSIDE
NS, ND, NT = 4, 2, 1024
F64 = jnp.float64
# the imbalance the parity cases simulate (module docstring)
X_IM0 = 0.2
BLOCK_KEYS = ("tod", "pixA", "psiA", "pixB", "psiB", "mask", "vsun")


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _t(x):
    return torch.as_tensor(np.array(x))


def block_dict(bj):
    return dict({k: np.asarray(getattr(bj, k)) for k in BLOCK_KEYS},
                fsamp=bj.fsamp)


def _normal(key, shape):
    return torch.as_tensor(np.array(jax.random.normal(key, shape, F64)))


def jax_diff_pass_draws(key, shape, mask):
    """process_tod_diff's draws from its key, through the reference's
    splits: (k_g, k_n, k_p, k_x) = split(key, 4); the PSD's (gamma,
    uniform) and n_corr's (re, im) each from a split of their key. shape:
    the block's (Ns, Nd, Nt); mask: its (Ns, Nd, Nt) mask."""
    Ns, Nd, Nt = shape
    k_g, k_n, k_p, k_x = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_p)
    m2 = mask[..., 1:] * mask[..., :-1]
    npair = jnp.maximum(jnp.sum(jnp.asarray(m2), -1), 1.0)
    k3, k4 = jax.random.split(k_n)
    return {"gain": _normal(k_g, (Ns, Nd)),
            "psd_gamma": _t(jax.random.gamma(k1, npair / 2.0)),
            "psd_u": _t(jax.random.uniform(k2, (Ns, Nd, 1), F64))[..., 0],
            "ncorr": (_normal(k3, (Ns, Nd, Nt // 2 + 1)),
                      _normal(k4, (Ns, Nd, Nt // 2 + 1))),
            "x_im": _normal(k_x, (Ns, Nd))}


def _sim(pol, x_im0=X_IM0):
    S = 3 if pol else 1
    rng = np.random.default_rng(0)
    sky = rng.standard_normal((3, NPIX)) * 50.0 \
        + np.array([100.0, 0.0, 0.0])[:, None]
    bj, truth = JD.simulate_tod_diff(NSIDE, sky[:S], nscan=NS, ndet=ND,
                                     ntod=NT, sigma0=0.5, gain0=1.03,
                                     fknee=0.2, x_im0=x_im0, pol=pol, seed=2)
    return dict(sky=sky[:S], bj=bj, truth=truth, rng=rng,
                bt=convert.diff_tod_block(block_dict(bj), device="cpu"),
                pvec=jhp.pix2vec_ring(NSIDE))


@pytest.fixture(scope="module")
def sims():
    return {False: _sim(False), True: _sim(True)}


def _args(b):
    return b.pixA, b.psiA, b.pixB, b.psiB


def _check_project(s, pol):
    bj, bt = s["bj"], s["bt"]
    rng = np.random.default_rng(5)
    maps = rng.standard_normal((3 if pol else 1, NPIX))
    tod_w = rng.standard_normal((NS, ND, NT))
    for x in (0.013, rng.standard_normal((NS, ND, 1)) * 0.01):
        xj, xt = (x, x) if np.ndim(x) == 0 else (jnp.asarray(x), _t(x))
        fwd_j = JD.project_diff(jnp.asarray(maps), *_args(bj), xj, pol)
        fwd_t = TD.project_diff(_t(maps), *_args(bt), xt, pol)
        assert _rel(fwd_t, fwd_j) <= 1e-12
        adj_j = JD.project_diff_T(jnp.asarray(tod_w), *_args(bj), xj, NPIX,
                                  pol)
        adj_t = TD.project_diff_T(_t(tod_w), *_args(bt), xt, NPIX, pol,
                                  horns=bt.horns(NPIX))
        assert _rel(adj_t, adj_j) <= 1e-12
        lhs = float(torch.sum(fwd_t * _t(tod_w)))
        rhs = float(torch.sum(_t(maps) * adj_t))
        assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def _map_bound(pol, ref, ref_moved, tol):
    """tol, or on T/Q/U 10x the JAX map's own move under a 1e-14 data
    move (module docstring)."""
    if not pol:
        return tol
    spread = _rel(np.asarray(ref_moved), ref)
    assert spread < 1e-2
    return max(tol, 10 * spread)


def _check_solve(s, pol):
    bj, bt = s["bj"], s["bt"]
    rng = np.random.default_rng(6)
    inv_var = rng.uniform(0.5, 2.0, (NS, ND))
    solve = jax.jit(JD.solve_diff_map, static_argnums=(8, 9))
    run_j = lambda d: solve(d, *_args(bj), X_IM0, bj.mask,
                            jnp.asarray(inv_var), NPIX, pol)
    mj, rj, hj = run_j(jnp.asarray(bj.tod))
    mt, rt, ht = TD.solve_diff_map(bt.tod, *_args(bt), X_IM0, bt.mask,
                                   _t(inv_var), NPIX, pol,
                                   horns=bt.horns(NPIX))
    assert int(rj.iters) == rt.iters and rt.iters > 5
    assert torch.equal(ht, _t(hj))
    moved = run_j(jnp.asarray(bj.tod) * (1.0 + 1e-14))[0] if pol else None
    assert _rel(mt, mj) <= _map_bound(pol, mj, moved, 1e-10)


def _check_imbalance(s, pol):
    rng = np.random.default_rng(7)
    shp = (NS, ND, NT)
    d, sA, sB = (rng.standard_normal(shp) for _ in range(3))
    sigma0 = rng.uniform(0.5, 1.5, (NS, ND))
    key = jax.random.PRNGKey(8)
    xj = JD.sample_imbalance(key, jnp.asarray(d), jnp.asarray(sA),
                             jnp.asarray(sB), s["bj"].mask,
                             jnp.asarray(sigma0))
    xt = TD.sample_imbalance(_t(d), _t(sA), _t(sB), s["bt"].mask,
                             _t(sigma0), eta=_normal(key, (NS, ND)))
    assert _rel(xt, xj) <= 1e-12


def _check_simulate(s, pol):
    bt, tt = TD.simulate_tod_diff(NSIDE, s["sky"], nscan=NS, ndet=ND,
                                  ntod=NT, sigma0=0.5, gain0=1.03, fknee=0.2,
                                  x_im0=X_IM0, pol=pol, seed=2, device="cpu")
    assert bt.pixA.dtype == torch.int32 and bt.tod.dtype == torch.float64
    for k in BLOCK_KEYS:
        np.testing.assert_array_equal(getattr(bt, k).numpy(),
                                      np.asarray(getattr(s["bj"], k)), k)
    for k in ("ncorr", "s"):
        np.testing.assert_array_equal(tt[k], s["truth"][k], k)


def _check_pass(s, pol):
    bj, bt = s["bj"], s["bt"]
    cfg = JP.TodConfig(nside=NSIDE, nu=70e9, pol=pol)
    st = JP.init_tod_state(bj)
    st = dataclasses.replace(st, n_corr=jnp.asarray(
        0.1 * s["rng"].standard_normal(bj.tod.shape)))
    st_t = convert.tod_state({f.name: np.asarray(getattr(st, f.name))
                              for f in dataclasses.fields(st)}, device="cpu")
    sky = s["sky"] * 1.01
    key = jax.random.PRNGKey(11)
    step = jax.jit(JD.process_tod_diff, static_argnums=0)
    run_j = lambda b: step(cfg, b, st, jnp.asarray(sky),
                           jnp.asarray(s["pvec"]), key)
    new_j, prod_j = run_j(bj)
    new_t, prod_t = TD.process_tod_diff(
        convert.tod_config(dataclasses.asdict(cfg)), bt, st_t, _t(sky),
        _t(s["pvec"]), draws=jax_diff_pass_draws(key, bj.tod.shape,
                                                 np.asarray(bj.mask)))
    for f in dataclasses.fields(new_j):
        assert _rel(getattr(new_t, f.name), getattr(new_j, f.name)) <= 1e-8, \
            f.name
    assert prod_t["cg_iters"] == int(prod_j["cg_iters"])
    assert torch.equal(prod_t["hits"], _t(prod_j["hits"]))
    for k in ("rms", "x_im"):
        assert _rel(prod_t[k], prod_j[k]) <= 1e-8, k
    moved = run_j(dataclasses.replace(bj, tod=bj.tod * (1.0 + 1e-14)))[1][
        "map"] if pol else None
    assert _rel(prod_t["map"], prod_j["map"]) <= _map_bound(
        pol, prod_j["map"], moved, 1e-8)


PARTS = {"project": _check_project, "solve": _check_solve,
         "imbalance": _check_imbalance, "simulate": _check_simulate,
         "pass": _check_pass}


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("pol", [False, True])
def test_differential_parts_match(sims, pol, part):
    """Each part against its JAX twin (module docstring: its tolerance)."""
    PARTS[part](sims[pol], pol)


def test_general_bandpass_form_fails_on_a_differential_block(sims):
    """run()'s general bandpass form calls tod_chisq on the band's block
    (run.py:2174-2179); a DiffTodBlock has no pix, so on a differential
    band the reference raises (ROADMAP queue 3 item 17): the port refuses
    BAND_SAMP_BANDPASS there before the build (tests/
    test_torch_driver_diff.py)."""
    s = sims[False]
    cfg = JP.TodConfig(nside=NSIDE, nu=70e9)
    with pytest.raises(AttributeError, match="pix"):
        JP.tod_chisq(cfg, s["bj"], JP.init_tod_state(s["bj"]),
                     jnp.asarray(s["sky"]), jnp.asarray(s["pvec"]))


def test_pass_removes_a_dipole_the_simulation_lacks(sims):
    """ROADMAP queue 3 item 16, copied: simulate_tod_diff has no orbital
    dipole, and process_tod_diff takes the horns' dipole difference from
    the calibrated data. Given the data's own gains, noise and imbalance,
    the port's mapmaker (1e-8 of the JAX one's map) lands on the sky minus
    the map of that difference, not on the sky: each differs from the sky
    by tens to hundreds of uK (32 uK at this size; T_CMB |v|/c ~ 270
    uK)."""
    s = sims[False]
    bj, bt = s["bj"], s["bt"]
    gain, sigma0 = 1.03, 0.5
    calib = (np.asarray(bj.tod) - s["truth"]["ncorr"]) / gain
    inv_var = np.full((NS, ND), gain ** 2 / sigma0 ** 2)
    pv = _t(s["pvec"])
    d_orb = (TM.orbital_dipole(bt.vsun, pv, 70e9, bt.pixA)
             - TM.orbital_dipole(bt.vsun, pv, 70e9, bt.pixB))
    solve = lambda d: TD.solve_diff_map(
        _t(d), *_args(bt), X_IM0, bt.mask, _t(inv_var), NPIX, False,
        horns=bt.horns(NPIX))
    m_pass, _, hits = solve(calib - d_orb.numpy())
    mj, _, _ = jax.jit(JD.solve_diff_map, static_argnums=(8, 9))(
        jnp.asarray(calib) - jnp.asarray(d_orb.numpy()), *_args(bj), X_IM0,
        bj.mask, jnp.asarray(inv_var), NPIX, False)
    assert _rel(m_pass, mj) <= 1e-8
    m_data, _, _ = solve(calib)
    m_dip, _, _ = solve(d_orb.numpy())
    h = hits.numpy()
    dip = float(np.abs(m_dip[0][h]).max())
    moved = float(torch.abs(m_data - m_pass).max())
    assert 10.0 < dip < 1000.0
    assert abs(moved - dip) <= 1e-3 * dip


def test_mapmaker_at_the_reference_imbalance():
    """At x_im 0.012 (simulate_tod_diff's default 0.01) the mapmaker stops
    at maxiter in both packages, and the port's map stands from the JAX
    one within 10x the JAX map's own move under a 1e-14 data move (module
    docstring)."""
    s = _sim(False, 0.01)
    bj, bt = s["bj"], s["bt"]
    inv_var = np.random.default_rng(6).uniform(0.5, 2.0, (NS, ND))
    solve = jax.jit(JD.solve_diff_map, static_argnums=(8, 9))
    run_j = lambda d: solve(d, *_args(bj), 0.012, bj.mask,
                            jnp.asarray(inv_var), NPIX, False)
    mj, rj, _ = run_j(jnp.asarray(bj.tod))
    mj2, _, _ = run_j(jnp.asarray(bj.tod) * (1.0 + 1e-14))
    mt, rt, _ = TD.solve_diff_map(bt.tod, *_args(bt), 0.012, bt.mask,
                                  _t(inv_var), NPIX, False,
                                  horns=bt.horns(NPIX))
    assert rt.iters == int(rj.iters) == TD.MAPMAKER_MAXITER
    assert 1e-6 < rt.rel_res < 1e-3 and 1e-6 < float(rj.rel_res) < 1e-3
    spread = _rel(np.asarray(mj2), mj)
    assert 1e-8 < spread < 1e-3
    assert _rel(mt, mj) <= 10 * spread
