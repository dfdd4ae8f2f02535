"""The port's spectral-index samplers against the JAX package, float64 on the
CPU: the same residuals, amplitude maps and noise, made from a numpy seed, go
through both, and every random input of the port is regenerated from the JAX
key the reference used.

Tolerances: lnL grids 1e-10 of the grid's range (max - min of the reference
values); draws 1e-10 absolute where a whole grid precedes the inversion and
1e-12 for the inversion alone; MH chains the same accept count and theta to
1e-10. Chunked per-pixel grids equal the unchunked ones exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.instrument.bandpass import delta_bandpass as j_delta
from commander_tpu.instrument.bandpass import tophat_bandpass as j_tophat
from commander_tpu.model.mixing import DiffuseComponent as JComp
from commander_tpu.model.mixing import mixing_element as j_mixing_element
from commander_tpu.sampling import specind as jsi
from commander_tpu.sphere import sht as jsht
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu_torch.instrument.bandpass import delta_bandpass as t_delta
from commander_tpu_torch.instrument.bandpass import tophat_bandpass as t_tophat
from commander_tpu_torch.model.mixing import DiffuseComponent as TComp
from commander_tpu_torch.sampling import specind as tsi
from commander_tpu_torch.sphere import sht as tsht

# small shapes: one torch thread, so that test workers sharing the cores
# do not oversubscribe them
torch.set_num_threads(1)

NSIDE, LMAX = 8, 16
B, S, P = 4, 2, 12 * NSIDE * NSIDE
LNL_TYPES = ("chisq", "ridge", "marginal", "prior")
T = torch.as_tensor
# (amp_band given, Gaussian prior, the other parameter a scalar or a map):
# every pair of the three options' values occurs once
GRID_CASES = [(False, False, "scalar"), (False, True, "map"),
              (True, False, "map"), (True, True, "scalar")]


def _bands(delta, tophat):
    return [delta(30e9), tophat(70e9, 0.2, 9), delta(143e9), delta(353e9)]


@pytest.fixture(scope="module")
def problem():
    """Dust (MBB) over 4 bands: residual = F(theta_true) a + noise, with
    per-band beamed amplitude maps a few percent off the common one and a
    tenth of the pixels masked."""
    rng = np.random.default_rng(0)
    kw = dict(name="dust", sed="MBB", nu_ref=353e9, theta0=(1.6, 19.6))
    cj, ct = JComp(**kw), TComp(**kw)
    bj, bt = _bands(j_delta, j_tophat), _bands(t_delta, t_tophat)
    amp_pix = 50.0 + 20.0 * rng.standard_normal((S, P))
    amp_pix[:, :3] = 0.0                       # the ratio's guarded branch
    amp_band = amp_pix[None] * (1.0 + 0.03 * rng.standard_normal((B, S, P)))
    beta_map = 1.5 + 0.05 * rng.standard_normal(P)
    F = np.stack([np.asarray(j_mixing_element(cj, bp, (beta_map, 21.0)))
                  for bp in bj])
    rms = 0.5 + rng.random((B, S, P))
    res = F[:, None, :] * amp_band + rms * rng.standard_normal((B, S, P))
    inv_rms2 = 1.0 / rms ** 2
    inv_rms2[:, :, rng.random(P) < 0.1] = 0.0
    return dict(cj=cj, ct=ct, bj=bj, bt=bt, res=res, amp_pix=amp_pix,
                amp_band=amp_band, inv_rms2=inv_rms2, beta_map=beta_map)


def _cfgs(lnl_type, prior):
    kw = dict(grid_min=1.0, grid_max=2.2, ngrid=24, lnl_type=lnl_type)
    if prior:
        kw.update(prior_mean=1.55, prior_std=0.1)
    return jsi.SpecIndConfig(**kw), tsi.SpecIndConfig(**kw)


def _args(pb, side, beamed, other):
    conv = jnp.asarray if side == "j" else T
    th = (1.6, conv(20.0 + 0.02 * pb["beta_map"])) if other == "map" \
        else (1.6, 21.0)
    return ([conv(pb[k]) for k in ("res", "amp_pix", "inv_rms2")], th,
            conv(pb["amp_band"]) if beamed else None)


def _grid_close(got, ref):
    ref = np.asarray(ref)
    span = max(ref.max() - ref.min(), 1e-30)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-10 * span


def test_config_grid_and_prior():
    cj, ct = _cfgs("chisq", True)
    grid = ct.grid(device="cpu")
    np.testing.assert_allclose(grid.numpy(), np.asarray(cj.grid()),
                               rtol=1e-15)
    np.testing.assert_allclose(tsi._lnprior(ct, grid).numpy(),
                               np.asarray(jsi._lnprior(cj, cj.grid())),
                               rtol=1e-12)
    cj0, ct0 = _cfgs("chisq", False)
    assert not tsi._lnprior(ct0, ct0.grid(device="cpu")).any()


@pytest.mark.parametrize("beamed,prior,other", GRID_CASES)
@pytest.mark.parametrize("lnl_type", LNL_TYPES)
def test_grid_lnL_pixel(problem, lnl_type, beamed, prior, other):
    cfg_j, cfg_t = _cfgs(lnl_type, prior)
    (rj, aj, nj), thj, abj = _args(problem, "j", beamed, other)
    (rt, at, nt), tht, abt = _args(problem, "t", beamed, other)
    ref = jsi._grid_lnL_pixel(problem["cj"], problem["bj"], cfg_j, rj, aj,
                              nj, thj, 0, amp_band=abj)
    got = tsi._grid_lnL_pixel(problem["ct"], problem["bt"], cfg_t, rt, at,
                              nt, tht, 0, amp_band=abt)
    assert got.dtype == torch.float64
    _grid_close(got, ref)


@pytest.mark.parametrize("beamed,prior,other", GRID_CASES)
@pytest.mark.parametrize("lnl_type", LNL_TYPES)
def test_grid_lnL_total(problem, lnl_type, beamed, prior, other):
    cfg_j, cfg_t = _cfgs(lnl_type, prior)
    (rj, aj, nj), thj, abj = _args(problem, "j", beamed, other)
    (rt, at, nt), tht, abt = _args(problem, "t", beamed, other)
    ref = jsi._grid_lnL_total(problem["cj"], problem["bj"], cfg_j, rj, aj,
                              nj, thj, 0, amp_band=abj)
    got = tsi._grid_lnL_total(problem["ct"], problem["bt"], cfg_t, rt, at,
                              nt, tht, 0, amp_band=abt)
    assert got.shape == (cfg_t.ngrid,) and got.dtype == torch.float64
    _grid_close(got, ref)


def test_grid_lnL_total_float32_data_accumulates_in_float64(problem):
    """float32 data: the total is float64 and within float32 rounding of the
    float64 one (the pixel sums do not round to float32)."""
    _, cfg_t = _cfgs("chisq", False)
    (rt, at, nt), tht, abt = _args(problem, "t", True, "scalar")
    ref = tsi._grid_lnL_total(problem["ct"], problem["bt"], cfg_t, rt, at,
                              nt, tht, 0, amp_band=abt)
    got = tsi._grid_lnL_total(problem["ct"], problem["bt"], cfg_t,
                              rt.float(), at.float(), nt.float(), tht, 0,
                              amp_band=abt.float())
    assert got.dtype == torch.float64
    assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-5


@pytest.mark.parametrize("shape", [(), (5, 3)])
def test_cdf_invert(shape):
    rng = np.random.default_rng(1)
    G = 24
    grid = np.linspace(-3.5, -2.5, G)
    lnl = -0.5 * ((grid - rng.uniform(-3.3, -2.7, shape + (1,)))
                  / rng.uniform(0.02, 0.3, shape + (1,))) ** 2 + 1e4
    key = jax.random.PRNGKey(3)
    # one jit in place of an eager compile per operation
    ref = jax.jit(jsi._cdf_invert)(key, jnp.asarray(lnl), jnp.asarray(grid))
    u = np.array(jax.random.uniform(key, shape + (1,), jnp.float64))
    got = tsi._cdf_invert(T(u[..., 0]), T(lnl), T(grid))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def test_cdf_invert_single_point_posterior():
    """A posterior far narrower than the grid step (lnL differences of 1e6
    between points): finite, and within one step of the peak's point."""
    grid = torch.linspace(1.0, 2.0, 64, dtype=torch.float64)
    lnl = -0.5e9 * (grid - grid[40]) ** 2 - 3e8
    for u in (0.0, 0.3, 0.999999):
        t = tsi._cdf_invert(torch.tensor(u, dtype=torch.float64), lnl, grid)
        assert torch.isfinite(t)
        assert abs(float(t - grid[40])) <= float(grid[1] - grid[0])


@pytest.mark.parametrize("beamed", [False, True])
@pytest.mark.parametrize("lnl_type", ["chisq", "marginal"])
def test_sample_specind_pixel(problem, lnl_type, beamed):
    cfg_j, cfg_t = _cfgs(lnl_type, True)
    (rj, aj, nj), thj, abj = _args(problem, "j", beamed, "map")
    (rt, at, nt), tht, abt = _args(problem, "t", beamed, "map")
    key = jax.random.PRNGKey(7)
    ref = jsi.sample_specind_pixel(key, problem["cj"], problem["bj"], cfg_j,
                                   rj, aj, nj, thj, 0, amp_band=abj)
    u = np.array(jax.random.uniform(key, (P, 1), jnp.float64))[:, 0]
    got = tsi.sample_specind_pixel(problem["ct"], problem["bt"], cfg_t, rt,
                                   at, nt, tht, 0, amp_band=abt, u=T(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("beamed", [False, True])
@pytest.mark.parametrize("lnl_type", LNL_TYPES)
def test_sample_specind_fullsky(problem, lnl_type, beamed):
    cfg_j, cfg_t = _cfgs(lnl_type, True)
    (rj, aj, nj), thj, abj = _args(problem, "j", beamed, "scalar")
    (rt, at, nt), tht, abt = _args(problem, "t", beamed, "scalar")
    key = jax.random.PRNGKey(8)
    ref = jsi.sample_specind_fullsky(key, problem["cj"], problem["bj"],
                                     cfg_j, rj, aj, nj, thj, 0, amp_band=abj)
    u = float(jax.random.uniform(key, (1,), jnp.float64)[0])
    got = tsi.sample_specind_fullsky(problem["ct"], problem["bt"], cfg_t, rt,
                                     at, nt, tht, 0, amp_band=abt,
                                     u=torch.tensor(u, dtype=torch.float64))
    assert got.ndim == 0
    assert abs(float(got) - float(ref)) <= 1e-10


def test_sample_specind_regions(problem):
    cfg_j, cfg_t = _cfgs("chisq", True)
    (rj, aj, nj), thj, _ = _args(problem, "j", False, "scalar")
    (rt, at, nt), tht, _ = _args(problem, "t", False, "scalar")
    R = 5
    rop = np.random.default_rng(2).integers(0, R, P).astype(np.int32)
    key = jax.random.PRNGKey(9)
    reg_j, map_j = jsi.sample_specind_regions(
        key, problem["cj"], problem["bj"], cfg_j, rj, aj, nj, thj,
        jnp.asarray(rop), R, 0)
    u = np.array(jax.random.uniform(key, (R, 1), jnp.float64))[:, 0]
    reg_t, map_t = tsi.sample_specind_regions(
        problem["ct"], problem["bt"], cfg_t, rt, at, nt, tht, rop, R, 0,
        u=T(u))
    np.testing.assert_allclose(reg_t.numpy(), np.asarray(reg_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(map_t.numpy(), np.asarray(map_j), rtol=0,
                               atol=1e-10)


def test_samplers_from_a_generator_are_seeded(problem):
    _, cfg_t = _cfgs("chisq", False)
    (rt, at, nt), tht, _ = _args(problem, "t", False, "scalar")
    args = (problem["ct"], problem["bt"], cfg_t, rt, at, nt, tht, 0)
    out = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(4)
        out.append((tsi.sample_specind_fullsky(*args, generator=g),
                    tsi.sample_specind_pixel(*args, generator=g)))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    lo, hi = cfg_t.grid_min, cfg_t.grid_max
    assert bool(((out[0][1] >= lo) & (out[0][1] <= hi)).all())
    with pytest.raises(ValueError, match="Generator"):
        tsi.sample_specind_fullsky(*args)


@pytest.mark.parametrize("lnl_type", ["chisq", "ridge"])
def test_chunked_pixel_grid_is_exact(problem, lnl_type, monkeypatch):
    """Walking the pixels in chunks gives the unchunked values bit for
    bit, for the per-pixel and the region sampler."""
    _, cfg_t = _cfgs(lnl_type, True)
    (rt, at, nt), tht, abt = _args(problem, "t", True, "map")
    u = torch.rand(P, generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64)
    rop = np.random.default_rng(2).integers(0, 5, P)
    args = (problem["ct"], problem["bt"], cfg_t, rt, at, nt, tht)
    assert len(tsi._pixel_chunks(rt, cfg_t.ngrid)) == 1
    whole = tsi.sample_specind_pixel(*args, 0, amp_band=abt, u=u)
    whole_reg = tsi.sample_specind_regions(*args, rop, 5, 0, u=u[:5])
    # 100 pixels per chunk
    monkeypatch.setattr(tsi, "CHUNK_BYTES", 100 * B * S * cfg_t.ngrid * 8)
    chunks = tsi._pixel_chunks(rt, cfg_t.ngrid)
    assert len(chunks) == -(-P // 100) and chunks[-1].stop == P
    assert torch.equal(tsi.sample_specind_pixel(*args, 0, amp_band=abt, u=u),
                       whole)
    lnl = torch.cat([tsi._grid_lnL_pixel(
        *args[:3], rt[..., sl], at[..., sl], nt[..., sl],
        (tht[0], tht[1][sl]), 0, amp_band=abt[..., sl]) for sl in chunks])
    assert torch.equal(lnl, tsi._grid_lnL_pixel(*args, 0, amp_band=abt))
    part_reg = tsi.sample_specind_regions(*args, rop, 5, 0, u=u[:5])
    # the region sums add chunk by chunk: the same to rounding
    np.testing.assert_allclose(part_reg[0].numpy(), whole_reg[0].numpy(),
                               rtol=0, atol=1e-12)


# --- the two Metropolis samplers --------------------------------------------

@pytest.fixture(scope="module")
def field_problem(problem):
    plan_j = jsht.get_plan(NSIDE, LMAX)
    plan_t = tsht.get_plan(NSIDE, LMAX, dtype=torch.float64, device="cpu")
    return plan_j, plan_t


def _mh_draws(key, nsteps, draw):
    out, us = [], []
    for _ in range(nsteps):
        key, k1, k2 = jax.random.split(key, 3)
        out.append(np.asarray(draw(k1)))
        us.append(float(jax.random.uniform(k2, ())))
    return np.stack(out), np.asarray(us)


@pytest.mark.parametrize("beamed,prior", [(False, False), (True, True)])
def test_sample_specind_alm(problem, field_problem, beamed, prior):
    plan_j, plan_t = field_problem
    cfg_j, cfg_t = _cfgs("chisq", prior)
    (rj, aj, nj), thj, abj = _args(problem, "j", beamed, "scalar")
    (rt, at, nt), tht, abt = _args(problem, "t", beamed, "scalar")
    lmax_ind, nsteps, step = 2, 6, 2e-3
    nl_i = lmax_ind + 1
    t0 = np.zeros((nl_i, nl_i), complex)
    t0[0, 0] = 1.5 * np.sqrt(4 * np.pi)
    key = jax.random.PRNGKey(11)
    ref = jsi.sample_specind_alm(
        key, problem["cj"], problem["bj"], cfg_j, plan_j, rj, aj, nj, thj,
        jnp.asarray(t0), 0, lmax_ind=lmax_ind, step=step, nsteps=nsteps,
        amp_band=abj)
    eta, u = _mh_draws(key, nsteps, lambda k: j_random_alm_white(
        k, (nl_i, nl_i), jnp.float64))
    got = tsi.sample_specind_alm(
        problem["ct"], problem["bt"], cfg_t, plan_t, rt, at, nt, tht, T(t0),
        0, lmax_ind=lmax_ind, step=step, nsteps=nsteps, amp_band=abt,
        draws={"eta": T(eta), "u": T(u)})
    assert got[2] == ref[2] and 0 < got[2] < nsteps
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("fwhm", [0.0, 600.0])
def test_sample_specind_alm_pixreg(problem, field_problem, fwhm):
    plan_j, plan_t = field_problem
    cfg_j, cfg_t = _cfgs("chisq", True)
    (rj, aj, nj), thj, _ = _args(problem, "j", False, "scalar")
    (rt, at, nt), tht, _ = _args(problem, "t", False, "scalar")
    R, nsteps, step = 4, 8, 3e-3
    rop = np.random.default_rng(5).integers(0, R, P).astype(np.int32)
    reg0 = np.array([1.5, 1.52, 1.48, 2.199])   # the last steps out of range
    fix = np.array([False, True, False, False])
    pri = np.array([1.5, 1.5, 1.6, 1.5])
    key = jax.random.PRNGKey(12)
    kw = dict(lmax_ind=2, step=step, nsteps=nsteps, fwhm_postproc=fwhm)
    ref = jsi.sample_specind_alm_pixreg(
        key, problem["cj"], problem["bj"], cfg_j, plan_j, rj, aj, nj, thj,
        jnp.asarray(reg0), jnp.asarray(rop), 0, fix_reg=fix, reg_priors=pri,
        **kw)
    delta, u = _mh_draws(key, nsteps, lambda k: jax.random.normal(
        k, (R,), jnp.float64))
    got = tsi.sample_specind_alm_pixreg(
        problem["ct"], problem["bt"], cfg_t, plan_t, rt, at, nt, tht,
        T(reg0), rop, 0, fix_reg=fix, reg_priors=pri,
        draws={"delta": T(delta), "u": T(u)}, **kw)
    assert got[3] == ref[3]
    assert float(got[0][1]) == 1.52                   # the frozen region
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10)


def test_mh_samplers_from_a_generator(problem, field_problem):
    _, plan_t = field_problem
    _, cfg_t = _cfgs("chisq", True)
    (rt, at, nt), tht, _ = _args(problem, "t", False, "scalar")
    g = torch.Generator()
    g.manual_seed(1)
    t0 = torch.zeros((3, 3), dtype=torch.complex128)
    t0[0, 0] = 1.5 * np.sqrt(4 * np.pi)
    t_alm, t_map, n = tsi.sample_specind_alm(
        problem["ct"], problem["bt"], cfg_t, plan_t, rt, at, nt, tht, t0, 0,
        step=1e-3, nsteps=4, generator=g)
    assert t_alm.shape == (3, 3) and t_map.shape == (P,) and 0 <= n <= 4
    rop = np.arange(P) % 3
    reg, fmap, alm, n = tsi.sample_specind_alm_pixreg(
        problem["ct"], problem["bt"], cfg_t, plan_t, rt, at, nt, tht,
        torch.full((3,), 1.5, dtype=torch.float64), rop, 0, step=1e-3,
        nsteps=4, generator=g)
    assert reg.shape == (3,) and fmap.shape == (P,) and alm.shape == (3, 3)
    assert torch.equal(fmap, reg[torch.as_tensor(rop)])
