"""The port's Gibbs iteration from time-ordered data
(sampling/tod_gibbs.py) against a JAX composition of the reference's own
parts, float64 on the CPU: run.py's TOD stage (run.py:2068-2095,
:2187-2201) built here from commander_tpu.tod.process.process_tod and the
system update of run.py, then tpu_gibbs.full_gibbs_step. The problem is
tests/test_torch_full_gibbs.py's (nside 16 / lmax 32, CMB + synchrotron +
dust, 4 bands, three index slots), each band with 4 scans x 2 detectors x
1024 samples of TOD; the port gets the JAX keys' draws. Tolerance:
amplitudes and theta 1e-8 (theta of its scale), maps and noise 1e-8.

The whole tod_gibbs_step against the composition and the monopoles
carried over passes and a step are tests/test_torch_tod_gibbs_step.py (two
cases, dealt beside tests/test_sharding.py).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.sampling import chisq as jchisq
from commander_tpu.sampling import tpu_gibbs
from commander_tpu.sphere import healpix as jhp
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu.sphere.alm import triangle_mask as j_triangle_mask
from commander_tpu.model.mixing import mixing_matrix as j_mixing_matrix
from commander_tpu.tod import process as JP
from commander_tpu.tod import sim as JS
from commander_tpu.sampling import joint as jjoint
from commander_tpu_torch import convert, entry
from commander_tpu_torch.sampling import amplitude as tamp
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import gibbs as tgibbs
from commander_tpu_torch.sampling import tod_gibbs
from test_torch_full_gibbs import BINS, MODELS, _asdict, _problem
from test_torch_tod import _block_dict, _rel, jax_pass_draws

# small shapes: one torch thread, so that test workers sharing the cores
# do not oversubscribe them
torch.set_num_threads(1)

NSIDE, LMAX = 16, 32
NPIX = 12 * NSIDE * NSIDE
NS, ND, NT = 4, 2, 1024
FREQS = (30e9, 70e9, 143e9, 353e9)


def _jax_bands(sky, S, sigma0=0.5, nscan=NS, nside=NSIDE):
    """(JAX (cfg, block, state) per band, the port's TodBands)."""
    out_j, out_t = [], []
    for b in range(sky.shape[0]):
        bj, _ = JS.simulate_tod(nside, sky[b], nscan=nscan, ndet=ND, ntod=NT,
                                sigma0=sigma0, fknee=0.03, nu=FREQS[b],
                                pol=S == 3, seed=b)
        cfg = JP.TodConfig(nside=nside, nu=FREQS[b], pol=S == 3)
        st = JP.init_tod_state(bj)
        out_j.append((cfg, bj, st))
        out_t.append(tod_gibbs.TodBand(
            convert.tod_config(dataclasses.asdict(cfg)),
            convert.tod_block(_block_dict(bj), device="cpu"),
            convert.tod_state({f.name: np.asarray(getattr(st, f.name))
                               for f in dataclasses.fields(st)},
                              device="cpu"), {}))
    return out_j, out_t


def _jax_tod_pass(bands_j, data, inv_rms, sky, key, first):
    """run.py's TOD stage: process_tod per band (key split per
    band), then hit pixels take the binned map and rms, unhit pixels rms 0.
    Returns (new bands, data, inv_rms, the per-band keys)."""
    pvec = jnp.asarray(jhp.pix2vec_ring(NSIDE))
    new_data = np.array(data)
    with np.errstate(divide="ignore"):
        new_rms = np.array(1.0 / np.maximum(np.asarray(inv_rms), 1e-30))
    out, keys = [], []
    for b, (cfg, bj, st) in enumerate(bands_j):
        key, k = jax.random.split(key)
        keys.append(k)
        cfg_use = dataclasses.replace(cfg, chisq_reject_sigma=1e30) \
            if first else cfg
        st, prod = JP.process_tod(cfg_use, bj, st, sky[b], pvec, k)
        out.append((cfg, bj, st))
        pm, pr = np.asarray(prod["map"]), np.asarray(prod["rms"])
        for s_i in range(pm.shape[0]):
            hit = pr[s_i] > 0
            new_data[b, s_i, hit] = pm[s_i][hit]
            new_rms[b, s_i, hit] = pr[s_i][hit]
            new_rms[b, s_i, ~hit] = 0.0
    good = new_rms > 0
    safe = np.where(good, new_rms, 1.0)
    return out, new_data, np.where(good, 1.0 / safe, 0.0), keys


_JAX_STEPS = {}
# the model sky jitted (system, plan, amplitudes as arguments): one compile
# in place of one per operation
_j_sky = jax.jit(jchisq.sky_signal)


def _jax_step(pb, gcfg_j=None):
    """tpu_gibbs.full_gibbs_step of the problem's three slots (with its
    GibbsConfig, or gcfg_j), jitted once per problem and configuration."""
    gcfg_j = gcfg_j or pb.gcfg_j
    if (id(pb), gcfg_j) not in _JAX_STEPS:
        _JAX_STEPS[id(pb), gcfg_j] = jax.jit(partial(
            tpu_gibbs.full_gibbs_step, gcfg_j, pb.comps_j, pb.bps_j,
            tpu_gibbs.make_index_slots(pb.comps_j), beam_consistent=True))
    return _JAX_STEPS[id(pb), gcfg_j]


@pytest.fixture(scope="module")
def problem():
    pb = _problem(1, ncomp=3)
    # 32 scans: 86% of the pixels solved. (With the 4 scans of
    # tests/test_torch_tod.py, 20%, the diagonal preconditioner leaves the
    # CG at relres 1e-7 after 200 iterations, where two float64 solvers'
    # iterates part at that level.)
    bands_j, bands_t = _jax_bands(np.asarray(pb.sys_j.data), 1, nscan=32)
    return pb, bands_j, bands_t


def test_tod_gibbs_step_with_joint_rows_matches(problem):
    """The step above with the joint presets' rows (md per band, prior 0 +-
    100; relquad pinned at 1; 6 sources; test_torch_joint.jax_rows) from a
    nonzero (a, t, p): the TOD pass runs on the full model sky (diffuse,
    templates, sources; run.py:2070), then the three-slot full_gibbs_step
    with the rows, at the presets' CG tol 1e-6 (see
    test_torch_full_gibbs.py's joint-row test), the port given the JAX
    keys' draws: maps and noise, a, t, p and theta to 1e-8, the same CG
    iterations."""
    from test_torch_joint import jax_rows, joint_step_draws

    pb, bands_j, bands_t = problem
    C, S, nl = pb.C, pb.S, pb.lmax + 1
    ts_j, ps_j, t0, p0, _ = jax_rows(NSIDE, FREQS, MODELS[3][2])
    ts_t = convert.template_set(_asdict(ts_j), device="cpu")
    ps_t = convert.ptsrc_set(_asdict(ps_j), NPIX, device="cpu")
    slots_t = tfg.make_index_slots(pb.comps_t)
    start = [pb.comps_t[s.ci].theta0[s.which] for s in slots_t]
    a0 = np.asarray(j_random_alm_white(jax.random.PRNGKey(10),
                                       (C, S, nl, nl))
                    * jnp.asarray(j_triangle_mask(nl, nl))) \
        * np.sqrt(np.asarray(pb.sys_j.cl))[..., None]
    st_j = dataclasses.replace(
        tpu_gibbs.gibbs_mod.init_state(jax.random.PRNGKey(2), C, S, pb.lmax,
                                       len(BINS), ntemp=len(t0),
                                       nsrc=len(p0)),
        a=jnp.asarray(a0), t=jnp.asarray(t0), p=jnp.asarray(p0))
    th0 = [(), tuple(start[:1]), tuple(start[1:])]
    F0 = np.asarray(j_mixing_matrix(pb.comps_j, pb.bps_j, thetas=th0))
    sys0 = dataclasses.replace(pb.sys_j, F=jnp.asarray(F0)[..., None])
    sky = _j_sky(sys0, pb.plan_j, st_j.a) \
        + jjoint._templates_fwd(ts_j, st_j.t) \
        + jjoint._ptsrc_fwd(ps_j, st_j.p, NPIX)
    tkey, key = jax.random.PRNGKey(23), jax.random.PRNGKey(44)
    bands_j1, data, inv_rms, keys = _jax_tod_pass(
        bands_j, pb.sys_j.data, pb.sys_j.inv_rms, sky, tkey, first=True)
    sys_j1 = dataclasses.replace(pb.sys_j, data=jnp.asarray(data),
                                 inv_rms=jnp.asarray(inv_rms),
                                 inv_rms2=jnp.asarray(inv_rms ** 2))
    gcfg_j = dataclasses.replace(pb.gcfg_j, cg_tol=1e-6)
    new_j, th_j, _ = _jax_step(pb, gcfg_j)(
        sys_j1, pb.plan_j, st_j, jnp.asarray(start, jnp.float64), key,
        ts=ts_j, ps=ps_j)

    draws = joint_step_draws(key, pb, len(slots_t), len(t0), len(p0))
    draws["tod"] = [jax_pass_draws(k, cfg, bj, NPIX)
                    for k, (cfg, bj, _) in zip(keys, bands_j)]
    bands, sys_t1, new_t, th_t = tod_gibbs.tod_gibbs_step(
        convert.gibbs_config(dataclasses.asdict(gcfg_j)), pb.comps_t,
        pb.bps_t, slots_t, bands_t, pb.sys_t, pb.plan_t,
        convert.gibbs_state(_asdict(st_j), device="cpu"),
        convert.thetas(start, device="cpu"), first=True,
        beam_consistent=True, draws=draws, ts=ts_t, ps=ps_t)

    assert _rel(sys_t1.data, data) <= 1e-8
    assert _rel(sys_t1.inv_rms, inv_rms) <= 1e-8
    for band, (_, _, st) in zip(bands, bands_j1):
        assert _rel(band.state.gain, st.gain) <= 1e-8
    for t, j, t0_ in zip(th_t.tolist(), np.asarray(th_j), start):
        assert abs(t - j) <= 1e-8 * max(1.0, abs(t0_))
    for k in ("a", "t", "p"):
        assert _rel(getattr(new_t, k).numpy(), getattr(new_j, k)) <= 1e-8, k
    assert new_t.cg_iters == int(new_j.cg_iters)


def _jax_mono_pass(bands_j, monos, data, inv_rms, sky, key, first):
    """run.py's TOD stage with sample_mono (run.py:1340-1347, 2085-2091):
    each band's process_tod takes the monopoles of its last pass and keeps
    the new ones. Returns (bands, monos, data, inv_rms, the per-band keys
    and monopoles)."""
    pvec = jnp.asarray(jhp.pix2vec_ring(NSIDE))
    data, inv_rms = np.array(data), np.array(inv_rms)
    out, keys, new_monos = [], [], []
    for b, (cfg, bj, st) in enumerate(bands_j):
        key, k = jax.random.split(key)
        keys.append(k)
        cfg_use = dataclasses.replace(cfg, chisq_reject_sigma=1e30) \
            if first else cfg
        st, prod = JP.process_tod(cfg_use, bj, st, sky[b], pvec, k,
                                  mono=monos[b])
        out.append((cfg, bj, st))
        new_monos.append(prod["mono"])
        pm, pr = np.asarray(prod["map"]), np.asarray(prod["rms"])
        hit = pr > 0
        data[b, :1] = np.where(hit, pm, data[b, :1])
        inv_rms[b, :1] = np.where(hit, 1.0 / np.where(hit, pr, 1.0), 0.0)
    return out, new_monos, data, inv_rms, keys


def test_a_band_with_sample_mono_needs_its_monopoles(problem):
    pb, _, bands_t = problem
    band = bands_t[0]._replace(cfg=dataclasses.replace(
        bands_t[0].cfg, sample_mono=True))
    sky = torch.zeros((1, NPIX), dtype=torch.float64)
    with pytest.raises(ValueError, match="monopoles"):
        tod_gibbs.tod_pass([band], pb.sys_t, sky[None], generator=torch.
                           Generator())


def test_simulated_bands_with_sample_mono_carry_their_monopoles():
    """simulate_bands(sample_mono=True): every band's cfg draws monopoles,
    which start at zeros (Nd,) in the block's dtype (run.py:766-768); a
    pass replaces them with its draw."""
    rng = np.random.default_rng(3)
    sky = rng.standard_normal((2, 1, NPIX)) * 20.0
    bands = tod_gibbs.simulate_bands(NSIDE, sky, np.ones((2, 1, NPIX)),
                                     FREQS[:2], nscan=NS, ndet=ND, ntod=NT,
                                     sample_mono=True, dtype=torch.float64,
                                     device="cpu")
    for band in bands:
        assert band.cfg.sample_mono
        assert band.mono.dtype == torch.float64 and band.mono.shape == (ND,)
        assert not bool(band.mono.any())
    assert all(b.mono is None for b in tod_gibbs.simulate_bands(
        NSIDE, sky, np.ones((2, 1, NPIX)), FREQS[:2], nscan=NS, ndet=ND,
        ntod=NT, dtype=torch.float64, device="cpu"))
    sys_t = tamp.build_system(np.ones((2, 1)), np.ones((2, 1, 9)),
                              np.ones((2, 1, NPIX)), np.ones((1, 1, 9)),
                              sky)
    gen = torch.Generator()
    gen.manual_seed(0)
    new, _ = tod_gibbs.tod_pass(bands, sys_t, torch.as_tensor(sky),
                                first=True, generator=gen)
    for band in new:
        assert band.mono.shape == (ND,) and bool(band.mono.any())
        assert abs(float(band.mono.sum())) <= 1e-10     # zero-sum draw


def test_simulate_bands_matches_the_jax_simulator():
    """Per band: the JAX simulator with seed + b, sigma0 = scale / mean
    inv_rms of the band, at the band's frequency."""
    rng = np.random.default_rng(2)
    sky = rng.standard_normal((2, 3, NPIX)) * 20.0
    inv_rms = 1.0 / (1.0 + rng.random((2, 3, NPIX)))
    bands = tod_gibbs.simulate_bands(NSIDE, sky, inv_rms, FREQS[:2],
                                     nscan=NS, ndet=ND, ntod=NT,
                                     sigma0_scale=1.3, fknee=0.03, seed=5,
                                     dtype=torch.float64, device="cpu")
    for b, band in enumerate(bands):
        s0 = 1.3 / inv_rms[b].mean()
        bj, _ = JS.simulate_tod(NSIDE, sky[b], nscan=NS, ndet=ND, ntod=NT,
                                sigma0=s0, fknee=0.03, nu=FREQS[b], pol=True,
                                seed=5 + b)
        for k in ("tod", "pix", "psi", "mask", "vsun"):
            assert _rel(getattr(band.block, k), getattr(bj, k)) <= 1e-10
        assert band.cfg.pol and band.cfg.nu == FREQS[b]
        assert abs(band.truth["sigma0"] / s0 - 1) < 1e-12
        st = JP.init_tod_state(bj)
        assert _rel(band.state.sigma0, st.sigma0) <= 1e-10
        assert "_runs" in band.block.__dict__      # sorted once, at set-up


def test_burnin_is_an_amplitude_step_then_passes(problem):
    """tod_burnin from a generator: the amplitude step on the map-level data,
    then three passes over the bands on its model sky with rejection off,
    drawn in that order (the same bits as the parts called in turn)."""
    pb, _, bands_t = problem
    runs = []
    for burnin in (True, False):
        gen = torch.Generator()
        gen.manual_seed(3)
        st = tgibbs.init_state(pb.C, pb.S, pb.lmax, len(BINS), device="cpu")
        if burnin:
            bands, st = tod_gibbs.tod_burnin(pb.gcfg_t, bands_t, pb.sys_t,
                                             pb.plan_t, st, gen)
        else:
            st = tgibbs.gibbs_step(pb.gcfg_t, pb.sys_t, pb.plan_t, st, gen)
            sky = tamp._synth(pb.plan_t, tamp._project_bands(
                pb.sys_t, pb.plan_t, st.a))
            bands = list(bands_t)
            for _ in range(3):
                for b, band in enumerate(bands):
                    cfg = dataclasses.replace(band.cfg,
                                              chisq_reject_sigma=1e30)
                    new, _ = tod_gibbs.process_tod(
                        cfg, band.block, band.state, sky[b],
                        tod_gibbs.pixel_vectors(NSIDE, torch.float64, "cpu"),
                        gen)
                    bands[b] = band._replace(state=new)
        runs.append((bands, st))
    assert torch.equal(runs[0][1].a, runs[1][1].a)
    for b0, b1 in zip(runs[0][0], runs[1][0]):
        for f in dataclasses.fields(b0.state):
            assert torch.equal(getattr(b0.state, f.name),
                               getattr(b1.state, f.name))
        assert abs(float(b0.state.gain.mean()) - 1.0) < 0.05


def test_tod_presets():
    """The TOD presets at nside 8 / lmax 16 with a few scans: one band of TOD
    per system band, simulated from the noiseless sky at theta_true; entry_tod
    takes a warm start and two steps, the binned maps replacing the data."""
    tod = dict(entry.TOD_NOISE, nscan=6, ndet=2, ntod=2048)
    pbs = {p: entry.build_preset(p, torch.float64, "cpu", nside=8, lmax=16,
                                 tod=tod)
           for p in ("entry_tod", "tutorial_tod")}
    for name, pb in pbs.items():
        kw = entry.PRESETS[name]["tod"]
        assert (kw["nscan"], kw["ndet"], kw["ntod"]) == (
            (96, 4, 131072) if name == "tutorial_tod" else (16, 4, 8192))
        assert pb.cfg.cg_maxiter == (400 if name == "tutorial_tod" else 60)
        assert len(pb.bands) == 3 and pb.sim_seconds > 0
        assert pb.sky_true.shape == pb.sys.data.shape
        for band, bp in zip(pb.bands, pb.bps):
            assert band.cfg.pol and band.cfg.nu == bp.nu_c
            assert band.truth["sigma0"] == pytest.approx(1.3 * 20.0)
    pb = pbs["entry_tod"]
    gen = torch.Generator()
    gen.manual_seed(0)
    sys0 = tfg.system_at(pb.sys, pb.comps, pb.bps, pb.slots, pb.thetas0)
    st0 = entry.prior_state(pb.cfg, pb.sys)
    # run.py's seed (run.py:1456-1473): each bin's mean prior C_l
    from commander_tpu.model.cl import bin_index_table as j_bin_index_table
    idx = j_bin_index_table(pb.cfg.cl_cfg)
    nb = len(pb.cfg.cl_cfg.bin_starts)
    want = np.bincount(idx, weights=pb.sys.cl[0, 0].numpy(), minlength=nb) \
        / np.maximum(np.bincount(idx, minlength=nb), 1)
    assert np.abs(st0.cl_bins[0, 0].numpy() - want).max() <= 1e-12 * want.max()
    assert not torch.any(st0.a != 0)
    bands, st = tod_gibbs.tod_burnin(pb.cfg, pb.bands, sys0, pb.plan, st0,
                                     gen, npasses=1)
    base, th = pb.sys, pb.thetas0
    for i in range(2):
        bands, base, st, th = tod_gibbs.tod_gibbs_step(
            pb.cfg, pb.comps, pb.bps, pb.slots, bands, base, pb.plan, st, th,
            first=i == 0, generator=gen, beam_consistent=True)
    assert torch.isfinite(torch.view_as_real(st.a)).all()
    assert torch.isfinite(th).all() and st.it == 3
    assert not torch.equal(base.data, pb.sys.data)
    chi2, hit = tod_gibbs.binned_map_chisq(base, pb.sky_true)
    assert torch.isfinite(chi2).all() and (hit > 0).all() and (hit < 1).all()
