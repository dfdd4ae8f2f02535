"""The port's whole Gibbs iteration (sampling/full_gibbs.full_gibbs_step)
against the JAX package's (sampling/tpu_gibbs.full_gibbs_step), float64 on
the CPU, at nside 16 / lmax 32: 3 bands with CMB + synchrotron (one index
slot), and 4 bands with CMB + synchrotron + modified-blackbody dust (three
slots drawn in turn, each conditioned on the draws before it).

The JAX step is given a key; every draw of the port's step is regenerated
from that key with the reference's own chain: gibbs_step's splits for eta1,
eta2 and the C_ell gammas, then fold_in(new_state.key, 17) and one split per
slot for the index inversions' uniforms. Tolerance: theta and amplitudes 1e-8
(the CG solves to 1e-12 on both sides).

This file holds S = 1 (temperature); tests/test_torch_full_gibbs_pol.py runs
the same comparison at S = 3 with this file's helpers.

The whole-step case with the JAX draws, with and without the beams, is
tests/test_torch_full_gibbs_step.py (two cases, dealt beside
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

from commander_tpu.instrument import bandpass as jbp
from commander_tpu.instrument.beam import gaussian_bl as j_gaussian_bl
from commander_tpu.model.cl import ClModelConfig as JClModelConfig
from commander_tpu.model.mixing import DiffuseComponent as JComp
from commander_tpu.model.mixing import mixing_matrix as j_mixing_matrix
from commander_tpu.sampling import amplitude as jamp
from commander_tpu.sampling import gibbs as jgibbs
from commander_tpu.sampling import tpu_gibbs
from commander_tpu.sphere import sht as jsht
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu.sphere.alm import triangle_mask as j_triangle_mask
from commander_tpu_torch import convert, entry
from commander_tpu_torch.sampling import amplitude as tamp
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import gibbs as tgibbs
from commander_tpu_torch.sphere import sht as tsht

# small shapes: one torch thread, so that test workers sharing the cores
# do not oversubscribe them
torch.set_num_threads(1)

NSIDE, LMAX = 16, 32
BINS = (0, 2, 10, 20)
BETA_TRUE = -2.8
COMPS = (dict(name="cmb", sed="cmb", nu_ref=100e9, unit="uK_cmb"),
         dict(name="synch", sed="power_law", nu_ref=30e9, theta0=(-3.1,)),
         dict(name="dust", sed="MBB", nu_ref=353e9, theta0=(1.6, 19.6)))
# per number of components: truth per component, bands, beam FWHM (arcmin)
MODELS = {2: ([(), (BETA_TRUE,)], (30e9, 70e9, 143e9), (420.0, 300.0, 240.0)),
          3: ([(), (BETA_TRUE,), (1.5, 21.0)], (30e9, 70e9, 143e9, 353e9),
              (420.0, 300.0, 240.0, 200.0))}


def _asdict(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _problem(S, ncomp=2, nside=NSIDE, lmax=LMAX):
    """tests/test_tpu_gibbs.py's problem in float64, for S = 1 or 3, with a
    beam per band so that beam_consistent has work; ncomp = 3 adds dust and
    a band. (The sky is synthesized once, by the port: both sides get the
    same data, and the transforms are held to each other elsewhere.)"""
    theta_true, freqs, fwhm = MODELS[ncomp]
    comps_j = tuple(JComp(**c) for c in COMPS[:ncomp])
    bps_j = tuple(jbp.delta_bandpass(nu) for nu in freqs)
    F_true = np.asarray(j_mixing_matrix(comps_j, bps_j, thetas=theta_true))
    rng = np.random.default_rng(0)
    nl, npix = lmax + 1, 12 * nside * nside
    plan_j = jsht.get_plan(nside, lmax, spin2=S == 3)
    plan_t = tsht.get_plan(nside, lmax, spin2=S == 3, dtype=torch.float64,
                           device="cpu")
    ell = np.arange(nl, dtype=float)
    cl = np.zeros((ncomp, S, nl))
    cl[:, :, 2:] = 300.0 / (ell[2:] * (ell[2:] + 1.0))
    a_true = np.asarray(j_random_alm_white(jax.random.PRNGKey(5),
                                           (ncomp, S, nl, nl))
                        * jnp.asarray(j_triangle_mask(nl, nl))) \
        * np.sqrt(cl)[..., None]
    bl = np.stack([np.asarray(j_gaussian_bl(fw, lmax))
                   for fw in fwhm])[:, None, :].repeat(S, 1)
    alm_b = np.einsum("bc,cslm->bslm", F_true, a_true) * bl[..., None]
    sky = tamp._synth(plan_t, torch.as_tensor(alm_b)).numpy()
    rms = 0.5
    data = sky + rms * rng.standard_normal(sky.shape)
    sys_j = jamp.build_system(jnp.asarray(F_true), jnp.asarray(bl),
                              jnp.full((len(freqs), S, npix), rms),
                              jnp.asarray(cl), jnp.asarray(data))
    gcfg_j = jgibbs.GibbsConfig(
        cl_cfg=JClModelConfig(kind="binned", lmax=lmax, nmaps=S,
                              bin_starts=BINS), cg_tol=1e-12, cg_maxiter=200)
    comps_t = [convert.diffuse_component(_asdict(c)) for c in comps_j]
    bps_t = [convert.bandpass(_asdict(b)) for b in bps_j]
    sys_t = convert.amplitude_system(_asdict(sys_j), device="cpu")
    gcfg_t = convert.gibbs_config(dataclasses.asdict(gcfg_j))
    return SimpleNamespace(comps_j=comps_j, bps_j=bps_j, plan_j=plan_j,
                           sys_j=sys_j, gcfg_j=gcfg_j, comps_t=comps_t,
                           bps_t=bps_t, plan_t=plan_t, sys_t=sys_t,
                           gcfg_t=gcfg_t, S=S, C=ncomp, lmax=lmax)


@pytest.fixture(scope="module")
def problems():
    return {1: _problem(1), "dust": _problem(1, ncomp=3)}


def _jax_draws(key, pb, nslot):
    """The reference's draws inside full_gibbs_step(..., key): gibbs_step
    splits the key into (next, k_amp, k_cl); the index keys hang off
    fold_in(next, 17)."""
    nxt, k_amp, k_cl = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_amp)
    S, nl = pb.S, pb.lmax + 1
    eta1 = jax.random.normal(k1, pb.sys_j.data.shape, jnp.float64)
    eta2 = j_random_alm_white(k2, (pb.C, S, nl, nl), jnp.float64) \
        * pb.sys_j.tri
    from commander_tpu.model.cl import bin_index_table
    idx = bin_index_table(pb.gcfg_j.cl_cfg)
    wl = 2.0 * np.arange(nl) + 1.0
    shape = np.maximum(pb.gcfg_j.cl_alpha0 + np.bincount(
        idx, weights=wl, minlength=len(BINS)) / 2.0, 0.5)
    gamma = np.stack([np.asarray(jax.random.gamma(
        k, jnp.asarray(shape)[None, :].repeat(S, 0)))
        for k in jax.random.split(k_cl, pb.C)])
    k_ind = jax.random.fold_in(nxt, 17)
    u = []
    for _ in range(nslot):
        k_ind, k = jax.random.split(k_ind)
        u.append(float(jax.random.uniform(k, (1,), jnp.float64)[0]))
    return {"eta1": torch.as_tensor(np.array(eta1)),
            "eta2": torch.as_tensor(np.array(eta2)),
            "gamma": torch.as_tensor(gamma),
            "u": torch.as_tensor(np.array(u))}


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def check_step_matches(pb, beam_consistent):
    """One full_gibbs_step of both packages on the problem pb, the port's
    with the JAX step's own draws, from the components' theta0; returns the
    new theta vector as a list."""
    S = pb.S
    slots_j = tpu_gibbs.make_index_slots(pb.comps_j)
    slots_t = tfg.make_index_slots(pb.comps_t)
    start = [pb.comps_t[s.ci].theta0[s.which] for s in slots_t]
    st_j = jgibbs.init_state(jax.random.PRNGKey(0), pb.C, S, pb.lmax,
                             len(BINS))
    key = jax.random.PRNGKey(42)
    step = jax.jit(partial(tpu_gibbs.full_gibbs_step, pb.gcfg_j, pb.comps_j,
                           pb.bps_j, slots_j,
                           beam_consistent=beam_consistent))
    new_j, th_j, sysn_j = step(pb.sys_j, pb.plan_j, st_j,
                               jnp.asarray(start, jnp.float64), key)
    st_t = convert.gibbs_state(_asdict(st_j), device="cpu")
    new_t, th_t, sysn_t = tfg.full_gibbs_step(
        pb.gcfg_t, pb.comps_t, pb.bps_t, slots_t, pb.sys_t, pb.plan_t, st_t,
        convert.thetas(start, device="cpu"),
        draws=_jax_draws(key, pb, len(slots_t)),
        beam_consistent=beam_consistent)
    assert th_t.dtype == torch.float64 and th_t.shape == (len(start),)
    # 1e-8 of each parameter's scale (T_d is ~20, the others ~1)
    for t, j, t0 in zip(th_t.tolist(), np.asarray(th_j), start):
        assert abs(t - j) <= 1e-8 * max(1.0, abs(t0))
    assert _rel(new_t.a.numpy(), new_j.a) <= 1e-8
    assert _rel(new_t.cl_bins.numpy(), new_j.cl_bins) <= 1e-8
    assert _rel(sysn_t.F.numpy(), sysn_j.F) <= 1e-8
    assert new_t.cg_iters == int(new_j.cg_iters) and new_t.it == 1
    return th_t.tolist()


def _pcfgs():
    return [SimpleNamespace(indices={}),
            SimpleNamespace(indices={"beta": dict(
                low=-3.6, high=-2.4, prior_mean=-3.0, prior_rms=0.1,
                lnl_type="marginal")}),
            SimpleNamespace(indices={"beta": dict(low=1.0, high=2.0),
                                     "T": dict(prior_mean=20.0)}),
            SimpleNamespace(indices={}),
            SimpleNamespace(indices={"nu_p": dict(
                low=15.0, high=30.0, prior_mean=21.0, prior_rms=2.0)})]


@pytest.mark.parametrize("with_pcfgs", [False, True])
def test_make_index_slots_matches(with_pcfgs):
    comps_t = entry.components("fullgibbs")
    comps_j = [JComp(**_asdict(c)) for c in comps_t]
    pc = _pcfgs() if with_pcfgs else None
    ngrid = 48 if with_pcfgs else 64
    if with_pcfgs:
        # free-free has no entry of its own: pad as the reference indexes
        pc[3] = SimpleNamespace(indices={"Te": {}})
    sj = tpu_gibbs.make_index_slots(comps_j, pc, ngrid=ngrid)
    st = tfg.make_index_slots(comps_t, pc, ngrid=ngrid)
    assert len(st) == len(sj) == 5
    for a, b in zip(st, sj):
        assert (a.ci, a.which) == (b.ci, b.which)
        assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
        assert convert.index_slot(dataclasses.asdict(b)) == a


def test_beta_recovery_with_the_ports_generator(problems):
    """tests/test_tpu_gibbs.py's check on the port's own draws: 8 steps from
    beta = -3.1; the mean of the last 5 within 0.1 of the truth."""
    pb = problems[1]
    slots = tfg.make_index_slots(pb.comps_t)
    gcfg = dataclasses.replace(pb.gcfg_t, cg_tol=1e-7, cg_maxiter=60)
    gen = torch.Generator()
    gen.manual_seed(42)
    state = tgibbs.init_state(2, 1, LMAX, len(BINS), device="cpu")
    th = convert.thetas([-3.1], device="cpu")
    betas = []
    for _ in range(8):
        state, th, sys_new = tfg.full_gibbs_step(
            gcfg, pb.comps_t, pb.bps_t, slots, pb.sys_t, pb.plan_t, state,
            th, gen, beam_consistent=True)
        betas.append(float(th[0]))
    assert abs(np.mean(betas[3:]) - BETA_TRUE) < 0.1, betas
    assert state.cg_iters > 0 and state.it == 8
    assert torch.isfinite(state.cl_bins).all()
    # the returned system carries F at the last beta
    F_last = j_mixing_matrix(pb.comps_j, pb.bps_j,
                             thetas=[(), (betas[-1],)])
    assert _rel(sys_new.F[..., 0].numpy(), F_last) <= 1e-12


def test_template_and_point_source_rows_are_refused(problems):
    """Template and point-source rows are ported (sampling/joint.py): the
    step takes them with the diagonal preconditioner, the only one the JAX
    package's joint solve uses, and refuses them with another, which the
    JAX package would silently ignore."""
    from commander_tpu_torch.sampling import joint as tjoint

    pb = problems[1]
    slots = tfg.make_index_slots(pb.comps_t)
    ts = tjoint.make_md_templates(NSIDE, 3, device="cpu")
    ps = tjoint.gaussian_stamp_ptsrc(NSIDE, [5, 900], np.ones((3, 2)),
                                     np.full(3, 300.0), npatch=8,
                                     device="cpu")
    state = tgibbs.init_state(2, 1, LMAX, len(BINS), device="cpu",
                              ntemp=12, nsrc=2)
    step = lambda cfg, **kw: tfg.full_gibbs_step(
        cfg, pb.comps_t, pb.bps_t, slots, pb.sys_t, pb.plan_t, state,
        convert.thetas([-3.1], device="cpu"), torch.Generator(), **kw)
    for setting in (dict(cg_precond="pseudoinv"), dict(cg_lmax_precond=4)):
        cfg = dataclasses.replace(pb.gcfg_t, cg_maxiter=2, **setting)
        for kw in (dict(ts=ts), dict(ps=ps)):
            with pytest.raises(ValueError, match="diagonal"):
                step(cfg, **kw)
    new, _, _ = step(dataclasses.replace(pb.gcfg_t, cg_maxiter=2), ts=ts,
                     ps=ps)
    assert new.t.shape == (12,) and new.p.shape == (2,)


def test_convert_round_trip():
    comp = JComp(name="ame", sed="spindust2", nu_ref=22e9, polarized=True,
                 theta0=(21e9, 0.1), unit="uK_RJ")
    got = convert.diffuse_component(_asdict(comp))
    assert _asdict(got) == _asdict(comp) and got.npar == comp.npar == 2
    with pytest.raises(NotImplementedError, match="sed"):
        convert.diffuse_component(dict(_asdict(comp), sed="md"))
    bp = jbp.Bandpass(np.linspace(60e9, 80e9, 9), np.linspace(1, 2, 9),
                      "MJy/sr", "HFI_submm")
    tb = convert.bandpass(_asdict(bp))
    assert (tb.unit, tb.profile_type, tb.nu_c) == (bp.unit, bp.profile_type,
                                                  bp.nu_c)
    np.testing.assert_array_equal(tb.nu, bp.nu)
    np.testing.assert_array_equal(tb.tau, bp.tau)
    with pytest.raises(NotImplementedError, match="unit"):
        convert.bandpass(dict(_asdict(bp), unit="Jy"))
    with pytest.raises(NotImplementedError, match="lnl_type"):
        convert.specind_config(dict(grid_min=0.0, grid_max=1.0,
                                    lnl_type="profile"))
    th = convert.thetas(jnp.asarray([-3.1, 1.6], jnp.float32), device="cpu")
    assert th.dtype == torch.float64 and th.shape == (2,)


@pytest.mark.parametrize("preset", ["entry_full", "tutorial_full",
                                    "fullgibbs"])
def test_full_presets_build_and_step(preset):
    """The presets of the whole iteration at nside 8 / lmax 16: a simulated
    sky whose conditional index draws, given the true amplitudes, land by
    the truth, and one finite step from the start values."""
    pb = entry.build_preset(preset, torch.float64, "cpu", nside=8, lmax=16)
    assert isinstance(pb, entry.FullProblem) and pb.beam_consistent
    nslot = 5 if preset == "fullgibbs" else 3
    assert len(pb.slots) == len(pb.theta_true) == nslot
    assert pb.thetas0.dtype == torch.float64
    assert pb.sys.data.shape == (len(pb.bps), 1 if preset == "fullgibbs"
                                 else 3, 768)
    assert pb.a_true.shape == (len(pb.comps),) + tuple(pb.sys.data.shape[1:2]
                                                       ) + (17, 17)
    start = [pb.comps[s.ci].theta0[s.which] for s in pb.slots]
    assert pb.thetas0.tolist() == start and list(pb.theta_true) != start
    gen = torch.Generator()
    gen.manual_seed(0)
    state, th, sys_new = tfg.full_gibbs_step(
        pb.cfg, pb.comps, pb.bps, pb.slots, pb.sys, pb.plan,
        entry.initial_state(pb.cfg, pb.sys), pb.thetas0, gen,
        beam_consistent=pb.beam_consistent)
    assert th.shape == (nslot,) and torch.isfinite(th).all()
    assert torch.isfinite(torch.view_as_real(state.a)).all()
    assert sys_new.F.shape == pb.sys.F.shape
    for s, t in zip(pb.slots, th.tolist()):
        assert s.cfg.grid_min <= t <= s.cfg.grid_max
    # the data are the sky of (a_true, theta_true): chi-square per pixel ~ 1
    from commander_tpu_torch.sampling import chisq
    sys_true = tfg.system_at(pb.sys, pb.comps, pb.bps, pb.slots,
                             torch.tensor(pb.theta_true, dtype=torch.float64))
    chi2, _, ndof = chisq.compute_chisq(sys_true, pb.plan, pb.a_true)
    assert abs(float(chi2) / int(ndof) - 1.0) < 0.1


def test_full_gibbs_step_with_joint_rows_matches(problems):
    """With the joint presets' rows at this size (md per band, prior 0 +-
    100; relquad pinned at 1; 6 sources; test_torch_joint.jax_rows), their
    signal in the data: one three-slot full_gibbs_step of both packages from
    nonzero (a, t, p), the port with the JAX step's own draws (eta_t, eta_p
    too), at the presets' CG tol 1e-6: theta, a, t, p to 1e-8, the same CG
    iterations (a handful: the pinned row's 1e12 in the rhs ends the
    relative-residual test early; a solve to 1e-12 of |b| would leave the
    diffuse block solved only to ~1 absolute, where two float64 solvers
    part at 1e-6, test_torch_joint.py has the solve without the pin)."""
    from test_torch_joint import jax_rows, joint_step_draws

    pb = problems["dust"]
    _, freqs, fwhm = MODELS[3]
    ts_j, ps_j, t0, p0, extra = jax_rows(NSIDE, freqs, fwhm)
    sys_j = dataclasses.replace(pb.sys_j, data=pb.sys_j.data + extra)
    sys_t = convert.amplitude_system(_asdict(sys_j), device="cpu")
    ts_t = convert.template_set(_asdict(ts_j), device="cpu")
    ps_t = convert.ptsrc_set(_asdict(ps_j), 12 * NSIDE ** 2, device="cpu")
    slots_j = tpu_gibbs.make_index_slots(pb.comps_j)
    slots_t = tfg.make_index_slots(pb.comps_t)
    start = [pb.comps_t[s.ci].theta0[s.which] for s in slots_t]
    nl = LMAX + 1
    a0 = np.asarray(j_random_alm_white(jax.random.PRNGKey(8),
                                       (3, 1, nl, nl))
                    * jnp.asarray(j_triangle_mask(nl, nl))) \
        * np.sqrt(np.asarray(sys_j.cl))[..., None]
    st_j = dataclasses.replace(
        jgibbs.init_state(jax.random.PRNGKey(0), 3, 1, LMAX, len(BINS),
                          ntemp=len(t0), nsrc=len(p0)),
        a=jnp.asarray(a0), t=jnp.asarray(t0), p=jnp.asarray(p0))
    key = jax.random.PRNGKey(42)
    gcfg_j = dataclasses.replace(pb.gcfg_j, cg_tol=1e-6)
    step = jax.jit(partial(tpu_gibbs.full_gibbs_step, gcfg_j, pb.comps_j,
                           pb.bps_j, slots_j, beam_consistent=True))
    new_j, th_j, _ = step(sys_j, pb.plan_j, st_j,
                          jnp.asarray(start, jnp.float64), key, ts=ts_j,
                          ps=ps_j)
    new_t, th_t, _ = tfg.full_gibbs_step(
        convert.gibbs_config(dataclasses.asdict(gcfg_j)), pb.comps_t,
        pb.bps_t, slots_t, sys_t, pb.plan_t,
        convert.gibbs_state(_asdict(st_j), device="cpu"),
        convert.thetas(start, device="cpu"),
        draws=joint_step_draws(key, pb, len(slots_t), len(t0), len(p0)),
        beam_consistent=True, ts=ts_t, ps=ps_t)
    for t, j, s0 in zip(th_t.tolist(), np.asarray(th_j), start):
        assert abs(t - j) <= 1e-8 * max(1.0, abs(s0))
    for k in ("a", "t", "p", "cl_bins"):
        assert _rel(getattr(new_t, k).numpy(), getattr(new_j, k)) <= 1e-8, k
    assert new_t.cg_iters == int(new_j.cg_iters) <= 6
    # relquad stays at its mean, within a few of its prior's 1e-6
    assert abs(float(new_t.t[-1]) - 1.0) <= 1e-5
