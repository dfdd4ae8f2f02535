"""The parts of run()'s host loop that its TOD branch, --cg-groups,
OUTPUT_EVERY_NTH_CG_ITERATION and OUTPUT_DEBUG_SEDS run, and the two
modules no driver path calls, function by function against the JAX
package, float64 on the CPU.

One problem for all: param_tutorial_full.txt's model at nside 8 / lmax 16,
T/Q/U (cmb, synch, dust, ff, ame; 13 md and relquad rows; the radio
sources), built by the JAX package and converted, with one band of TOD (4
scans x 2 detectors x 1024 samples) simulated from its sky by the JAX
simulator. Draws are regenerated from the JAX keys in the reference's
order. Tolerances: the unit component streams, the per-detector chi^2, the
TOD chi^2 moves and the 4D files 1e-10; the per-detector mixing (float32
in both) 1e-7; draws through a CG (the groups, the chunked CG's dumps)
1e-8; sed.dat the same text; the priors 1e-10; the 3j symbols 1e-12.
"""
import dataclasses
import os
from types import SimpleNamespace

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu.ops import wigner3j as jw3j
from commander_tpu.sampling import amplitude as jamp
from commander_tpu.sampling import groups as jgroups
from commander_tpu.sampling import mh as jmh
from commander_tpu.sampling import priors as jpriors
from commander_tpu.sphere import healpix as jhp
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu.tod import bandpass_mh as jbpmh
from commander_tpu.tod import maps4d as jmaps4d
from commander_tpu.tod import model as jtm
from commander_tpu.tod import sim as jsim
from commander_tpu_torch import convert
from commander_tpu_torch.driver import loop
from commander_tpu_torch.driver.model import band_bandpasses, comp_to_diffuse
from commander_tpu_torch.driver.model import diffuse_configs
from commander_tpu_torch.ops import wigner3j as tw3j
from commander_tpu_torch.sampling import amplitude as tamp
from commander_tpu_torch.sampling import groups as tgroups
from commander_tpu_torch.sampling import mh as tmh
from commander_tpu_torch.sampling import priors as tpriors
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.tod import bandpass_mh as tbpmh
from commander_tpu_torch.tod import maps4d as tmaps4d
from test_torch_driver import _cfgs
from test_torch_full_gibbs import _asdict
from test_torch_jax_refs import jit_call

torch.set_num_threads(2)

NSIDE, LMAX = 8, 16
NPIX = 12 * NSIDE ** 2
T = torch.as_tensor


def _rel(got, ref):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _normal(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float64))


@pytest.fixture(scope="module")
def world():
    """The tutorial model by both packages (JAX built, converted), amplitudes
    near the truth, and a band of TOD with a state."""
    jcfg, tcfg = _cfgs("--CG_SAMPLING_GROUP01=md,cmb",
                       "--NUM_CG_SAMPLING_GROUPS=1")
    out = jrun.build_model(jcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                           dtype="float64", pol=True)
    plan_j, sys_j, diffuse_j, bps_j = out[:4]
    meta_j, truth, ts_j, ps_j = out[6], out[7], out[9], out[10]
    rng = np.random.default_rng(3)
    a = truth[0] + 1j * truth[1]
    t0 = np.asarray(ts_j.prior_mean) + rng.standard_normal(
        ts_j.prior_mean.shape)
    p0 = np.asarray(meta_j["ptsrc_true"])
    sky = np.asarray(meta_j["sky_true"])[1]
    blk_j, _ = jsim.simulate_tod(NSIDE, sky, nscan=4, ndet=2, ntod=1024,
                                 sigma0=0.5, nu=44e9, pol=True, seed=4)
    st_j = jtm.TodState(
        gain=jnp.asarray(1.0 + 0.01 * rng.standard_normal((4, 2))),
        sigma0=jnp.full((4, 2), 0.5), alpha=jnp.full((4, 2), -1.0),
        fknee=jnp.full((4, 2), 0.1),
        n_corr=jnp.asarray(0.1 * rng.standard_normal(blk_j.tod.shape)))
    pc = diffuse_configs(tcfg)
    return SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, plan_j=plan_j, sys_j=sys_j,
        diffuse_j=diffuse_j, bps_j=bps_j, ts_j=ts_j, ps_j=ps_j, meta_j=meta_j,
        a_j=jnp.asarray(a), t0=t0, p0=p0, blk_j=blk_j, st_j=st_j,
        plan=tsht.get_plan(NSIDE, LMAX, spin2=True, dtype=torch.float64,
                           device="cpu"),
        sys=convert.amplitude_system(_asdict(sys_j), device="cpu"),
        ts=convert.template_set(_asdict(ts_j), device="cpu"),
        ps=convert.ptsrc_set(_asdict(ps_j), NPIX, device="cpu"),
        diffuse=[comp_to_diffuse(c) for c in pc], bps=band_bandpasses(tcfg),
        a=T(a), blk=convert.tod_block(_asdict(blk_j), device="cpu"),
        st=convert.tod_state(_asdict(st_j), device="cpu"),
        thetas_j=[tuple(d.theta0) for d in diffuse_j],
        thetas=[list(d.theta0) for d in diffuse_j])


def _unit_streams(w):
    ref = jit_call(jbpmh.unit_comp_tod, w.plan_j, w.sys_j.bl[1], w.a_j,
                   w.blk_j, True)
    got = tbpmh.unit_comp_tod(w.plan, w.sys.bl[1], w.a, w.blk, True)
    return got, ref


def _static(w):
    pv = jnp.asarray(jhp.pix2vec_ring(NSIDE))
    mono = jnp.asarray([0.2, -0.2])
    s_j = jtm.orbital_dipole(w.blk_j.vsun, pv, 44e9, w.blk_j.pix) \
        + mono[None, :, None]
    return s_j, T(np.asarray(s_j))


def part_unit_comp_tod(w, tmp):
    got, ref = _unit_streams(w)
    assert got.shape == ref.shape and _rel(got, ref) <= 1e-10


def part_det_mixing(w, tmp):
    dd = np.array([0.3e9, -0.2e9])
    ref = jbpmh.det_mixing(w.diffuse_j, [w.bps_j[1]] * 2, w.thetas_j,
                           jnp.asarray(dd))
    got = tbpmh.det_mixing(w.diffuse, [w.bps[1]] * 2, w.thetas, T(dd))
    assert got.dtype == torch.float32 and _rel(got, ref) <= 1e-7


def part_chisq_det(w, tmp):
    (cj, ct), (s_j, s_t) = _unit_streams(w)[::-1], _static(w)
    F_j = jbpmh.det_mixing(w.diffuse_j, [w.bps_j[1]] * 2, w.thetas_j,
                           jnp.zeros(2))
    ref = jbpmh.chisq_det(F_j, cj, s_j, w.blk_j, w.st_j)
    got = tbpmh.chisq_det(T(np.asarray(F_j)), ct, s_t, w.blk, w.st)
    assert got.shape == (2,) and _rel(got, ref) <= 1e-10


def part_sample_bp_det(w, tmp):
    (cj, ct), (s_j, s_t) = _unit_streams(w)[::-1], _static(w)
    key = jax.random.PRNGKey(11)
    dd0 = np.array([0.05e9, -0.05e9])
    ref = jbpmh.sample_bp_det(key, w.diffuse_j, w.thetas_j,
                              [w.bps_j[1]] * 2, cj, s_j, w.blk_j, w.st_j,
                              jnp.asarray(dd0), n_prop=4, band_delta=0.1e9)
    draws, k = [], key
    for _ in range(4):
        k, k1, k2 = jax.random.split(k, 3)
        draws.append({"eta": _normal(k1, (2,)),
                      "u": float(jax.random.uniform(k2, ()))})
    got = tbpmh.sample_bp_det(w.diffuse, w.thetas, [w.bps[1]] * 2, ct, s_t,
                              w.blk, w.st, T(dd0), n_prop=4,
                              band_delta=0.1e9, draws=draws)
    assert got[2] == ref[2] and _rel(got[0], ref[0]) <= 1e-10
    assert _rel(got[1], ref[1]) <= 1e-10


def part_sample_bandpass_shift(w, tmp):
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        deltas = np.array([0.0, 0.2e9, -0.1e9])
        ref = jmh.sample_bandpass_shift(key, w.diffuse_j, w.bps_j,
                                        w.thetas_j, w.sys_j, w.plan_j,
                                        w.a_j, jnp.asarray(deltas), 1,
                                        step_hz=2e9)
        got = tmh.sample_bandpass_shift(
            w.diffuse, w.bps, w.thetas, w.sys, w.plan, w.a, T(deltas), 1,
            step_hz=2e9, draws={
                "z": float(jax.random.normal(k1, (), jnp.float64)),
                "u": float(jax.random.uniform(k2, (), jnp.float64))})
        assert bool(got[2]) == bool(ref[2])
        assert _rel(got[0], ref[0]) <= 1e-12 and _rel(got[1], ref[1]) <= 1e-12


def part_accept_bandpass_tod(w, tmp):
    for seed, (c_cur, c_prop) in enumerate(((100.0, 101.5), (100.0, 99.0),
                                            (5e3, 5e3 + 0.2))):
        key = jax.random.PRNGKey(seed)
        ref = jmh.accept_bandpass_tod(key, c_cur, c_prop, 0.1e9, 0.3e9)
        got = tmh.accept_bandpass_tod(c_cur, c_prop, 0.1e9, 0.3e9, u=float(
            jax.random.uniform(key, (), jnp.float64)))
        assert got == (float(ref[0]), bool(ref[1]))


def part_write_4d_hdf(w, tmp):
    iv = jnp.full((4,), 2.0)
    ss, ws, mn = jmaps4d.bin_4d(w.blk_j.tod[:, 0], w.blk_j.pix[:, 0],
                                w.blk_j.psi[:, 0], w.blk_j.mask[:, 0], iv,
                                NPIX, 16)
    for d in ("det0", "det1"):
        jmaps4d.write_4d_hdf(str(tmp / "jax.h5"), d, ss, ws, mn)
        tmaps4d.write_4d_hdf(str(tmp / "port.h5"), d, T(np.asarray(ss)),
                             T(np.asarray(ws)), np.asarray(mn))
    # a second write to one group replaces its datasets
    tmaps4d.write_4d_hdf(str(tmp / "port.h5"), "det1", T(np.asarray(ss)),
                         T(np.asarray(ws)), np.asarray(mn))
    with h5py.File(tmp / "jax.h5", "r") as r, \
            h5py.File(tmp / "port.h5", "r") as g:
        assert sorted(g) == sorted(r) == ["det0", "det1"]
        for d in r:
            assert sorted(g[d]) == sorted(r[d])
            for k in r[d]:
                assert g[d][k].dtype == r[d][k].dtype
                assert np.array_equal(g[d][k][()], r[d][k][()])


def part_build_groups(w, tmp):
    names = w.meta_j.get("template_names")
    ref = jgroups.build_groups(w.jcfg, [d.name for d in w.diffuse_j], names,
                               True, ptsrc_labels=["radio"], nmaps=3,
                               npix=NPIX)
    got = tgroups.build_groups(w.tcfg, [d.name for d in w.diffuse], names,
                               True, ptsrc_labels=["radio"], nmaps=3,
                               npix=NPIX)
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(g) for g in ref]
    assert got[0].temp_idx and got[0].comp_idx == (0,)


def _group_draws(k_g, g, w):
    """A group's draws under its key, in its solve's order."""
    k1, k2 = jax.random.split(k_g)
    d = {"eta1": T(_normal(k1, tuple(w.sys.data.shape)))}
    if not g.comp_idx:
        key = "eta_p" if g.ptsrc else "eta_t"
        n = w.ps.pix.shape[0] if g.ptsrc else len(g.temp_idx)
        d[key] = T(_normal(k2, (n,)))
        return d
    d["eta2"] = T(np.array(j_random_alm_white(
        k2, (len(g.comp_idx), 3, LMAX + 1, LMAX + 1), jnp.float64)))
    if g.temp_idx:
        kt, k2 = jax.random.split(k2)
        d["eta_t"] = T(_normal(kt, (len(g.temp_idx),)))
    if g.ptsrc:
        kp, k2 = jax.random.split(k2)
        d["eta_p"] = T(_normal(kp, (w.ps.pix.shape[0],)))
    return d


GROUP_KINDS = {
    "diffuse": dict(comp_idx=(1, 2), maxiter=60),
    "templates": dict(temp_idx=(0, 3, 12), maxiter=150),
    "sources": dict(ptsrc=True, maxiter=150),
    "mixed": dict(comp_idx=(0,), temp_idx=(1, 2), ptsrc=True, maxiter=60),
}


def _part_grouped(kind):
    def part(w, tmp):
        mask = np.ones((3, NPIX), np.float32)
        mask[:, ::5] = 0.0
        groups = (jgroups.SampGroup(name=kind, mask=mask,
                                    **GROUP_KINDS[kind]),
                  jgroups.SampGroup(name="ff", comp_idx=(3,), maxiter=60))
        key = jax.random.PRNGKey(21)
        a_j, t_j, p_j, res_j = jgroups.sample_amplitudes_grouped(
            groups, w.sys_j, w.plan_j, w.a_j, jnp.asarray(w.t0),
            jnp.asarray(w.p0), w.ts_j, w.ps_j, key, tol=1e-10)
        draws = [_group_draws(jax.random.fold_in(key, gi), g, w)
                 for gi, g in enumerate(groups)]
        tg = [tgroups.SampGroup(**dataclasses.asdict(g)) for g in groups]
        a, t, p, res = tgroups.sample_amplitudes_grouped(
            tg, w.sys, w.plan, w.a, T(w.t0), T(w.p0), w.ts, w.ps,
            draws=draws, tol=1e-10)
        assert _rel(a, a_j) <= 1e-8
        assert _rel(t, t_j) <= 1e-8 and _rel(p, p_j) <= 1e-8
        assert res.iters == int(res_j.iters)
    return part


def part_chunked_cg_dumps(w, tmp):
    sys_j = dataclasses.replace(w.sys_j, cl=w.sys_j.cl * 0.5)
    sys_t = dataclasses.replace(w.sys, cl=w.sys.cl * 0.5)
    key = jax.random.PRNGKey(5)
    dumps_j, dumps_t = [], []
    a_j, res_j = jamp.sample_amplitudes_chunked(
        sys_j, w.plan_j, key=key, tol=1e-14, maxiter=14, chunk=3,
        dump_every=3, dump_fn=lambda i, a: dumps_j.append((i, np.asarray(a))))
    k1, k2 = jax.random.split(key)
    C = sys_t.cl.shape[0]
    a_t, res_t = tamp.sample_amplitudes_chunked(
        sys_t, w.plan, eta1=T(_normal(k1, tuple(sys_t.data.shape))),
        eta2=T(np.array(j_random_alm_white(k2, (C, 3, LMAX + 1, LMAX + 1),
                                           jnp.float64))),
        tol=1e-14, maxiter=14, dump_every=3,
        dump_fn=lambda i, a: dumps_t.append((i, a.numpy())))
    assert [i for i, _ in dumps_t] == [i for i, _ in dumps_j] \
        == [3, 6, 9, 12]
    for (_, x), (_, y) in zip(dumps_t, dumps_j):
        assert _rel(x, y) <= 1e-8
    assert res_t.iters == int(res_j.iters) and _rel(a_t, a_j) <= 1e-8
    assert abs(res_t.rel_res - float(res_j.rel_res)) <= 1e-3 * float(
        res_j.rel_res)


def part_sed_dat(w, tmp):
    os.makedirs(tmp / "jax")
    jcfg = dataclasses.replace(w.jcfg, output_debug_seds=True)
    jrun.run(jcfg, nside=NSIDE, lmax=LMAX, synthetic=True, niter=1,
             outdir=str(tmp / "jax"), verbose=False, pol=True)
    loop.write_debug_seds(str(tmp / "sed.dat"), w.diffuse)
    got = open(tmp / "sed.dat").read()
    assert got == open(tmp / "jax" / "sed.dat").read()
    assert got.count("# Component") == 5


def part_priors(w, tmp):
    rng = np.random.default_rng(2)
    alm = rng.standard_normal((2, 3, 9, 9)) + 1j * rng.standard_normal(
        (2, 3, 9, 9))
    for k0, k1 in ((False, False), (True, False), (False, True)):
        ref = jpriors.project_out_monodipole(jnp.asarray(alm), k0, k1)
        assert _rel(tpriors.project_out_monodipole(T(alm), k0, k1),
                    ref) == 0.0
    pv = jhp.pix2vec_ring(NSIDE)
    maps = rng.standard_normal((2, NPIX)) + 3.0 + pv @ [1.0, -2.0, 0.5]
    mask = (pv[:, 2] < 0.3).astype(np.float64)
    ref = jpriors.masked_monodipole_fit(jnp.asarray(maps), jnp.asarray(mask),
                                        jnp.asarray(pv))
    got = tpriors.masked_monodipole_fit(T(maps), T(mask), T(pv))
    assert all(_rel(g, r) <= 1e-10 for g, r in zip(got, ref))
    for dip in (True, False):
        ref = jpriors.subtract_masked_monopole(
            jnp.asarray(maps), jnp.asarray(mask), jnp.asarray(pv), dip)
        got = tpriors.subtract_masked_monopole(T(maps), T(mask), T(pv), dip)
        assert all(_rel(g, r) <= 1e-10 for g, r in zip(got, ref))


def part_wigner_3j(w, tmp):
    for args in ((1, 1, 0, 0, 0, 0), (2, 2, 2, 0, 0, 0), (2, 0, 2, 0, 0, 0),
                 (1, 1, 1, 0, 0, 0), (6, 4, 5, 1, -3, 2), (4, 5, 6, -3, 2, 1),
                 (40, 37, 12, 5, -3, -2), (3, 3, 9, 0, 0, 0)):
        assert abs(tw3j.wigner_3j(*args) - jw3j.wigner_3j(*args)) <= 1e-12
    for args in ((10, 7, 3, -2), (30, 25, 0, 0), (5, 5, 2, 2)):
        lg, sg = tw3j.wigner_3j_series(*args)
        lr, sr = jw3j.wigner_3j_series(*args)
        assert lg == lr and np.abs(sg - sr).max() <= 1e-12


def part_mono_guard(w, tmp):
    """The port-only monopole guard (no JAX counterpart): on this TOD some
    hit pixels are seen at fewer than three angles; with the guard the draw
    leaves them out and moves by less than 1e-6 of its size when the normal
    equations move by 1e-12, zero-sum; T only it changes nothing."""
    from commander_tpu_torch.tod import model as TM
    rng = np.random.default_rng(8)
    tod = w.blk.tod + T(np.array([0.4, -0.4]))[None, :, None]
    A, b = TM.bin_tod_mono(tod, w.blk.pix, w.blk.psi, w.blk.mask,
                           T(np.full((4, 2), 4.0)), NPIX, True)
    eta = T(np.array([0.3]))
    moved = lambda x: x * (1.0 + 1e-12 * T(rng.standard_normal(x.shape)))
    m1, ok1 = TM.sample_mono(A, b, 3, eta=eta, guard=True)
    m2, _ = TM.sample_mono(moved(A), moved(b), 3, eta=eta, guard=True)
    assert float(ok1) == 1.0 and abs(float(m1.sum())) <= 1e-10
    assert _rel(m2, m1) <= 1e-6
    ev = torch.linalg.eigvalsh(A[:, :3, :3])
    lo, hi = TM.sym3_eig_range(A[:, :3, :3])
    assert float(torch.max(torch.abs(lo - ev[:, 0]) + torch.abs(
        hi - ev[:, -1])) / torch.max(ev)) <= 1e-10
    hit = A[:, 0, 0] > 0
    assert bool(torch.any(hit & (ev[:, 0] <= TM.MONO_RCOND * ev[:, -1])))
    A1, b1 = TM.bin_tod_mono(tod, w.blk.pix, w.blk.psi, w.blk.mask,
                             T(np.full((4, 2), 4.0)), NPIX, False)
    assert torch.equal(TM.sample_mono(A1, b1, 1, eta=eta, guard=True)[0],
                       TM.sample_mono(A1, b1, 1, eta=eta)[0])


PARTS = {"unit_comp_tod": part_unit_comp_tod,
         "det_mixing": part_det_mixing, "chisq_det": part_chisq_det,
         "sample_bp_det": part_sample_bp_det,
         "sample_bandpass_shift": part_sample_bandpass_shift,
         "accept_bandpass_tod": part_accept_bandpass_tod,
         "write_4d_hdf": part_write_4d_hdf,
         "build_groups": part_build_groups,
         **{f"grouped_{k}": _part_grouped(k) for k in GROUP_KINDS},
         "chunked_cg_dumps": part_chunked_cg_dumps,
         "sed_dat": part_sed_dat, "priors": part_priors,
         "mono_guard": part_mono_guard,
         "wigner_3j": part_wigner_3j}


@pytest.mark.parametrize("part", list(PARTS))
def test_host_part_matches(world, tmp_path, part):
    """Each part against its JAX counterpart on the same inputs and
    draws, at the module docstring's tolerances."""
    PARTS[part](world, tmp_path)


@pytest.mark.parametrize("rows", ["md", "sources"])
def test_qucov_with_rows_is_refused_before_the_build(tmp_path, rows,
                                                     monkeypatch):
    """A QU-covariance noise file (BAND_NOISE_FORMAT QUcov) on a T/Q/U run
    from FITS maps beside md or source rows raises from refuse_host_loop,
    naming ROADMAP queue 3 item 12, before build_model runs; without the
    rows it is not refused there."""
    from commander_tpu_torch.io import fits as tfits
    from commander_tpu_torch.io.params import Params, lower_params

    npix = 12 * 4 ** 2
    cov = np.stack([np.full(npix, 2.0), np.full(npix, 4.0),
                    np.full(npix, 0.5), np.full(npix, 4.0)])
    tfits.write_map(str(tmp_path / "qucov.fits"), cov)
    off = ["--INCLUDE_COMP05=.false." if rows == "md"
           else "--INCLUDE_COMP04=.false.", "--INCLUDE_COMP08=.false."]
    over = ["--BAND_NOISE_FORMAT001=QUcov",
            "--BAND_NOISEFILE001=qucov.fits"]

    def built(*a, **k):
        raise AssertionError("build_model ran")
    monkeypatch.setattr(loop, "build_model", built)
    cfg = lower_params(Params.load("param_tutorial_full.txt", over + off))
    with pytest.raises(NotImplementedError, match="queue 3 item 12"):
        loop.run(cfg, nside=4, lmax=8, pol=True, data_dir=str(tmp_path),
                 outdir=str(tmp_path / "out"), device="cpu", niter=1)
    bare = lower_params(Params.load(
        "param_tutorial_full.txt", over + ["--INCLUDE_COMP04=.false.",
                                           "--INCLUDE_COMP05=.false.",
                                           "--INCLUDE_COMP08=.false."]))
    with pytest.raises(AssertionError, match="build_model ran"):
        loop.run(bare, nside=4, lmax=8, pol=True, data_dir=str(tmp_path),
                 outdir=str(tmp_path / "out2"), device="cpu", niter=1)
