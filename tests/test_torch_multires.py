"""The port's multi-resolution path against the JAX package, float64 on the
CPU: sphere/wigner.py and the pixel windows, sampling/multires.py,
sampling/gain.py, entry.build_multi_problem (run.build_multi_model) and one
whole multires_gibbs_step (run.run_multires' loop).

The step runs param_tutorial_full.txt reduced to cmb, synch and ff (two
free parameters: synch beta, ff T_e), its 30 and 44 GHz bands at nside 4 /
lmax 8 and 70 GHz at nside 8 / lmax 16 (two resolution groups), T/Q/U,
every band sampling its gain, CG tol 1e-12. run_multires itself takes two
iterations (its chain file holds the amplitudes, the flat theta and the
gains); every draw of the port's step is regenerated from run_multires' key
chain: fold_in(PRNGKey(BASE_SEED), 1) split into (k1, k2, k3); k1 into one
eta1 per group and eta2; k2 into one C_l key per component; k3 split once
per index draw, then once per gain-sampling band.

Tolerances: the operator, rhs and preconditioner 1e-10, a Wiener solve
1e-8, self-adjointness 1e-10, build_multi_problem 1e-12, the gain functions 1e-12,
the step 1e-8 in the port's form (against a JAX composition of the same
functions in that form) and, with the reference form patched in, the index
draws and gains 1e-10 against run_multires' own.

The program's --multires route end to end is
tests/test_torch_multires_main.py (one case, dealt beside
tests/test_sharding.py).
"""
import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.instrument import beam as jbeam
from commander_tpu.io.params import Params, lower_params
from commander_tpu.model.cl import bin_index_table as j_bin_index_table
from commander_tpu.model.mixing import mixing_matrix as j_mixing_matrix
from commander_tpu.run import build_multi_model, run_multires
from commander_tpu.sampling import amplitude as jamp
from commander_tpu.sampling import gain as jgain
from commander_tpu.sampling import multires as jmr
from commander_tpu.sampling import specind as jsi
from commander_tpu.sphere import sht as jsht
from commander_tpu.sphere import wigner as jwigner
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu_torch import convert, entry
from commander_tpu_torch import run as trun
from commander_tpu_torch.instrument import beam as tbeam
from commander_tpu_torch.sampling import gain as tgain
from commander_tpu_torch.sampling import multires as tmr
from commander_tpu_torch.sampling import multires_gibbs as mg
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.sphere import wigner as twigner
from commander_tpu_torch.sphere.alm import alm_dot

torch.set_num_threads(1)

PARAMS = "param_tutorial_full.txt"
BASE_SEED = 4321


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _asdict(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _ms_dict(ms):
    return dict(groups=[_asdict(g) for g in ms.groups], cl=ms.cl,
                tri=ms.tri)


def _cfg(keep, nsides, lmax_amp=None):
    """param_tutorial_full.txt with the components `keep`, polarized bands
    at `nsides` (lmax 2 nside) sampling their gains, CG tol 1e-12."""
    cfg = lower_params(Params.load(PARAMS))
    cfg.comps = [c for c in cfg.comps if c.label in keep]
    for c in cfg.comps:
        c.template_file = None
        c.polarized = True
        if lmax_amp and c.label in lmax_amp:
            c.lmax_amp = lmax_amp[c.label]
    for b, ns in zip(cfg.bands, nsides):
        b.nside, b.lmax = ns, 2 * ns
        b.polarized = True
        b.sample_gain = True
    cfg.sample_specind = True
    cfg.cg_tol = 1e-12
    cfg.cg_maxiter = 300
    cfg.base_seed = BASE_SEED
    cfg.output_dir = None
    return cfg


def _problem(cfg):
    """(JAX build_multi_model outputs, the port's MultiProblem from the
    same config and the JAX a_true)."""
    ms, plans, diffuse, cl_cfg, meta, a_true = build_multi_model(
        cfg, synthetic=True, pol=True)
    pb = entry.build_multi_problem(
        convert.run_config(dataclasses.asdict(cfg)), seed=0,
        dtype=torch.float64, device="cpu", pol=True, a_true=a_true)
    return SimpleNamespace(ms=ms, plans=plans, diffuse=diffuse,
                           cl_cfg=cl_cfg, meta=meta, a_true=a_true, pb=pb,
                           cfg=cfg)


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    """The reduced problem on both sides and run_multires' first two
    iterations (its chain file's samples 1 and 2)."""
    from commander_tpu.io.chain import ChainFile

    cfg = _cfg(("cmb", "synch", "ff"), (4, 4, 8))
    case = _problem(cfg)
    out = str(tmp_path_factory.mktemp("chains"))
    _, path, _ = run_multires(cfg, niter=2, outdir=out, synthetic=True,
                              verbose=False, pol=True)
    case.chain_path = path
    with ChainFile(path, "r") as ch:
        s = ch.read_sample(1)
    names = [d.name for d in case.diffuse]
    case.chain_a = np.stack([s["comps"][n]["alm"] for n in names])
    case.chain_theta = np.asarray(s["aux"]["specind"])
    case.chain_gains = np.asarray(s["gain"])
    case.key = jax.random.fold_in(jax.random.PRNGKey(BASE_SEED), 1)
    return case


def _band_order(case):
    """run_multires' gain order: groups, then bands of a group."""
    bs = case.meta["band_slot"]
    return [i for g in range(len(case.plans))
            for i in range(len(case.cfg.bands)) if bs[i][0] == g]


def _draws(case, key=None):
    """Every draw of an iteration of run_multires from its key chain
    (default: the first's); returns them and the next iteration's key."""
    ms, G = case.ms, len(case.ms.groups)
    C, S, nl = ms.cl.shape
    k1, k2, k3 = jax.random.split(case.key if key is None else key, 3)
    keys = jax.random.split(k1, G + 1)
    eta1 = [torch.as_tensor(np.array(jax.random.normal(
        keys[g], ms.groups[g].data.shape, jnp.float64))) for g in range(G)]
    eta2 = np.array(j_random_alm_white(keys[-1], (C, S, nl, nl),
                                       jnp.float64) * ms.tri)
    idx = j_bin_index_table(case.cl_cfg)
    nb = len(case.cl_cfg.bin_starts)
    shape = np.maximum(-1.0 + np.bincount(idx, weights=2.0 * np.arange(nl)
                                          + 1.0, minlength=nb) / 2.0, 0.5)
    gamma = np.stack([np.asarray(jax.random.gamma(
        k, jnp.asarray(shape)[None, :].repeat(S, 0)))
        for k in jax.random.split(k2, C)])
    key, u = k3, []
    for _ in case.pb.slots:
        key, ik = jax.random.split(key)
        u.append(float(jax.random.uniform(ik, (1,), jnp.float64)[0]))
    eps = np.zeros(len(case.cfg.bands))
    for i in _band_order(case):
        key, gk = jax.random.split(key)
        eps[i] = float(jax.random.normal(gk, (), jnp.float64))
    return dict(eta1=eta1, eta2=torch.as_tensor(eta2),
                gamma=torch.as_tensor(gamma),
                u=torch.tensor(u, dtype=torch.float64),
                eps_gain=torch.as_tensor(eps)), key


# ---------------------------------------------------------------------------
# wigner, beams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp", [0, 2, -2])
def test_wigner_table_matches(mp):
    """The port's copy of wigner_d_table_fast and _theta_halves, 1e-13."""
    for nside in (4, 8):
        ct, st = twigner._theta_halves(nside)
        ctj, stj = jwigner._theta_halves(nside)
        assert np.array_equal(ct, ctj) and np.array_equal(st, stj)
    got = twigner.wigner_d_table_fast(40, 40, mp, ct, st)
    ref = jwigner.wigner_d_table_fast(40, 40, mp, ctj, stj)
    assert np.abs(got - ref).max() <= 1e-13


def test_pixel_windows_match(tmp_path, monkeypatch):
    """Exact windows at nside 8 and 16 computed anew (an empty cache) to
    1e-12; the interpolated windows at nside 512 and 1024 identical;
    gaussian_bl with pol."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    for nside in (8, 16):
        got = tbeam.pixel_window_exact.__wrapped__(nside, 2 * nside)
        ref = jbeam.pixel_window_exact(nside, 2 * nside)
        assert np.abs(got - ref).max() <= 1e-12
        assert (tmp_path / "commander_tpu_torch"
                / f"pixwin_n{nside}_l{2 * nside}_r8.npy").exists()
    for nside, lmax in ((512, 1000), (1024, 2000)):
        assert np.array_equal(tbeam.pixel_window(nside, lmax),
                              jbeam.pixel_window(nside, lmax))
    for pol in (False, True):
        assert np.array_equal(tbeam.gaussian_bl(27.1, 64, pol=pol),
                              jbeam.gaussian_bl(27.1, 64, pol=pol))


# ---------------------------------------------------------------------------
# build_multi_problem
# ---------------------------------------------------------------------------

def test_build_multi_problem_matches(step_case):
    """build_multi_problem against build_multi_model on the tutorial's file
    reduced as tests/test_multires_full.py reduces it (cmb, synch, dust,
    synch's COMP_LMAX_AMP 10), at the step's resolutions (build_multi_model's
    transforms then reuse their compiled shapes): groups, F, b_l (with the
    pixel window), inv_rms^2, data, prior, window, bins and start values to
    1e-12."""
    case = _problem(_cfg(("cmb", "synch", "dust"), (4, 4, 8),
                         lmax_amp={"synch": 10}))
    pb, ms = case.pb, case.ms
    assert pb.groups == [tuple(g) for g in case.meta["groups"]]
    assert pb.band_slot == case.meta["band_slot"]
    assert [d.name for d in pb.diffuse] == case.meta["comps"]
    assert len(pb.ms.groups) == 2
    # synch's window: no prior power above l = 10
    assert float(pb.ms.cl[1, :, 11:].abs().max()) == 0.0
    assert float(pb.ms.cl[1, :, 2:11].min()) > 0.0
    for gt, gj in zip(pb.ms.groups, ms.groups):
        for f in ("F", "bl", "inv_rms2", "inv_rms", "data"):
            assert _rel(getattr(gt, f).numpy(), getattr(gj, f)) <= 1e-12, f
    assert _rel(pb.ms.cl.numpy(), ms.cl) <= 1e-12
    assert np.array_equal(pb.ell_mask.numpy(), case.meta["ell_mask"])
    assert pb.cl_cfg.bin_starts == case.cl_cfg.bin_starts
    assert pb.cl_cfg.lmax == case.cl_cfg.lmax
    flat = [t for th in case.meta["thetas0"] for t in th]
    assert np.allclose(pb.thetas0.numpy(), flat, rtol=1e-15, atol=0)
    assert np.abs(pb.ms.groups[0].data.numpy()).max() > 0


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def operator_case(step_case):
    """The step problem's system with a prior cl0, a random u and r, both
    sides, the JAX side jitted once."""
    case = step_case
    ms_j = case.ms
    C, S, nl = ms_j.cl.shape
    rng = np.random.default_rng(3)
    u = (rng.standard_normal((C, S, nl, nl))
         + 1j * rng.standard_normal((C, S, nl, nl))) * np.tril(
        np.ones((nl, nl)))
    u[..., 0] = u[..., 0].real
    r = (rng.standard_normal((C, S, nl, nl))
         + 1j * rng.standard_normal((C, S, nl, nl))) * np.tril(
        np.ones((nl, nl)))
    key = jax.random.PRNGKey(11)

    @jax.jit
    def ref(ms, plans, u, r):
        a, res = jmr.sample_amplitudes_multi(ms, plans, key=None, tol=1e-12,
                                             maxiter=300)
        return (jmr.apply_A_multi(ms, plans, u),
                jmr.compute_rhs_multi(ms, plans, key),
                jmr.build_preconditioner_multi(ms, plans)(r), a)

    out = [np.asarray(x) for x in ref(ms_j, tuple(case.plans),
                                      jnp.asarray(u), jnp.asarray(r))]
    ms_t = convert.multi_system(_ms_dict(ms_j), device="cpu")
    return SimpleNamespace(ms_t=ms_t, plans_t=case.pb.plans, u=u, r=r,
                           key=key, ref=out, G=len(ms_j.groups), ms_j=ms_j)


def test_multires_operator_rhs_precond_match(operator_case):
    """apply_A_multi, compute_rhs_multi (with the JAX key's eta1 per group
    and eta2) and build_preconditioner_multi's application to 1e-10."""
    oc = operator_case
    A_ref, rhs_ref, M_ref, _ = oc.ref
    got = tmr.apply_A_multi(oc.ms_t, oc.plans_t, torch.as_tensor(oc.u))
    assert _rel(got.numpy(), A_ref) <= 1e-10
    keys = jax.random.split(oc.key, oc.G + 1)
    C, S, nl = oc.ms_j.cl.shape
    eta1 = [torch.as_tensor(np.array(jax.random.normal(
        keys[g], oc.ms_j.groups[g].data.shape, jnp.float64)))
        for g in range(oc.G)]
    eta2 = torch.as_tensor(np.array(j_random_alm_white(
        keys[-1], (C, S, nl, nl), jnp.float64)))
    rhs = tmr.compute_rhs_multi(oc.ms_t, oc.plans_t, eta1=eta1, eta2=eta2)
    assert _rel(rhs.numpy(), rhs_ref) <= 1e-10
    M = tmr.build_preconditioner_multi(oc.ms_t, oc.plans_t)
    assert _rel(M(torch.as_tensor(oc.r)).numpy(), M_ref) <= 1e-10


def test_multires_wiener_solve_and_symmetry(operator_case):
    """The Wiener solve (no draws) to 1e-8 of the JAX one; the operator is
    self-adjoint under the alm metric to 1e-10, over two groups whose
    plans differ."""
    oc = operator_case
    a, res = tmr.sample_amplitudes_multi(oc.ms_t, oc.plans_t, tol=1e-12,
                                         maxiter=300)
    assert res.converged
    assert _rel(a.numpy(), oc.ref[3]) <= 1e-8
    assert len({(p.nside, p.lmax) for p in oc.plans_t}) == 2
    u = torch.as_tensor(oc.u)
    v = torch.as_tensor(oc.r)
    v[..., 0] = v[..., 0].real
    lhs = float(alm_dot(v, tmr.apply_A_multi(oc.ms_t, oc.plans_t, u)))
    rhs = float(alm_dot(tmr.apply_A_multi(oc.ms_t, oc.plans_t, v), u))
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


# ---------------------------------------------------------------------------
# the gain functions
# ---------------------------------------------------------------------------

def test_gain_functions_match():
    """sample_gain, cross_sigma_ell, estimate_gain_cross_cl (through each
    package's map2alm), sample_gain_gls (draw, optimize, prior, clamp), with
    the JAX keys' normal draws, to 1e-12."""
    rng = np.random.default_rng(5)
    nside, lmax = 8, 16
    P = 12 * nside * nside
    d = rng.standard_normal((3, 3, P)) * 5.0 + 2.0
    s = rng.standard_normal((3, 3, P)) * 4.0
    w = rng.uniform(0.5, 2.0, (3, 3, P))
    T = lambda x: torch.as_tensor(x)
    key = jax.random.PRNGKey(2)
    eps = np.array(jax.random.normal(key, (3,), jnp.float64))
    ref = jgain.sample_gain(key, d, s, w, prior_mean=1.0, prior_std=0.5)
    got = tgain.sample_gain(T(d), T(s), T(w), 1.0, 0.5, eps=T(eps))
    assert _rel(got.numpy(), ref) <= 1e-12
    a1 = rng.standard_normal((3, 17, 17)) + 1j * rng.standard_normal(
        (3, 17, 17))
    a2 = rng.standard_normal((3, 17, 17)) + 1j * rng.standard_normal(
        (3, 17, 17))
    assert _rel(tgain.cross_sigma_ell(T(a1), T(a2), 16).numpy(),
                jgain.cross_sigma_ell(a1, a2, 16)) <= 1e-12
    plan_j = jsht.get_plan(nside, lmax, spin2=True)
    plan_t = tsht.get_plan(nside, lmax, spin2=True, dtype=torch.float64,
                           device="cpu")
    sig, res = s[0], 1.3 * s[0] + d[1]
    mask = (rng.random((3, P)) > 0.2).astype(float)
    cross = jax.jit(jgain.estimate_gain_cross_cl, static_argnums=(3, 4))
    for m in (None, mask):
        ref = cross(plan_j, jnp.asarray(sig), jnp.asarray(res), 2, 12,
                    None if m is None else jnp.asarray(m))
        got = tgain.estimate_gain_cross_cl(plan_t, T(sig), T(res), 2, 12,
                                           None if m is None else T(m))
        assert abs(float(got) - float(ref)) <= 1e-12 * abs(float(ref))
    k2 = jax.random.PRNGKey(9)
    e2 = float(jax.random.normal(k2, (), jnp.float64))
    for kw in (dict(), dict(optimize=True), dict(prior_mean=1.1,
                                                 prior_rms=0.002),
               dict(mask=mask), dict(max_delta_g=1.0)):
        kw_j = dict(kw, mask=None if "mask" not in kw
                    else jnp.asarray(kw["mask"]))
        kw_t = dict(kw, mask=None if "mask" not in kw else T(kw["mask"]))
        ref = jgain.sample_gain_gls(k2, res, sig, w[0], 1.0, **kw_j)
        got = tgain.sample_gain_gls(T(res), T(sig), T(w[0]), 1.0,
                                    eps=torch.tensor(e2, dtype=torch.float64),
                                    **kw_t)
        assert abs(float(got) - float(ref)) <= 1e-12


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _jax_indices_port_form(case, a):
    """The index phase of the port's form composed from the JAX package's
    functions: per slot F at the current theta, the residual without the
    slot's component, the component through each band's b_l, the group
    lnL sums without the prior, the prior once; then the gains at the new
    F. Returns (theta (nslot,), gains (B,))."""
    ms, plans, meta = case.ms, case.plans, case.meta
    S = ms.cl.shape[1]
    bps = meta["bps"]
    thetas = [list(t) for t in meta["thetas0"]]
    _, _, key = jax.random.split(case.key, 3)
    bs = meta["band_slot"]
    idxs = [[i for i in range(len(bps)) if bs[i][0] == g]
            for g in range(len(plans))]

    def groups_at(thetas):
        F = np.asarray(j_mixing_matrix(case.diffuse, bps,
                                       thetas=[tuple(t) for t in thetas]))
        return [dataclasses.replace(sys_g, F=jnp.asarray(
            F[idxs[g]])[..., None].repeat(S, axis=-1))
            for g, sys_g in enumerate(ms.groups)]

    flat = []
    for slot in case.pb.slots:
        ci, which = slot.ci, slot.which
        c = slot.cfg
        sic = jsi.SpecIndConfig(grid_min=c.grid_min, grid_max=c.grid_max,
                                ngrid=c.ngrid)
        grid = sic.grid(jnp.float64)
        lnl = jsi._lnprior(dataclasses.replace(
            sic, prior_mean=c.prior_mean, prior_std=c.prior_std), grid)
        for g, sys_g in enumerate(groups_at(thetas)):
            nl_g = plans[g].lmax + 1
            a_g = a[..., :nl_g, :nl_g]
            others = a_g.at[ci].set(0.0)
            res = sys_g.data - jamp._synth(plans[g], jamp._project_bands(
                sys_g, plans[g], others))
            amp_band = jamp._synth(plans[g],
                                   a_g[ci][None] * sys_g.bl[..., None])
            lnl = lnl + jsi._grid_lnL_total(
                case.diffuse[ci], [bps[i] for i in idxs[g]], sic, res,
                amp_band[0], sys_g.inv_rms2, tuple(thetas[ci]), which,
                amp_band=amp_band)
        key, ik = jax.random.split(key)
        thetas[ci][which] = float(jsi._cdf_invert(ik, lnl, grid))
        flat.append(thetas[ci][which])
    gains = np.ones(len(bps))
    for g, sys_g in enumerate(groups_at(thetas)):
        nl_g = plans[g].lmax + 1
        sky = jamp._synth(plans[g], jamp._project_bands(
            sys_g, plans[g], a[..., :nl_g, :nl_g]))
        for j, i in enumerate(idxs[g]):
            key, gk = jax.random.split(key)
            gains[i] = float(jgain.sample_gain_gls(
                gk, sys_g.data[j], sky[j] / max(gains[i], 1e-12),
                sys_g.inv_rms2[j], gains[i], prior_mean=1.0,
                prior_rms=0.0))
    return np.array(flat), gains


def test_multires_step_matches_port_form(step_case):
    """One multires_gibbs_step (2 groups, 3 components, 2 free parameters,
    gains on) with run_multires' own draws: the amplitudes against
    run_multires' (the amplitude step has no form), theta and the gains
    against the JAX composition of the port's form, all to 1e-8."""
    case = step_case
    draws, _ = _draws(case)
    st = mg.multires_gibbs_step(case.pb, mg.init_state(case.pb),
                                draws=draws)
    assert st.it == 1 and st.cg_relres <= 1e-12
    assert _rel(st.a.numpy(), case.chain_a) <= 1e-8
    th_ref, g_ref = _jax_indices_port_form(case, jnp.asarray(case.chain_a))
    assert np.abs(st.thetas.numpy() - th_ref).max() \
        <= 1e-8 * np.abs(th_ref).max()
    assert np.abs(st.gains.numpy() - g_ref).max() <= 1e-8
    # F of every group at the new theta
    F_ref = np.asarray(j_mixing_matrix(case.diffuse, case.meta["bps"],
                                       thetas=[(), (th_ref[0],),
                                               (th_ref[1],)]))
    assert _rel(st.ms.groups[1].F[..., 0].numpy(), F_ref[[2]]) <= 1e-8


def test_multires_step_reference_form_matches_run_multires(step_case,
                                                           monkeypatch):
    """With run_multires' own index lnL patched in (facts a, b, d): the
    index draws given run_multires' amplitudes, and then the gains, equal
    its chain file's to 1e-10; the whole step's to 1e-8."""
    case = step_case
    monkeypatch.setattr(mg, "_REFERENCE_FORM", True)
    draws, _ = _draws(case)
    a = torch.as_tensor(case.chain_a)
    th, ms = mg.multires_indices(case.pb, case.pb.ms, a, case.pb.thetas0,
                                 u=draws["u"])
    assert np.abs(th.numpy() - case.chain_theta).max() \
        <= 1e-10 * np.abs(case.chain_theta).max()
    gains = mg.multires_gains(case.pb, ms, a,
                              torch.ones(3, dtype=torch.float64), 1,
                              eps=draws["eps_gain"])
    assert np.abs(gains.numpy() - case.chain_gains).max() <= 1e-10
    st = mg.multires_gibbs_step(case.pb, mg.init_state(case.pb),
                                draws=draws)
    assert np.abs(st.thetas.numpy() - case.chain_theta).max() \
        <= 1e-8 * np.abs(case.chain_theta).max()
    assert np.abs(st.gains.numpy() - case.chain_gains).max() <= 1e-8


def test_reference_form_counts_the_prior_per_pixel(step_case, monkeypatch):
    """Fact (a): with zero amplitudes the lnL is the prior alone; its
    curvature on the grid is P_total / sigma^2 under the reference form
    (the prior in every pixel's row of every group) and 1 / sigma^2 under
    the port's."""
    pb = step_case.pb
    C, S, nl = pb.ms.cl.shape
    a = torch.zeros((C, S, nl, nl), dtype=torch.complex128)
    P_total = sum(g.data.shape[-1] for g in pb.ms.groups)
    for slot in pb.slots:
        grid = slot.cfg.grid(torch.float64, "cpu").numpy()
        dx = grid[1] - grid[0]
        curv = {}
        for ref in (False, True):
            monkeypatch.setattr(mg, "_REFERENCE_FORM", ref)
            lnl = mg.index_lnl(pb, pb.ms, a, pb.thetas0, slot).numpy()
            curv[ref] = -np.mean(lnl[2:] - 2 * lnl[1:-1] + lnl[:-2]) / dx**2
        sig2 = slot.cfg.prior_std ** 2
        assert abs(curv[False] * sig2 - 1.0) <= 1e-6
        assert abs(curv[True] * sig2 / P_total - 1.0) <= 1e-6


def test_reference_form_beams_along_m(step_case):
    """Fact (b): run_multires' a_g[ci] * bl[0, :1] on square (S, nl, nm)
    alms is a_lm b_m of band 0 (the same in the JAX package and in the
    port's reference form), not a_lm b_l: the amplitude map is a
    synthesis of a_lm b_m."""
    case = step_case
    sys_j, plan_t = case.ms.groups[0], case.pb.plans[0]
    nl = plan_t.lmax + 1
    a = case.chain_a[1, :, :nl, :nl]
    bl0 = np.asarray(sys_j.bl)[0, 0]
    along_m = a * bl0[None, None, :]
    along_l = a * bl0[None, :, None]
    got_j = np.asarray(jnp.asarray(a) * sys_j.bl[0, :1])
    assert np.array_equal(got_j, along_m)
    sys_t = case.pb.ms.groups[0]
    got_t = (torch.as_tensor(a) * sys_t.bl[0, :1]).numpy()
    assert _rel(got_t, along_m) <= 1e-15
    synth = lambda x: tsht.alm2map_teb(plan_t, torch.as_tensor(x)).numpy()
    m_ref = synth(got_t)
    assert _rel(m_ref, synth(along_m)) <= 1e-12
    assert _rel(m_ref, synth(along_l)) > 1e-3


def test_multires_presets_and_chain(step_case, tmp_path):
    """entry_multires and tutorial_multires build at a small size on the
    CPU (groups, bands, five components, five slots, gains on the entry
    preset only) and take a step from init_state; run_multires runs its
    TOD branch (band 070 differential; held against run_multires in
    tests/test_torch_multires_tod.py)."""
    for name, gains in (("entry_multires", True),
                        ("tutorial_multires", False)):
        pb = entry.build_preset(name, torch.float64, "cpu", nsides=(4, 4, 8),
                                lmaxs=(8, 8, 16))
        assert pb.groups == [(4, 8), (8, 16)]
        assert [d.name for d in pb.diffuse] == ["cmb", "synch", "dust",
                                                "ff", "ame"]
        assert len(pb.slots) == 5
        assert all(b.sample_gain == gains for b in pb.cfg.bands)
    gen = torch.Generator().manual_seed(0)
    st = mg.multires_gibbs_step(pb, mg.init_state(pb), gen)
    assert st.it == 1
    assert torch.isfinite(torch.view_as_real(st.a)).all()
    assert torch.equal(st.gains, torch.ones(3, dtype=torch.float64))
    assert all(s.cfg.grid_min <= t <= s.cfg.grid_max
               for s, t in zip(pb.slots, st.thetas.tolist()))
    cfg = dataclasses.replace(pb.cfg, enable_tod=True, cg_maxiter=20,
                              bands=list(pb.cfg.bands))
    cfg.bands[2] = dataclasses.replace(cfg.bands[2], tod_type="WMAP")
    st, path, _ = trun.run_multires(cfg, niter=1, synthetic=True, tod=True,
                                    device="cpu", outdir=str(tmp_path),
                                    verbose=False)
    assert st.it == 1 and os.path.exists(path)
    assert [st.bands[i].kind for i in sorted(st.bands)] == ["lfi", "lfi",
                                                            "diff"]
    assert torch.isfinite(torch.view_as_real(st.a)).all()


def test_multires_fits_missing_file_raises(tmp_path):
    """build_multi_problem(synthetic=False) raises FileNotFoundError with
    the resolved path of a band's missing map, as build_multi_model does
    (run.py:2655-2658); none and fullsky are skipped."""
    cfg = _cfg(("cmb",), (4, 4, 8))
    tcfg = convert.run_config(dataclasses.asdict(cfg))
    for b in tcfg.bands:
        b.mapfile, b.noisefile, b.maskfile = "none", "none", "fullsky"
    tcfg.bands[1].mapfile = "absent.fits"
    with pytest.raises(FileNotFoundError,
                       match=str(tmp_path / "absent.fits")):
        entry.build_multi_problem(tcfg, device="cpu", pol=True,
                                  data_dir=str(tmp_path), synthetic=False)


def _replay(case):
    """draws(it) of run.run_multires: run_multires' own, iteration by
    iteration along its key chain."""
    made, key = {}, case.key

    def draws(it):
        nonlocal key
        while it not in made:
            made[len(made) + 1], key = _draws(case, key)
        return made[it]
    return draws


def _chain_mr(path, reader):
    with reader(path, "r") as ch:
        return [ch.read_sample(i) for i in range(1, ch.last_sample() + 1)]


def test_run_multires_chain_matches_run_multires(step_case, tmp_path,
                                                 monkeypatch):
    """run.run_multires (its loop, chain file and status file) with
    run_multires' draws and its index lnL patched in: both samples of the
    chain (alms 1e-8 of their max, the flat index vector 1e-8 of its scale,
    the gains 1e-8, CG iterations equal) against run_multires' own; each
    package's ChainFile reads the port's file the same."""
    from commander_tpu.io.chain import ChainFile as JChainFile
    from commander_tpu_torch.io.chain import ChainFile

    case = step_case
    monkeypatch.setattr(mg, "_REFERENCE_FORM", True)
    tcfg = convert.run_config(dataclasses.asdict(case.cfg))
    _, path, _ = trun.run_multires(
        tcfg, niter=2, outdir=str(tmp_path), synthetic=True, verbose=False,
        pol=True, device="cpu", draws=_replay(case), a_true=case.a_true)
    assert os.path.basename(path) == "chain_mr_c0001.h5"
    assert "done" in (tmp_path / "comm_status.txt").read_text()
    got = _chain_mr(path, ChainFile)
    ref = _chain_mr(case.chain_path, ChainFile)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert sorted(g["comps"]) == sorted(r["comps"])
        for name in r["comps"]:
            assert _rel(g["comps"][name]["alm"],
                        r["comps"][name]["alm"]) <= 1e-8
        th_g, th_r = np.asarray(g["aux"]["specind"]), \
            np.asarray(r["aux"]["specind"])
        assert th_g.shape == th_r.shape
        assert np.abs(th_g - th_r).max() <= 1e-8 * np.abs(th_r).max()
        assert np.abs(g["gain"] - r["gain"]).max() <= 1e-8
        assert int(g["aux"]["cg_iters"]) == int(r["aux"]["cg_iters"])
    for g, j in zip(got, _chain_mr(path, JChainFile)):
        assert np.array_equal(g["comps"]["cmb"]["alm"],
                              j["comps"]["cmb"]["alm"])
        assert np.array_equal(g["gain"], j["gain"])
