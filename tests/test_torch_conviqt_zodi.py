"""The sidelobe convolver (commander_tpu_torch.tod.conviqt), the zodi model
(tod/zodi.py) and the TOD pass with both terms against the JAX package,
float64 on the CPU. Two cases (a file of at most two cases is dealt beside
tests/test_sharding.py, ROADMAP "Tier-1 verify"):

  conviqt   conviqt_tables (1e-12: the same numpy recurrence),
            conviqt_precompute, conviqt_interp, build_sl_fmaps at nside 8 /
            lmax 12 with M = 3 beam modes (1e-10 of the max: float64 both
            sides, the order of sums differs), degrade_table (equal); the
            f-maps against the brute-force Wigner-D rotation sum of
            tests/test_conviqt.py (1e-8 absolute, as there); the per-band
            rebuild (tod_gibbs.band_sl_fmaps, conviqt.sl_fmaps_for_band)
            against run._sl_fmaps_for_band on _project_bands of the same
            amplitudes, with the band alms above and below the sidelobe
            lmax (1e-10);
  tod_pass  every zodi function (the cloud, the three bands, the ring and
            feature, the Planck law, the line-of-sight integral, the TOD
            template in chunks of one scan, the rotation and the unit
            factors) to 1e-10; then with a sidelobe term (f-maps at nside 8
            read at the degraded pixels sl_pix) and a zodi template,
            static_signal and tod_chisq to 1e-10 and one process_tod with
            the JAX key's draws to 1e-8, T and T/Q/U, as
            tests/test_torch_tod.py holds the pass without them.
"""
import dataclasses
import types
from math import factorial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu.sampling import amplitude as jamp
from commander_tpu.sphere import healpix as jhp
from commander_tpu.sphere import sht as jsht
from commander_tpu.tod import conviqt as JC
from commander_tpu.tod import process as JP
from commander_tpu.tod import zodi as JZ
from commander_tpu_torch import convert
from commander_tpu_torch.sampling import tod_gibbs
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.tod import conviqt as TC
from commander_tpu_torch.tod import process as TP
from commander_tpu_torch.tod import zodi as TZ
from test_torch_tod import NSIDE, _rel, _sim, _states, _t, jax_pass_draws

NS_SL, L_SL, M_SL = 8, 12, 3
_J_PRE = jax.jit(JC.conviqt_precompute)
_J_BUILD = jax.jit(JC.build_sl_fmaps)


def _full_alm(rng, lmax, ncol=None):
    nl = lmax + 1
    a = rng.standard_normal((nl, nl)) + 1j * rng.standard_normal((nl, nl))
    a *= np.tril(np.ones((nl, nl)))
    a[:, 0] = a[:, 0].real
    return a if ncol is None else a[:, :ncol].copy()


def _wigner_d_exact(l, m, mp, theta):
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    pref = np.sqrt(float(factorial(l + m) * factorial(l - m)
                         * factorial(l + mp) * factorial(l - mp)))
    tot = 0.0
    for k in range(max(0, mp - m), min(l + mp, l - m) + 1):
        den = float(factorial(l + mp - k) * factorial(k)
                    * factorial(m - mp + k) * factorial(l - m - k))
        tot = tot + (-1.0) ** (m - mp + k) * c ** (2 * l + mp - m - 2 * k) \
            * s ** (m - mp + 2 * k) / den
    return pref * tot


def _neg_m(a, l, m):
    return a[l, m] if m >= 0 else (-1) ** m * np.conj(a[l, -m])


def _sl_inputs(rng, ndet=2):
    """JAX and port sidelobe plans, tables and per-det beams."""
    pj = jsht.get_plan(NS_SL, L_SL)
    tj = JC.conviqt_tables(NS_SL, L_SL, M_SL)
    pt = tsht.get_plan(NS_SL, L_SL, device="cpu")
    tt = TC.conviqt_tables(NS_SL, L_SL, M_SL, device="cpu")
    blms = np.stack([_full_alm(rng, L_SL, M_SL + 1) * 0.05
                     for _ in range(ndet)])
    return pj, tj, pt, tt, blms


def _check_conviqt():
    rng = np.random.default_rng(0)
    pj, tj, pt, tt, blms = _sl_inputs(rng)
    for (jp_, jn), (tp_, tn) in zip(tj, tt):
        for a, b in ((tp_, jp_), (tn, jn)):
            assert _rel(a, np.transpose(np.asarray(b), (2, 0, 1))) <= 1e-12
    alm = _full_alm(rng, L_SL)
    ref = _J_PRE(pj, tj, jnp.asarray(alm), jnp.asarray(blms[0]))
    got = TC.conviqt_precompute(pt, tt, torch.as_tensor(alm),
                                torch.as_tensor(blms[0]))
    assert _rel(got, ref) <= 1e-10
    pix = rng.integers(0, 12 * NS_SL ** 2, (3, 2, 64))
    psi = rng.uniform(0.0, 2 * np.pi, (3, 2, 64))
    assert _rel(TC.conviqt_interp(got, torch.as_tensor(pix),
                                  torch.as_tensor(psi)),
                JC.conviqt_interp(ref, jnp.asarray(pix),
                                  jnp.asarray(psi))) <= 1e-10
    assert _rel(TC.build_sl_fmaps(pt, tt, torch.as_tensor(alm),
                                  torch.as_tensor(blms)),
                _J_BUILD(pj, tj, jnp.asarray(alm),
                         jnp.asarray(blms))) <= 1e-10
    for hi, lo in ((16, 8), (8, 8), (32, 4)):
        np.testing.assert_array_equal(TC.degrade_table(hi, lo),
                                      JC.degrade_table(hi, lo))

    # the brute-force rotation sum (tests/test_conviqt.py) at nside 8 /
    # lmax 6, M = 2
    lmax, M = 6, 2
    a = _full_alm(rng, lmax)
    b = _full_alm(rng, lmax, M + 1)
    fm = TC.conviqt_precompute(tsht.get_plan(8, lmax, device="cpu"),
                               TC.conviqt_tables(8, lmax, M, device="cpu"),
                               torch.as_tensor(a), torch.as_tensor(b))
    theta, phi = jhp.pix2ang_ring(8)
    tpix = np.array([3, 100, 400, 700])
    tpsi = np.array([0.0, 0.7, 2.1, 4.5])
    s = TC.conviqt_interp(fm, torch.as_tensor(tpix),
                          torch.as_tensor(tpsi)).numpy()
    for i, (p, ps) in enumerate(zip(tpix, tpsi)):
        tot = 0.0
        for l in range(lmax + 1):
            for m in range(-l, l + 1):
                for mp in range(-min(l, M), min(l, M) + 1):
                    tot += np.real(_neg_m(a, l, m) * np.conj(_neg_m(b, l, mp))
                                   * _wigner_d_exact(l, m, mp, theta[p])
                                   * np.exp(1j * (m * phi[p] + mp * ps)))
        assert abs(s[i] - tot) < 1e-8, (i, s[i], tot)

    # the per-band rebuild against run._sl_fmaps_for_band on the band alms
    # of the same amplitudes (C = 2 components, S = 3, B = 2 bands), the
    # model's lmax above (20) and below (8) the sidelobe lmax
    aux = dict(sl_blm=jnp.asarray(blms), sl_plan=pj, sl_tables=tj)
    for lmax_m in (20, 8):
        nl = lmax_m + 1
        amp = np.stack([np.stack([_full_alm(rng, lmax_m) for _ in range(3)])
                        for _ in range(2)])
        F = rng.uniform(0.5, 1.5, (2, 2, 3))
        bl = rng.uniform(0.5, 1.0, (2, 3, nl))
        sys_j = types.SimpleNamespace(F=jnp.asarray(F), bl=jnp.asarray(bl))
        alm_b = jamp._project_bands(sys_j, None, jnp.asarray(amp))
        sys_t = types.SimpleNamespace(F=torch.as_tensor(F),
                                      bl=torch.as_tensor(bl))
        band = tod_gibbs.TodBand(None, None, None, {},
                                 sl_blm=torch.as_tensor(blms), sl_plan=pt,
                                 sl_tables=tt)
        got = tod_gibbs.band_sl_fmaps([None, band], sys_t,
                                      torch.as_tensor(amp))
        assert got[0] is None
        ref = jrun._sl_fmaps_for_band(aux, alm_b[1])
        assert _rel(got[1], ref) <= 1e-10
        assert _rel(TC.sl_fmaps_for_band(pt, tt, torch.as_tensor(blms),
                                         torch.as_tensor(np.array(
                                             alm_b[1, 0]))), ref) <= 1e-10


def _check_zodi():
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-3.0, 3.0, (3, 40, 5))
    xj, xt = [jnp.asarray(v) for v in xyz], [torch.as_tensor(v) for v in xyz]
    assert _rel(TZ._cloud_density(TZ.KelsallCloud(), *xt),
                JZ._cloud_density(JZ.KelsallCloud(), *xj)) <= 1e-10
    for bt, bj in zip((TZ.BAND1, TZ.BAND2, TZ.BAND3),
                      (JZ.BAND1, JZ.BAND2, JZ.BAND3)):
        assert _rel(bt.density(*xt), bj.density(*xj)) <= 1e-10
    lon = rng.uniform(0.0, 6.0, (40, 5))
    assert _rel(TZ.KelsallRing().density(*xt, torch.as_tensor(lon)),
                JZ.KelsallRing().density(*xj, jnp.asarray(lon))) <= 1e-10
    T = rng.uniform(50.0, 400.0, 30)
    assert _rel(TZ._planck_MJysr(70e9, torch.as_tensor(T)),
                JZ._planck_MJysr(70e9, jnp.asarray(T))) <= 1e-10
    earth = rng.standard_normal((6, 1, 3)) * 0.1 + np.array([1.0, 0, 0])
    los = rng.standard_normal((6, 7, 3))
    los /= np.linalg.norm(los, axis=-1, keepdims=True)
    for kw_t, kw_j in (({}, {}),
                       (dict(bands=(TZ.BAND1, TZ.BAND2, TZ.BAND3),
                             ring=TZ.KelsallRing(), n_nodes=17),
                        dict(bands=(JZ.BAND1, JZ.BAND2, JZ.BAND3),
                             ring=JZ.KelsallRing(), n_nodes=17))):
        assert _rel(TZ.zodi_template(TZ.KelsallCloud(), 44e9,
                                     torch.as_tensor(earth),
                                     torch.as_tensor(los), **kw_t),
                    JZ.zodi_template(JZ.KelsallCloud(), 44e9,
                                     jnp.asarray(earth), jnp.asarray(los),
                                     **kw_j)) <= 1e-10
    assert _rel(TZ.GAL2ECL, JZ.GAL2ECL) <= 1e-15
    assert _rel(TZ._gal2ecl_matrix(), JZ._gal2ecl_matrix()) <= 1e-15
    for nu in (30e9, 70e9):
        assert TZ.mjysr_to_uk_rj(nu) == JZ.mjysr_to_uk_rj(nu)
        assert TZ.mjysr_to_uk_cmb(nu) == JZ.mjysr_to_uk_cmb(nu)


def _check_tod_pass(pol):
    s = _sim(NSIDE, pol)
    bj, bt = s["bj"], s["bt"]
    rng = np.random.default_rng(7)
    Ns, Nd = bj.tod.shape[:2]
    satpos = np.stack([np.linspace(0.0, 300.0, Ns), np.linspace(-2, 2, Ns)],
                      axis=-1)
    pix = np.asarray(bj.pix)
    # the zodi template of the block, one scan per chunk on the port's side
    z_ref = np.asarray(JZ.zodi_tod_template(NSIDE, jnp.asarray(pix),
                                            jnp.asarray(satpos), 44e9))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TZ, "CHUNK_BYTES", 1)
        z_got = TZ.zodi_tod_template(NSIDE, bt.pix, satpos, 44e9)
    assert _rel(z_got, z_ref) <= 1e-10
    zodi = z_ref * JZ.mjysr_to_uk_cmb(44e9) * 50.0
    pj, tj, pt, tt, blms = _sl_inputs(rng, Nd)
    alm = _full_alm(rng, L_SL) * 3.0
    fm_j = _J_BUILD(pj, tj, jnp.asarray(alm), jnp.asarray(blms))
    fm_t = TC.build_sl_fmaps(pt, tt, torch.as_tensor(alm),
                             torch.as_tensor(blms))
    sl_pix = TC.degrade_table(NSIDE, NS_SL)[pix]
    cfg = JP.TodConfig(nside=NSIDE, nu=44e9, pol=pol, chisq_reject_sigma=3.0)
    cfg_t = convert.tod_config(dataclasses.asdict(cfg))
    st_j, st_t = _states(bj, rng)
    sky = s["sky"] * 1.01
    kw_j = dict(sl_fmaps=fm_j, s_extra=jnp.asarray(zodi),
                sl_pix=jnp.asarray(sl_pix))
    kw_t = dict(sl_fmaps=fm_t, s_extra=torch.as_tensor(zodi),
                sl_pix=torch.as_tensor(sl_pix))
    pv = s["pvec"]
    s_ref = JP.static_signal(cfg, bj, jnp.asarray(pv), **kw_j)
    assert _rel(TP.static_signal(cfg_t, bt, _t(pv), **kw_t), s_ref) <= 1e-10
    # the terms are there and not small beside the dipole
    s_dip = np.asarray(JP.static_signal(cfg, bj, jnp.asarray(pv)))
    assert np.abs(np.asarray(s_ref) - s_dip).max() > 0.1 * np.abs(
        s_dip).max()
    for per_det in (False, True):
        assert _rel(TP.tod_chisq(cfg_t, bt, st_t, _t(sky), _t(pv),
                                 per_det=per_det, **kw_t),
                    JP.tod_chisq(cfg, bj, st_j, jnp.asarray(sky),
                                 jnp.asarray(pv), per_det=per_det,
                                 **kw_j)) <= 1e-10
    key = jax.random.PRNGKey(5)
    new_j, prod_j = jax.jit(JP.process_tod, static_argnums=0)(
        cfg, bj, st_j, jnp.asarray(sky), jnp.asarray(pv), key,
        kw_j["sl_fmaps"], kw_j["s_extra"], None, kw_j["sl_pix"])
    new_t, prod_t = TP.process_tod(
        cfg_t, bt, st_t, _t(sky), _t(pv),
        draws=jax_pass_draws(key, cfg, bj, 12 * NSIDE ** 2), **kw_t)
    for f in dataclasses.fields(new_j):
        assert _rel(getattr(new_t, f.name), getattr(new_j, f.name)) <= 1e-8
    assert set(prod_t) == set(prod_j)
    for k in prod_j:
        assert _rel(prod_t[k], prod_j[k]) <= 1e-8, k


@pytest.mark.parametrize("case", ["conviqt", "tod_pass"])
def test_conviqt_zodi_and_pass_match(case):
    if case == "conviqt":
        _check_conviqt()
    else:
        _check_zodi()
        for pol in (False, True):
            _check_tod_pass(pol)
