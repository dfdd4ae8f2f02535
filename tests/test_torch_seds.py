"""The port's SED library, bandpass model and mixing matrix against the JAX
package: the same frequencies and parameters, made from a numpy seed, through
both, in float64 on the CPU.

Tolerance: 1e-12 relative to the largest reference value, everywhere (the
two sides evaluate the same float64 formulas; they differ in the order of a
few sums and in libm against XLA's exp / log).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.instrument import bandpass as jbp
from commander_tpu.model import mixing as jmix
from commander_tpu.model import seds as jseds
from commander_tpu_torch.instrument import bandpass as tbp
from commander_tpu_torch.model import mixing as tmix
from commander_tpu_torch.model import seds as tseds
from test_torch_jax_refs import jit_call

# small shapes: one torch thread, so that test workers sharing the cores
# do not oversubscribe them
torch.set_num_threads(1)

TOL = 1e-12
NU = np.geomspace(3e9, 900e9, 41)
NU_REF = {"power_law": 30e9, "curved_power_law": 30e9, "MBB": 353e9,
          "freefree": 40e9, "spindust": 22e9, "spindust2": 22e9,
          "physdust": 353e9, "line": NU[17]}
# (low, high) of each parameter's test values
RANGES = {"power_law": [(-3.5, -2.5)],
          "curved_power_law": [(-3.5, -2.5), (-0.2, 0.2)],
          "MBB": [(1.2, 2.0), (14.0, 30.0)],
          "freefree": [(4000.0, 12000.0)],
          "spindust": [(15e9, 40e9)],
          "spindust2": [(15e9, 40e9), (-1.0, 1.0)],
          "physdust": [(-0.6, 0.6)],
          "line": []}


def _close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def _params(sed, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [lo + (hi - lo) * rng.random(shape) for lo, hi in RANGES[sed]]


def test_registries_match():
    assert set(tseds.SED_REGISTRY) == set(jseds.SED_REGISTRY)
    assert tseds.SED_NPAR == jseds.SED_NPAR


def test_thermo_to_rj_and_cmb():
    _close(tseds.thermo_to_rj(torch.as_tensor(NU)), jseds.thermo_to_rj(NU))
    _close(tseds.sed_cmb(NU), jseds.sed_cmb(NU))
    _close(tseds.thermo_to_rj(70e9), jseds.thermo_to_rj(70e9))


@pytest.mark.parametrize("sed", sorted(RANGES))
def test_sed_scalar_parameters(sed):
    """Plain floats and 0-d tensors give the JAX values."""
    pars = [float(p) for p in _params(sed, ())]
    ref = jit_call(jseds.SED_REGISTRY[sed], jnp.asarray(NU), NU_REF[sed],
                   *pars)
    _close(tseds.SED_REGISTRY[sed](torch.as_tensor(NU), NU_REF[sed], *pars),
           ref)
    _close(tseds.SED_REGISTRY[sed](
        torch.as_tensor(NU), NU_REF[sed],
        *[torch.tensor(p, dtype=torch.float64) for p in pars]), ref)
    # a plain float frequency too
    _close(tseds.SED_REGISTRY[sed](NU[17], NU_REF[sed], *pars), ref[17])


@pytest.mark.parametrize("sed", sorted(s for s in RANGES if RANGES[s]))
def test_sed_map_parameters(sed):
    """(P,) maps broadcast against the node axis as (P, 1) columns."""
    pars = _params(sed, (23, 1), seed=1)
    ref = jit_call(jseds.SED_REGISTRY[sed], jnp.asarray(NU), NU_REF[sed],
                   *[jnp.asarray(p) for p in pars])
    got = tseds.SED_REGISTRY[sed](torch.as_tensor(NU), NU_REF[sed],
                                  *[torch.as_tensor(p) for p in pars])
    assert got.shape == (23, NU.size)
    _close(got, ref)


def test_spindust_loaded_template(tmp_path):
    """A two-column emissivity file installed on both sides."""
    nu_ghz = np.geomspace(0.5, 500.0, 80)
    j = np.exp(-0.5 * (np.log(nu_ghz / 25.0) / 0.5) ** 2) * nu_ghz ** 0.3
    path = tmp_path / "spdust.dat"
    np.savetxt(path, np.c_[nu_ghz, j], header="nu j")
    old_j = (jseds._SPD_LOGNU, jseds._SPD_LOGJ, jseds._SPD_PEAK)
    old_t = (tseds._SPD_LOGNU, tseds._SPD_LOGJ, tseds._SPD_PEAK)
    try:
        jseds.load_spindust_template(path)
        tseds.load_spindust_template(path)
        assert tseds._SPD_PEAK == jseds._SPD_PEAK
        nu = np.geomspace(10e9, 100e9, 17)
        _close(tseds.sed_spindust(torch.as_tensor(nu), 22e9, 30e9),
               jseds.sed_spindust(jnp.asarray(nu), 22e9, 30e9))
    finally:
        jseds._SPD_LOGNU, jseds._SPD_LOGJ, jseds._SPD_PEAK = old_j
        tseds._SPD_LOGNU, tseds._SPD_LOGJ, tseds._SPD_PEAK = old_t
        tseds._ON_DEVICE.clear()
    # the built-in table is back
    _close(tseds.sed_spindust(torch.as_tensor(NU), 22e9, 30e9),
           jseds.sed_spindust(jnp.asarray(NU), 22e9, 30e9))


@pytest.mark.parametrize("alpha", [2.0, 1.0])
def test_physdust_radiation_field_integral(alpha):
    """gamma != 0: the U-distribution integral, both alpha branches."""
    wav, logU, log_e, amps = jseds._default_physdust_table()
    kw = dict(log_umax=0.5, gamma=0.3, alpha=alpha)
    try:
        jseds.set_physdust_model(np.exp(wav), logU, log_e, amps, **kw)
        tseds.set_physdust_model(np.exp(wav), logU, log_e, amps, **kw)
        # a jit of its own function object: the model's tables are traced
        # in as constants, and jax keys its traces by the function
        _close(tseds.sed_physdust(torch.as_tensor(NU), 353e9, -0.2),
               jax.jit(lambda nu: jseds.sed_physdust(nu, 353e9, -0.2))(
                   jnp.asarray(NU)), 1e-11)
    finally:
        jseds.set_physdust_model(np.exp(wav), logU, log_e, amps)
        tseds.set_physdust_model(np.exp(wav), logU, log_e, amps)


# --- bandpass ---------------------------------------------------------------

def _profile(n=33, nu0=143e9, seed=2):
    rng = np.random.default_rng(seed)
    nu = np.linspace(0.8 * nu0, 1.25 * nu0, n)
    tau = np.exp(-0.5 * ((nu - nu0) / (0.08 * nu0)) ** 2) \
        * (1.0 + 0.1 * rng.random(n))
    return nu, tau


def _pair(kind, unit, profile_type="tophat"):
    if kind == "delta":
        return jbp.delta_bandpass(70e9, unit), tbp.delta_bandpass(70e9, unit)
    if kind == "tophat":
        return (jbp.tophat_bandpass(44e9, 0.2, 17, unit),
                tbp.tophat_bandpass(44e9, 0.2, 17, unit))
    nu, tau = _profile()
    return (jbp.Bandpass(nu, tau, unit, profile_type),
            tbp.Bandpass(nu, tau, unit, profile_type))


BANDS = [("delta", "uK_cmb", "delta"), ("delta", "uK_RJ", "delta"),
         ("tophat", "uK_cmb", "tophat"), ("tophat", "mK_cmb", "tophat"),
         ("tophat", "K_cmb", "tophat"), ("tophat", "uK_RJ", "tophat"),
         ("tophat", "MJy/sr", "tophat")] \
    + [("profile", unit, p) for p in ("LFI", "WMAP", "dame", "HFI_cmb",
                                      "PSM_LFI", "HFI_submm", "DIRBE")
       for unit in ("uK_cmb", "MJy/sr")]


# every band with a frequency shift; no shift and the tilt on one band of
# each normalization (delta, RJ-defined, intensity-defined) and each unit
SHIFTS = [b + ("additive_shift", 0.4e9) for b in BANDS] \
    + [b + sh for b in BANDS[:1] + BANDS[2:8] + BANDS[13:15]
       for sh in (("additive_shift", 0.0), ("powlaw_tilt", 0.3))]


@pytest.mark.parametrize("kind,unit,profile_type,shift_model,delta", SHIFTS)
def test_bandpass_weights(kind, unit, profile_type, shift_model, delta):
    bj, bt = _pair(kind, unit, profile_type)
    nu_j, w_j = bj.weights(delta, shift_model)
    for d in (delta, torch.tensor(delta, dtype=torch.float64)):
        nu_t, w_t = bt.weights(d, shift_model, device="cpu")
        assert nu_t.dtype == w_t.dtype == torch.float64
        _close(nu_t, nu_j)
        _close(w_t, w_j)
    assert bt.nu_c == bj.nu_c


def test_bandpass_unknown_unit_raises():
    with pytest.raises(ValueError, match="unit"):
        tbp.delta_bandpass(70e9, "Jy").weights(device="cpu")


def test_bandpass_helpers():
    nu = torch.as_tensor(NU)
    _close(tbp.a2t(nu), jbp.a2t(NU))
    _close(tbp.rj_to_MJysr(nu), jbp.rj_to_MJysr(NU))
    _close(tbp.sz_thermo(nu), jbp.sz_thermo(NU))
    assert tbp.PROFILE_THRESHOLD == jbp.PROFILE_THRESHOLD
    pnu, ptau = _profile(65)
    ptau[:5] *= 1e-9
    for ptype in ("LFI", "HFI_cmb", "HFI_submm"):
        for got, ref in zip(tbp.trim_profile(pnu, ptau, ptype),
                            jbp.trim_profile(pnu, ptau, ptype)):
            np.testing.assert_array_equal(got, ref)
    for unit in ("uK_cmb", "uK_RJ", "MJy/sr"):
        bj, bt = _pair("profile", unit, "HFI_cmb")
        assert abs(tbp.band_unit_conversions(bt)
                   - jbp.band_unit_conversions(bj)) \
            <= TOL * abs(jbp.band_unit_conversions(bj))
        assert abs(tbp.band_sz_conversion(bt, device="cpu")
                   - jbp.band_sz_conversion(bj)) \
            <= TOL * abs(jbp.band_sz_conversion(bj))
        vals = np.random.default_rng(3).random((5, pnu.size // 2 + 1))
        _close(bt.integrate(torch.as_tensor(vals), 0.2e9),
               bj.integrate(jnp.asarray(vals), 0.2e9))


# --- mixing -----------------------------------------------------------------

def _model(mod, bp_mod):
    comps = [
        mod.DiffuseComponent(name="cmb", sed="cmb", nu_ref=100e9,
                             unit="uK_cmb"),
        mod.DiffuseComponent(name="synch", sed="power_law", nu_ref=30e9,
                             theta0=(-3.1,), polarized=True),
        mod.DiffuseComponent(name="dust", sed="MBB", nu_ref=353e9,
                             theta0=(1.6, 19.6), unit="uK_cmb"),
        mod.DiffuseComponent(name="ff", sed="freefree", nu_ref=40e9,
                             theta0=(7000.0,)),
        mod.DiffuseComponent(name="ame", sed="spindust2", nu_ref=22e9,
                             theta0=(21e9, 0.1)),
        mod.DiffuseComponent(name="co", sed="line", nu_ref=115e9,
                             theta0=(0.0, 1.0, 0.4)),
    ]
    nu, tau = _profile()
    bps = [bp_mod.delta_bandpass(30e9), bp_mod.tophat_bandpass(100e9, 0.25),
           bp_mod.Bandpass(nu, tau, "uK_cmb", "HFI_cmb"),
           bp_mod.Bandpass(nu * 2.4, tau, "MJy/sr", "HFI_submm")]
    return comps, bps


THETAS = [(), (-2.9,), (1.5, 21.0), (8000.0,), (24e9, -0.2),
          (0.0, 0.9, 0.5)]
DELTAS = [0.0, 0.5e9, -0.3e9, 1.0e9]


def test_component_fields():
    cj, _ = _model(jmix, jbp)
    ct, _ = _model(tmix, tbp)
    for a, b in zip(cj, ct):
        assert (a.name, a.sed, a.nu_ref, a.polarized, a.theta0, a.unit,
                a.npar) == (b.name, b.sed, b.nu_ref, b.polarized, b.theta0,
                            b.unit, b.npar)


@pytest.mark.parametrize("case", ["defaults", "thetas", "deltas", "both",
                                  "tensors"])
def test_mixing_matrix(case):
    cj, bj = _model(jmix, jbp)
    ct, bt = _model(tmix, tbp)
    th = THETAS if case in ("thetas", "both", "tensors") else None
    de = DELTAS if case in ("deltas", "both", "tensors") else None
    ref = jmix.mixing_matrix(cj, bj, thetas=th, deltas=de)
    if case == "tensors":
        th = [tuple(torch.tensor(x, dtype=torch.float64) for x in t)
              for t in THETAS]
        de = torch.as_tensor(DELTAS)
    # tensors fix the device; plain values need it by name
    got = tmix.mixing_matrix(ct, bt, thetas=th, deltas=de,
                             device=None if case == "tensors" else "cpu")
    assert got.shape == (4, 6) and got.dtype == torch.float64
    _close(got, ref)


def test_mixing_element_maps_and_line():
    cj, bj = _model(jmix, jbp)
    ct, bt = _model(tmix, tbp)
    rng = np.random.default_rng(4)
    beta, T = 1.2 + 0.8 * rng.random(19), 15.0 + 10.0 * rng.random(19)
    for b in (0, 2, 3):
        ref = jmix.mixing_element(cj[2], bj[b], (jnp.asarray(beta),
                                                 jnp.asarray(T)), 0.2e9)
        got = tmix.mixing_element(ct[2], bt[b], (torch.as_tensor(beta),
                                                 torch.as_tensor(T)), 0.2e9)
        _close(got, ref)
        # a map beside a scalar
        _close(tmix.mixing_element(ct[2], bt[b],
                                   (torch.as_tensor(beta), 19.6)),
               jmix.mixing_element(cj[2], bj[b], (jnp.asarray(beta), 19.6)))
    for b in range(4):
        _close(tmix.mixing_element(ct[5], bt[b], band_index=b, device="cpu"),
               jmix.mixing_element(cj[5], bj[b], band_index=b))
    with pytest.raises(ValueError, match="band_index"):
        tmix.mixing_element(ct[5], bt[0], device="cpu")
    with pytest.raises(ValueError, match="unit"):
        tmix.mixing_element(tmix.DiffuseComponent("x", "power_law", 30e9,
                                                  theta0=(-3.0,), unit="Jy"),
                            bt[0], device="cpu")
