"""The table SHT path (commander_tpu_torch.sphere.sht.get_plan(tables=True))
against the JAX package's table plans, float64 on the CPU.

Two cases, each a group of resolutions (a file of at most two cases is
dealt beside tests/test_sharding.py, ROADMAP "Tier-1 verify"):
  small    nside 1 / lmax 2 (the whole-sphere Bluestein ring stage, no cap
           rings) and nside 8 / lmax 16;
  nside16  nside 16 / lmax 32; and the host tables: wigner_d_table_fast
           against the JAX package's wigner_d_table, spin_lambda_north
           (s = 0 and 2) and healpix.area_weights against the JAX
           package's, and the port's memory check on tables=True (the
           JAX package's 2 GiB TPU-runtime guard, tests/test_sht.py's
           test_table_size_guard, is not carried over: the port raises where
           the tables exceed the device's free memory, stating the bytes).
Per resolution, every public transform of a spin-2 table plan (spin 0,
spin 2, T/E/B; synthesis, adjoint, map2alm, map2alm_iter, smooth_map,
map_smooth_weighted) against the JAX table plan's, jitted once, to 1e-10 of
the max: both sides are float64 and differ only in the order of sums (the
products over l, the FFT libraries). The same transforms of the port's
tableless plan against its table plan, to 1e-10 (the recurrence and the
tables agree to ~1e-14 here); the table plan's adjointness under the alm
metric to 1e-12; flop_count equal to the JAX package's. The host tables to
1e-12 (the same numpy code on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.sphere import healpix as jhp
from commander_tpu.sphere import sht as jsht
from commander_tpu.sphere import wigner as jwig
from commander_tpu_torch.sphere import healpix as thp
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.sphere import wigner as twig
from commander_tpu_torch.sphere.alm import alm_dot

TOL = 1e-10
# (nside, lmax) per case
CASES = {"small": ((1, 2), (8, 16)), "nside16": ((16, 32),)}

# the JAX transforms, jitted once (the plan is a pytree argument)
_J = {name: jax.jit(getattr(jsht, name)) for name in (
    "alm2map", "alm2map_adjoint", "map2alm", "alm2map_spin2",
    "alm2map_spin2_adjoint", "map2alm_spin2", "alm2map_teb",
    "alm2map_teb_adjoint", "map2alm_teb", "map_smooth_weighted")}
_J["map2alm_iter"] = jax.jit(jsht.map2alm_iter, static_argnums=2)
_J["smooth_map"] = jax.jit(jsht.smooth_map, static_argnums=(2, 3))


def _alm(rng, lmax, lead):
    nl = lmax + 1
    a = rng.standard_normal(lead + (nl, nl)) \
        + 1j * rng.standard_normal(lead + (nl, nl))
    a *= np.tril(np.ones((nl, nl)))
    a[..., 0] = a[..., 0].real
    return a


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _calls(nside, lmax, rng):
    """(name, args) of every public transform on seeded inputs."""
    npix = 12 * nside * nside
    a = _alm(rng, lmax, (2,))
    teb = _alm(rng, lmax, (2, 3))
    m = rng.standard_normal((2, npix))
    m3 = rng.standard_normal((2, 3, npix))
    return [("alm2map", (a,)), ("alm2map_adjoint", (m,)), ("map2alm", (m,)),
            ("map2alm_iter", (m, 2)), ("smooth_map", (m, 300.0, 1)),
            ("map_smooth_weighted", (m,)),
            ("alm2map_spin2", (a[0], a[1])),
            ("alm2map_spin2_adjoint", (m[0], m[1])),
            ("map2alm_spin2", (m[0], m[1])), ("alm2map_teb", (teb,)),
            ("alm2map_teb_adjoint", (m3,)), ("map2alm_teb", (m3,))]


def _as_list(x):
    return list(x) if isinstance(x, tuple) else [x]


def _check_resolution(nside, lmax):
    pj = jsht.get_plan(nside, lmax, spin2=True, dtype="float64",
                       tables=True)
    pt = tsht.get_plan(nside, lmax, spin2=True, dtype=torch.float64,
                       device="cpu", tables=True)
    po = tsht.get_plan(nside, lmax, spin2=True, dtype=torch.float64,
                       device="cpu")
    assert pt.lam0 is not None and pt.otf0 is None and po.lam0 is None
    assert pt.split == pj.split == (nside > 1)
    assert sum(t.numel() * t.element_size() for t in (
        pt.lam0, pt.lam_p2, pt.lam_m2)) == tsht.table_bytes(
        nside, lmax, spin2=True)
    # the tables themselves, in the port's m-major layout
    for k in ("lam0", "lam_p2", "lam_m2"):
        ref = np.transpose(np.asarray(getattr(pj, k)), (2, 0, 1))
        assert _rel(getattr(pt, k), ref) <= 1e-12, k
    rng = np.random.default_rng(nside)
    for name, args in _calls(nside, lmax, rng):
        const = [x for x in args if not isinstance(x, np.ndarray)]
        arrs = [x for x in args if isinstance(x, np.ndarray)]
        ref = _as_list(_J[name](pj, *map(jnp.asarray, arrs), *const))
        got = _as_list(getattr(tsht, name)(pt, *map(torch.as_tensor, arrs),
                                           *const))
        otf = _as_list(getattr(tsht, name)(po, *map(torch.as_tensor, arrs),
                                           *const))
        for g, o, r in zip(got, otf, ref):
            assert _rel(g, r) <= TOL, (nside, name)
            assert _rel(o, g.numpy()) <= TOL, (nside, name, "otf")
    # adjointness of the table path under the alm metric
    a = torch.as_tensor(_alm(rng, lmax, (2, 3)))
    m = torch.as_tensor(rng.standard_normal((2, 3, 12 * nside * nside)))
    lhs = float(torch.sum(tsht.alm2map_teb(pt, a) * m))
    rhs = float(alm_dot(a, tsht.alm2map_teb_adjoint(pt, m)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    for spin2 in (False, True):
        assert tsht.flop_count(pt, spin2) == jsht.flop_count(pj, spin2)


def _check_host_tables():
    cth2, sth2 = twig._theta_halves(4)
    for mp in (-3, 0, 2, 5):
        got = twig.wigner_d_table_fast(12, 9, mp, cth2, sth2)
        assert _rel(got, jwig.wigner_d_table(12, 9, mp, cth2, sth2)) <= 1e-12
    for spin in (0, 2):
        for got, ref in zip(twig.spin_lambda_north(8, 16, spin, 12),
                            jwig.spin_lambda_north(8, 16, spin, 12)):
            assert _rel(got, ref) <= 1e-12, spin
    for nside in (1, 8):
        np.testing.assert_array_equal(thp.area_weights(nside),
                                      jhp.area_weights(nside))


def _check_memory_guard(monkeypatch):
    tables = tsht.table_bytes(16, 32, spin2=True)
    assert tables == 2 * 16 * 33 * 33 * 8 * 3
    # the three tables and one table's layout copy
    need = tables * 4 // 3
    for free in (tables, need - 1):
        monkeypatch.setattr(tsht, "free_bytes", lambda device: free)
        with pytest.raises(ValueError, match=f"need {need} bytes"):
            tsht.get_plan(16, 32, spin2=True, device="cpu", tables=True)
    # float32 tables are half the bytes: they fit
    p = tsht.get_plan(16, 32, spin2=True, dtype=torch.float32,
                      device="cpu", tables=True)
    assert p.lam0.dtype == torch.float32
    # a tableless plan never asks
    monkeypatch.setattr(tsht, "free_bytes", lambda device: 0)
    assert tsht.get_plan(16, 32, device="cpu").lam0 is None


@pytest.mark.parametrize("case", list(CASES))
def test_table_plans_match_jax(case, monkeypatch):
    for nside, lmax in CASES[case]:
        _check_resolution(nside, lmax)
    if case == "nside16":
        _check_host_tables()
        _check_memory_guard(monkeypatch)
