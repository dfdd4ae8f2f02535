"""The port's spin-2 and T/E/B transforms (commander_tpu_torch.sphere.sht,
sht_otf) against the JAX package's tableless transforms.

float64 at nside 8 / lmax 16: 1e-10 of the max (both sides are float64 and
differ only in the order of sums). The JAX `legendre_backend="pallas"` spin-2
plan, its kernels in interpret mode, against the port's float32 plan at
nside 8 / lmax 16 and nside 16 / lmax 40: 1e-5 of the max, the tolerance of
tests/test_pallas_sht.py (float32 recurrences with other roundings).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.sphere import sht as jsht
from commander_tpu.sphere import sht_otf as jotf
from commander_tpu_torch.sphere import cuda_sht
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.sphere import sht_otf as totf
from commander_tpu_torch.sphere.alm import alm_dot

NSIDE, LMAX = 8, 16
NPIX = 12 * NSIDE * NSIDE


@pytest.fixture(scope="module")
def plans():
    return (jsht.get_plan(NSIDE, LMAX, spin2=True, dtype="float64",
                          tables=False),
            tsht.get_plan(NSIDE, LMAX, spin2=True, dtype=torch.float64,
                          device="cpu"))


def _alm(rng, batch, lmax=LMAX, dtype=np.complex128):
    nl = lmax + 1
    a = rng.standard_normal(batch + (nl, nl)) \
        + 1j * rng.standard_normal(batch + (nl, nl))
    a *= np.tril(np.ones((nl, nl)))
    a[..., 0] = a[..., 0].real
    return a.astype(dtype)


def _close(got, ref, tol=1e-10):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_spin2_plan_holds_the_reference_recurrences(plans):
    """otf_p2 is the mp = -2 recurrence and otf_m2 the mp = +2 one, array
    for array (swapped, Q/U would be wrong with every adjointness test
    still passing)."""
    pj, pt = plans
    assert (pt.otf_p2.mp, pt.otf_m2.mp) == (-2, 2)
    for name in ("otf_p2", "otf_m2"):
        oj, ot = getattr(pj, name), getattr(pt, name)
        assert oj.mp == ot.mp
        for f in ("seed_mant", "seed_exp", "A", "Bc", "beta", "x", "norm"):
            np.testing.assert_array_equal(getattr(ot, f).numpy(),
                                          np.asarray(getattr(oj, f)))
    np.testing.assert_array_equal(pt.lmmask.numpy(), np.asarray(pj.lmmask))
    plain = tsht.get_plan(NSIDE, LMAX, dtype=torch.float64, device="cpu")
    assert plain.otf_p2 is None and plain.otf_m2 is None
    with pytest.raises(ValueError, match="spin2=True"):
        tsht.alm2map_spin2(plain, torch.zeros(LMAX + 1, LMAX + 1),
                           torch.zeros(LMAX + 1, LMAX + 1))


@pytest.mark.parametrize("fn", ["alm2map_spin2", "alm2map_spin2_adjoint",
                                "map2alm_spin2"])
def test_spin2_transform_matches_jax(plans, fn):
    pj, pt = plans
    rng = np.random.default_rng(len(fn))
    if fn == "alm2map_spin2":
        x, y = _alm(rng, (2,)), _alm(rng, (2,))
    else:
        x, y = rng.standard_normal((2, 2, NPIX))
    ref = getattr(jsht, fn)(pj, jnp.asarray(x), jnp.asarray(y))
    got = getattr(tsht, fn)(pt, torch.as_tensor(x), torch.as_tensor(y))
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("fn", ["alm2map_teb", "alm2map_teb_adjoint",
                                "map2alm_teb"])
def test_teb_transform_matches_jax(plans, fn):
    """Batch (2 bands, 3 Stokes): the layout the amplitude operator uses."""
    pj, pt = plans
    rng = np.random.default_rng(10 + len(fn))
    x = _alm(rng, (2, 3)) if fn == "alm2map_teb" \
        else rng.standard_normal((2, 3, NPIX))
    ref = getattr(jsht, fn)(pj, jnp.asarray(x))
    _close(getattr(tsht, fn)(pt, torch.as_tensor(x)), ref)


def test_two_recurrence_stage_matches_jax(plans):
    """synth_spin2_otf (both recurrences in one chunk loop) and
    alm2map_spin2_otf against their JAX namesakes."""
    pj, pt = plans
    rng = np.random.default_rng(3)
    E, B = _alm(rng, (2,)), _alm(rng, (2,))
    cp, cm = -(E + 1j * B), -(E - 1j * B)
    ref = jotf.synth_spin2_otf(pj.otf_p2, pj.otf_m2, jnp.asarray(cp),
                               jnp.asarray(cm), pj.nh)
    got = totf.synth_spin2_otf(pt.otf_p2, pt.otf_m2, torch.as_tensor(cp),
                               torch.as_tensor(cm), pt.nh)
    for g, r in zip(got, ref):
        _close(g, r)
    ref = jotf.alm2map_spin2_otf(pj, pj.otf_p2, pj.otf_m2, jnp.asarray(E),
                                 jnp.asarray(B))
    got = totf.alm2map_spin2_otf(pt, pt.otf_p2, pt.otf_m2,
                                 torch.as_tensor(E), torch.as_tensor(B))
    for g, r in zip(got, ref):
        _close(g, r)


def test_composed_route_equals_two_recurrence_route(plans):
    """The port's two routes to (Q, U): two calls of the spin-0-shaped
    Legendre stage at mp -2 / +2 (what the CUDA kernels run on the card)
    and the two-recurrence chunk loop; the former also on the kernels'
    coefficient pack (norm folded in), as the card's plain version runs."""
    _, pt = plans
    rng = np.random.default_rng(4)
    E, B = (torch.as_tensor(_alm(rng, (3,))) for _ in range(2))
    Q, U = tsht.alm2map_spin2(pt, E, B)
    Q2, U2 = totf.alm2map_spin2_otf(pt, pt.otf_p2, pt.otf_m2, E, B)
    _close(Q2, Q.numpy(), 1e-12)
    _close(U2, U.numpy(), 1e-12)
    Q3, U3 = totf.alm2map_spin2_otf(pt, cuda_sht.pack_otf(pt.otf_p2),
                                    cuda_sht.pack_otf(pt.otf_m2), E, B)
    _close(Q3, Q.numpy(), 1e-12)
    _close(U3, U.numpy(), 1e-12)


def test_teb_adjoint_is_exact_under_eps_metric(plans):
    """<Y a, m> = <a, Yt m>_eps for the T/E/B transform pair (a real at
    m = 0, the subspace the sampler stays in)."""
    _, pt = plans
    rng = np.random.default_rng(5)
    a = torch.as_tensor(_alm(rng, (2, 3)))
    m = torch.as_tensor(rng.standard_normal((2, 3, NPIX)))
    lhs = float(torch.sum(tsht.alm2map_teb(pt, a) * m))
    rhs = float(alm_dot(a, tsht.alm2map_teb_adjoint(pt, m)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("nside,lmax", [(8, 16), (16, 40)])
def test_float32_plan_matches_jax_pallas_plan(nside, lmax):
    """The JAX package's Pallas-backed spin-2 plan (interpret mode on the
    CPU) against the port's float32 plan: synthesis and adjoint."""
    pj = jsht.get_plan(nside, lmax, spin2=True, dtype="float32",
                       tables=False, legendre_backend="pallas")
    pt = tsht.get_plan(nside, lmax, spin2=True, dtype=torch.float32,
                       device="cpu")
    rng = np.random.default_rng(nside)
    E = _alm(rng, (1,), lmax, np.complex64)
    B = _alm(rng, (1,), lmax, np.complex64)
    E[:, :2] = B[:, :2] = 0
    ref = jsht.alm2map_spin2(pj, jnp.asarray(E), jnp.asarray(B))
    got = tsht.alm2map_spin2(pt, torch.as_tensor(E), torch.as_tensor(B))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        _close(g, r, 1e-5)
    Q, U = rng.standard_normal((2, 1, 12 * nside * nside)).astype(np.float32)
    ref = jsht.alm2map_spin2_adjoint(pj, jnp.asarray(Q), jnp.asarray(U))
    got = tsht.alm2map_spin2_adjoint(pt, torch.as_tensor(Q),
                                     torch.as_tensor(U))
    for g, r in zip(got, ref):
        assert g.dtype == torch.complex64
        _close(g, r, 1e-5)


@pytest.mark.parametrize("fn,args", [("map2alm_iter", (2,)),
                                     ("map_smooth_weighted", ()),
                                     ("smooth_map", (300.0,)),
                                     ("smooth_map", (300.0, 1))])
def test_spin0_helpers_match_jax(plans, fn, args):
    pj, pt = plans
    rng = np.random.default_rng(6)
    m = rng.standard_normal((2, NPIX))
    ref = getattr(jsht, fn)(pj, jnp.asarray(m), *args)
    _close(getattr(tsht, fn)(pt, torch.as_tensor(m), *args), ref)


@pytest.mark.parametrize("spin2", [False, True])
def test_flop_count_matches_jax(plans, spin2):
    pj, pt = plans
    ref, got = jsht.flop_count(pj, spin2=spin2), tsht.flop_count(pt, spin2)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-12)


@pytest.mark.parametrize("nb,want", [(1, (1,)), (3, (3,)), (4, (4,)),
                                     (5, (3, 2)), (6, (3, 3)), (7, (4, 3)),
                                     (9, (3, 3, 3))])
def test_batch_groups_are_even(nb, want):
    """A batch is cut into the fewest kernel launches, of even sizes; the
    adjoint's scratch is sized for the largest group."""
    assert cuda_sht.batch_groups(nb) == want
    otf = totf.legendre_otf(8, 16, 2, torch.float32, device="cpu")
    nslice = cuda_sht.adjoint_plan(16).nslice
    assert cuda_sht.adjoint_scratch_bytes(otf, nb) \
        == nslice * max(want) * 17 * 17 * 8
    with pytest.raises(ValueError):
        cuda_sht.batch_groups(0)
