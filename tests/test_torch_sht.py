"""The port's spin-0 SHT (commander_tpu_torch.sphere.sht) against the JAX
package's tableless transforms, float64, at nside 16 / lmax 32.

Tolerance 1e-10 of the max: both sides are float64; they differ only in the
order of sums (FFT libraries, contraction order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.sphere import sht as jsht
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.sphere.alm import alm_dot

NSIDE, LMAX = 16, 32


@pytest.fixture(scope="module")
def plans():
    return (jsht.get_plan(NSIDE, LMAX, dtype="float64", tables=False),
            tsht.get_plan(NSIDE, LMAX, dtype=torch.float64))


def _alm(rng, batch=(2,)):
    nl = LMAX + 1
    a = rng.standard_normal(batch + (nl, nl)) \
        + 1j * rng.standard_normal(batch + (nl, nl))
    a *= np.tril(np.ones((nl, nl)))
    a[..., 0] = a[..., 0].real
    return a


def _close(got, ref, tol=1e-10):
    ref = np.asarray(ref)
    assert np.abs(np.asarray(got) - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("fn", ["alm2map", "alm2map_adjoint", "map2alm"])
def test_transform_matches_jax(plans, fn):
    pj, pt = plans
    rng = np.random.default_rng(len(fn))
    if fn == "alm2map":
        x = _alm(rng, (3, 1))
    else:
        x = rng.standard_normal((3, 1, 12 * NSIDE * NSIDE))
    ref = getattr(jsht, fn)(pj, jnp.asarray(x))
    got = getattr(tsht, fn)(pt, torch.as_tensor(x))
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("stage", ["ring_synthesis", "ring_analysis"])
def test_ring_stage_matches_jax(plans, stage):
    pj, pt = plans
    rng = np.random.default_rng(5)
    nring = 4 * NSIDE - 1
    width = LMAX + 1 if stage == "ring_synthesis" else 4 * NSIDE
    x = rng.standard_normal((2, nring, width)) \
        + 1j * rng.standard_normal((2, nring, width))
    if stage == "ring_analysis":
        nphi = np.asarray([4 * min(i + 1, NSIDE, nring - i)
                           for i in range(nring)])
        x *= np.arange(width)[None, None, :] < nphi[None, :, None]
    ref = getattr(jsht, stage)(pj, jnp.asarray(x))
    got = getattr(tsht, stage)(pt, torch.as_tensor(x))
    _close(got.numpy(), ref, 1e-12)


def test_pixel_layout_matches_jax_split_path(plans):
    """The port's one-shot gathers (pad_src/pad_valid, pix_idx) give exactly
    the reference's per-ring cap copies and belt reshape."""
    pj, pt = plans
    assert pj.split
    rng = np.random.default_rng(6)
    maps = rng.standard_normal((2, 12 * NSIDE * NSIDE))
    ref = np.asarray(jsht._pad_to_rings(pj, jnp.asarray(maps)))
    got = tsht._pad_to_rings(pt, torch.as_tensor(maps)).numpy()
    np.testing.assert_array_equal(got, ref)
    fpad = rng.standard_normal((2, 4 * NSIDE - 1, 4 * NSIDE))
    ref = np.asarray(jsht._gather_pix(pj, jnp.asarray(fpad)))
    got = tsht._gather_pix(pt, torch.as_tensor(fpad)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_adjoint_is_exact_under_eps_metric(plans):
    """<Y a, m> = <a, Yt m>_eps to 1e-12 (the CG operator's symmetry)."""
    _, pt = plans
    rng = np.random.default_rng(7)
    a = torch.as_tensor(_alm(rng, (2,)))
    m = torch.as_tensor(rng.standard_normal((2, 12 * NSIDE * NSIDE)))
    lhs = float(torch.sum(tsht.alm2map(pt, a) * m))
    rhs = float(alm_dot(a, tsht.alm2map_adjoint(pt, m)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_tables_path_is_not_ported():
    with pytest.raises(NotImplementedError):
        tsht.get_plan(NSIDE, LMAX, tables=True)
