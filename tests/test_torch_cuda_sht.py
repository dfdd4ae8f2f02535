"""The port's Legendre stage (commander_tpu_torch.sphere.cuda_sht) against
the JAX package's Pallas kernels.

On the CPU the wrappers take their plain version (the chunked torch
recurrence); it is held against both Pallas pairs in interpret mode, the
on-path MXU pair and the VPU pair. Tolerance: max |diff| <= 1e-5 max |ref|
(max over all entries of the output), because the JAX side is float32 with
bf16x3 contractions. The port side runs in float64, so the difference is
the JAX kernels' own float32 error, which grows with l near the poles (up
to ~8e-6 at lmax 40; most of it comes from cos(theta) of the polar rings
rounded to float32); two float32 paths with different rounding would
differ by the sum of two such errors.
The CUDA kernels themselves run only on a card: tests/test_torch_gpu.py
holds them against the plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.sphere import pallas_sht as jp
from commander_tpu.sphere import sht_otf as jotf
from commander_tpu_torch import convert
from commander_tpu_torch.sphere import cuda_sht, sht_otf

SIZES = [(8, 16), (16, 40)]
MPS = [0, 2, -2]
BATCH = 3

JAX_PAIRS = {
    "mxu": (jp.synth_legendre_pallas_mxu, jp.adjoint_legendre_pallas_mxu),
    "vpu": (jp.synth_legendre_pallas, jp.adjoint_legendre_pallas),
}


def _alm(rng, nl, mp, batch=BATCH, dtype=np.complex64):
    a = rng.standard_normal((batch, nl, nl)) \
        + 1j * rng.standard_normal((batch, nl, nl))
    a *= np.tril(np.ones((nl, nl)))
    a[:, : abs(mp)] = 0.0
    return a.astype(dtype)


def _spectra(rng, nh, nm, batch=BATCH, dtype=np.complex64):
    return tuple((rng.standard_normal((batch, nh, nm))
                  + 1j * rng.standard_normal((batch, nh, nm))).astype(dtype)
                 for _ in range(2))


def _relmax(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("pair", ["mxu", "vpu"])
@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("nside,lmax", SIZES)
def test_synth_matches_pallas(pair, mp, nside, lmax):
    rng = np.random.default_rng(10 + nside + mp)
    alm = _alm(rng, lmax + 1, mp)
    otf_j = jotf.legendre_otf(nside, lmax, mp, dtype="float32", chunk=16)
    Fn_j, Fs_j = JAX_PAIRS[pair][0](otf_j, jnp.asarray(alm), 2 * nside,
                                    interpret=True)
    otf_t = sht_otf.legendre_otf(nside, lmax, mp, dtype=torch.float64,
                                 chunk=16)
    before = dict(cuda_sht.LAUNCHES)
    Fn_t, Fs_t = cuda_sht.synth_legendre(otf_t, torch.as_tensor(alm),
                                         2 * nside)
    assert cuda_sht.LAUNCHES == before      # CPU tensors take the plain path
    scale = max(np.abs(np.asarray(Fn_j)).max(), np.abs(np.asarray(Fs_j)).max())
    assert np.abs(Fn_t.numpy() - np.asarray(Fn_j)).max() <= 1e-5 * scale
    assert np.abs(Fs_t.numpy() - np.asarray(Fs_j)).max() <= 1e-5 * scale


@pytest.mark.parametrize("pair", ["mxu", "vpu"])
@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("nside,lmax", SIZES)
def test_adjoint_matches_pallas(pair, mp, nside, lmax):
    rng = np.random.default_rng(20 + nside + mp)
    Gn, Gs = _spectra(rng, 2 * nside, lmax + 1)
    otf_j = jotf.legendre_otf(nside, lmax, mp, dtype="float32", chunk=16)
    a_j = JAX_PAIRS[pair][1](otf_j, jnp.asarray(Gn), jnp.asarray(Gs),
                             interpret=True)
    otf_t = sht_otf.legendre_otf(nside, lmax, mp, dtype=torch.float64,
                                 chunk=16)
    a_t = cuda_sht.adjoint_legendre(otf_t, torch.as_tensor(Gn),
                                    torch.as_tensor(Gs))
    assert _relmax(a_t.numpy(), a_j) <= 1e-5


@pytest.mark.parametrize("mp", MPS)
def test_plain_pair_is_adjoint_f64(mp):
    """<K1 a, G> = <a, K2 G> for the float64 plain pair, to 1e-12."""
    nside, lmax = 16, 40
    rng = np.random.default_rng(30 + mp)
    otf = sht_otf.legendre_otf(nside, lmax, mp, dtype=torch.float64,
                               chunk=16)
    a = torch.as_tensor(_alm(rng, lmax + 1, mp, dtype=np.complex128))
    Gn, Gs = (torch.as_tensor(g) for g in
              _spectra(rng, 2 * nside, lmax + 1, dtype=np.complex128))
    Fn, Fs = cuda_sht.synth_legendre_plain(otf, a, 2 * nside)
    lhs = torch.sum(Fn * Gn.conj() + Fs * Gs.conj())
    rhs = torch.sum(a * cuda_sht.adjoint_legendre_plain(otf, Gn, Gs).conj())
    assert abs(complex(lhs - rhs)) <= 1e-12 * abs(complex(lhs))


def _emulate_kernels(pack, mp, alm, Gn, Gs):
    """numpy float32 replay of legendre_synth.cu / legendre_adjoint.cu's
    arithmetic from the host coefficient pack (norm folded in, seeds at
    l0 = max(m, |mp|), the _emit gate and the emergence-boundary fix), so
    the pack and the kernels' recurrence are checked where no card is."""
    seeds, seede, A, B, beta, x = pack
    nh, nm = seeds.shape
    nl = A.shape[0]
    big, bigi = np.float32(2.0 ** 30), np.float32(2.0 ** -30)
    m = np.arange(nm)
    pm = np.where(m % 2 == 1, -1.0, 1.0).astype(np.float32)
    cur = np.zeros((nh, nm), np.float32)
    prev = np.zeros_like(cur)
    ce = np.full((nh, nm), -128, np.int32)
    pe = np.zeros_like(ce)
    E = np.zeros(alm.shape[:1] + (nh, nm), np.complex64)
    O = np.zeros_like(E)
    a_out = np.zeros(alm.shape, np.complex64)
    ge, go = Gn + pm * Gs, Gn - pm * Gs
    for l in range(nl):
        start = np.maximum(m, abs(mp)) == l
        cur = np.where(start, seeds, cur)
        ce = np.where(start, seede, ce)
        prev = np.where(start, 0.0, prev).astype(np.float32)
        pe = np.where(start, 0, pe)
        lam = np.where(ce == 0, cur, np.where(ce == -1, cur * bigi, np.where(
            ce == -2, cur * (bigi * bigi), 0.0))).astype(np.float32)
        if l % 2:
            O += lam * alm[:, l][:, None, :]
            a_out[:, l] = np.sum(lam * go, axis=1)
        else:
            E += lam * alm[:, l][:, None, :]
            a_out[:, l] = np.sum(lam * ge, axis=1)
        alpha = (A[l] * x[:, None] + B[l]).astype(np.float32)
        de = pe - ce
        sc = np.where(de == 0, 1.0, np.where(de <= -1, bigi, big))
        sc = np.where(de <= -2, 0.0, sc).astype(np.float32)
        new = (alpha * cur - beta[l] * prev * sc).astype(np.float32)
        grow = np.abs(new) > big
        new = np.where(grow, new * bigi, new)
        cur_sc = np.where(grow, cur * bigi, cur)
        ne = ce + grow.astype(np.int32)
        prev, pe, cur, ce = cur_sc, ne, new, ne
    return E + O, pm * (E - O), a_out


@pytest.mark.parametrize("mp", MPS)
def test_kernel_arithmetic_from_pack_matches_plain(mp):
    """The kernels' float32 arithmetic, replayed in numpy from the pack,
    equals the float32 plain version up to the order of the final sums
    (both run the same single-rounded recurrence): 1e-6."""
    nside, lmax = 16, 40
    rng = np.random.default_rng(40 + mp)
    alm = _alm(rng, lmax + 1, mp)
    Gn, Gs = _spectra(rng, 2 * nside, lmax + 1)
    pack = cuda_sht._coeff_pack(nside, lmax, mp, lmax)
    Fn_e, Fs_e, a_e = _emulate_kernels(pack, mp, alm, Gn, Gs)
    otf = sht_otf.legendre_otf(nside, lmax, mp, dtype=torch.float32,
                               chunk=16)
    Fn, Fs = cuda_sht.synth_legendre_plain(otf, torch.as_tensor(alm), 2 * nside)
    a = cuda_sht.adjoint_legendre_plain(otf, torch.as_tensor(Gn),
                                        torch.as_tensor(Gs))
    assert _relmax(Fn_e, Fn.numpy()) <= 1e-6
    assert _relmax(Fs_e, Fs.numpy()) <= 1e-6
    assert _relmax(a_e, a.numpy()) <= 1e-6


def test_wrappers_refuse_what_the_kernels_do_not_take():
    otf = sht_otf.legendre_otf(8, 16, 0, dtype=torch.float32)
    bad = torch.zeros((2, 17, 17), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        cuda_sht.synth_legendre(otf, bad, 16)
    with pytest.raises(ValueError):
        cuda_sht.adjoint_legendre(otf, bad[:, :16], bad[:, :16])


def test_converted_otf_equals_ported_otf():
    """convert.legendre_otf carries the JAX recurrence data across
    unchanged, and it is the data the port builds itself."""
    import dataclasses
    otf_j = jotf.legendre_otf(8, 16, 2, dtype="float64", chunk=16)
    d = {f.name: getattr(otf_j, f.name) for f in dataclasses.fields(otf_j)}
    got = convert.legendre_otf(d, nside=8)
    ref = sht_otf.legendre_otf(8, 16, 2, dtype=torch.float64, chunk=16)
    for f in ("seed_mant", "seed_exp", "A", "Bc", "beta", "x", "norm",
              "parity_m", "m_vals"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(ref, f).numpy())
    assert (got.lmax, got.mmax, got.mp, got.chunk) == (16, 16, 2, 16)
