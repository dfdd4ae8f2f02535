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
holds them against the plain version there. What can be held here is their
arithmetic: replay_lamhat runs the kernels' recurrence in numpy float32, with
the tile and run lengths read from the CUDA sources, against the reference
form of the recurrence, bit for bit. The tests do so at small sizes;

    python3 tests/test_torch_cuda_sht.py --nside 1024 --lmax 2000 --mp 0

does at any size (about ten minutes at that one) and prints how many rows of
lamhat differ (0 is the claim) and how many chain-tiles ran deep.
"""
import os
import re

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

_CSRC = os.path.join(os.path.dirname(cuda_sht.__file__), os.pardir, "csrc")


def _kernel_constants():
    """Every `constexpr int NAME = <integer>;` of the CUDA sources."""
    out = {}
    for name in ("legendre_common.cuh", "legendre_adjoint.cu",
                 "legendre_synth.cu"):
        with open(os.path.join(_CSRC, name)) as f:
            for key, val in re.findall(
                    r"constexpr int (\w+) = (-?\d+);", f.read()):
                assert out.setdefault(key, int(val)) == int(val)
    return out


_K = _kernel_constants()
DEEP_E, DEEP_RUN, LT, TM, R, TY = (_K[k] for k in (
    "DEEP_E", "DEEP_RUN", "LT", "TM", "R", "TY"))


def test_wrapper_constants_are_the_kernels():
    """The Python side's copies of the kernels' compile-time constants (the
    wrapper's ring partition and batch groups) equal the constexpr values in
    csrc/, and the sizes the replay and the partition model rely on hold."""
    assert cuda_sht.MAX_NB == _K["MAX_NB"]
    assert cuda_sht.RINGS_PER_THREAD == R
    assert cuda_sht.WARPS_PER_BLOCK == TY
    assert cuda_sht.RINGS_PER_BLOCK == TY * R
    assert cuda_sht.MAX_CLUSTER == _K["MAX_CLUSTER"]
    assert TM == 32                                # one warp per m tile row
    assert LT % DEEP_RUN == 0 and LT % _K["LCI"] == 0 and _K["LCI"] % 2 == 0


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
                                 chunk=16, device="cpu")
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
                                 chunk=16, device="cpu")
    a_t = cuda_sht.adjoint_legendre(otf_t, torch.as_tensor(Gn),
                                    torch.as_tensor(Gs))
    assert _relmax(a_t.numpy(), a_j) <= 1e-5


@pytest.mark.parametrize("mp", MPS)
def test_plain_pair_is_adjoint_f64(mp):
    """<K1 a, G> = <a, K2 G> for the float64 plain pair, to 1e-12."""
    nside, lmax = 16, 40
    rng = np.random.default_rng(30 + mp)
    otf = sht_otf.legendre_otf(nside, lmax, mp, dtype=torch.float64,
                               chunk=16, device="cpu")
    a = torch.as_tensor(_alm(rng, lmax + 1, mp, dtype=np.complex128))
    Gn, Gs = (torch.as_tensor(g) for g in
              _spectra(rng, 2 * nside, lmax + 1, dtype=np.complex128))
    Fn, Fs = cuda_sht.synth_legendre_plain(otf, a, 2 * nside)
    lhs = torch.sum(Fn * Gn.conj() + Fs * Gs.conj())
    rhs = torch.sum(a * cuda_sht.adjoint_legendre_plain(otf, Gn, Gs).conj())
    assert abs(complex(lhs - rhs)) <= 1e-12 * abs(complex(lhs))


def replay_lamhat(pack, mp, lean, stats=None):
    """numpy float32 replay of the kernels' recurrence from the host
    coefficient pack (norm folded in, seeds at l0 = max(m, |mp|)): yields
    the emitted lamhat row (nh, nm) of every l.

    lean=True is what csrc/legendre_common.cuh runs: one exponent per
    chain, the emit gate kept as a factor scl in {1, 2^-30, 2^-60, 0} that
    changes only on a rescale, new = alpha cur - beta prev; and deep tiles:
    a warp (R rings x TM columns) whose chains are all at exponent <=
    DEEP_E at the start of a tile of LT ells past the seeding tiles runs
    the tile without the rescale test and divides at the end of each run
    of DEEP_RUN ells. stats["deep"] counts the chain-tiles run that way.
    lean=False is the reference form
    (commander_tpu.sphere.pallas_sht._rec_advance): two exponents, prev
    rescaled to cur's exponent by sc, a three-way gate, a test per step."""
    seeds, seede, A, B, beta, x = pack
    nh, nm = seeds.shape
    nl = A.shape[0]
    big, bigi = np.float32(2.0 ** 30), np.float32(2.0 ** -30)
    m = np.arange(nm)
    m0 = m // TM * TM
    origin = np.maximum(m0, abs(mp))      # first ell of the column's m tile

    def gate(e):
        return np.where(e == 0, np.float32(1), np.where(
            e == -1, bigi, np.where(e == -2, bigi * bigi, np.float32(0)))
        ).astype(np.float32)

    cur = np.zeros((nh, nm), np.float32)
    prev = np.zeros_like(cur)
    ce = np.full((nh, nm), -128, np.int32)
    pe = np.zeros_like(ce)
    scl = np.zeros_like(cur)
    deep = np.zeros((nh, nm), bool)
    for l in range(nl):
        start = np.maximum(m, abs(mp)) == l
        cur = np.where(start, seeds, cur)
        ce = np.where(start, seede, ce)
        prev = np.where(start, 0.0, prev).astype(np.float32)
        alpha = (A[l] * x[:, None] + B[l]).astype(np.float32)
        if not lean:
            pe = np.where(start, 0, pe)
            yield np.where(ce == 0, cur, np.where(
                ce == -1, cur * bigi, np.where(
                    ce == -2, cur * (bigi * bigi), 0.0))).astype(np.float32)
            de = pe - ce
            sc = np.where(de == 0, 1.0, np.where(de <= -1, bigi, big))
            sc = np.where(de <= -2, 0.0, sc).astype(np.float32)
            new = (alpha * cur - beta[l] * prev * sc).astype(np.float32)
            grow = np.abs(new) > big
            new = np.where(grow, new * bigi, new)
            cur_sc = np.where(grow, cur * bigi, cur)
            ne = ce + grow.astype(np.int32)
            prev, pe, cur, ce = cur_sc, ne, new, ne
            continue
        scl = np.where(start, gate(ce), scl)
        at_tile = (l >= origin) & ((l - origin) % LT == 0)
        if at_tile.any():
            # the warp's vote; columns past nm repeat the last one
            ok = (ce <= DEEP_E) & (scl == 0)
            nmp = -(-nm // TM) * TM
            ok = np.concatenate([ok, np.repeat(ok[:, -1:], nmp - nm, 1)], 1)
            warp = ok.reshape(nh // R, R, nmp // TM, TM).all(axis=(1, 3))
            warp = np.repeat(np.repeat(warp, R, 0), TM, 1)[:, :nm]
            now = warp & (l >= m0 + TM)[None, :]
            deep = np.where(at_tile[None, :], now, deep)
            if stats is not None:
                stats["deep"] = stats.get("deep", 0) + int(
                    (now & at_tile[None, :]).sum())
        yield (cur * scl).astype(np.float32)
        new = (alpha * cur - beta[l] * prev).astype(np.float32)
        grow = (np.abs(new) > big) & ~deep
        prev = np.where(grow, cur * bigi, cur)
        cur = np.where(grow, new * bigi, new)
        ce = ce + grow.astype(np.int32)
        scl = np.where(grow, gate(ce), scl)
        late = deep & ((l - origin) % DEEP_RUN == DEEP_RUN - 1)[None, :]
        while (late & (np.abs(cur) > big)).any():
            g = late & (np.abs(cur) > big)
            cur = np.where(g, cur * bigi, cur)
            prev = np.where(g, prev * bigi, prev)
            ce = ce + g.astype(np.int32)


def _emulate_kernels(pack, mp, alm, Gn, Gs):
    """numpy float32 replay of legendre_synth.cu / legendre_adjoint.cu's
    arithmetic from the host coefficient pack (the lean recurrence of
    replay_lamhat, even-l / odd-l sums E and O), so the pack and the
    kernels' recurrence are checked where no card is."""
    nh, nm = pack[0].shape
    pm = np.where(np.arange(nm) % 2 == 1, -1.0, 1.0).astype(np.float32)
    E = np.zeros(alm.shape[:1] + (nh, nm), np.complex64)
    O = np.zeros_like(E)
    a_out = np.zeros(alm.shape, np.complex64)
    ge, go = Gn + pm * Gs, Gn - pm * Gs
    for l, lam in enumerate(replay_lamhat(pack, mp, lean=True)):
        if l % 2:
            O += lam * alm[:, l][:, None, :]
            a_out[:, l] = np.sum(lam * go, axis=1)
        else:
            E += lam * alm[:, l][:, None, :]
            a_out[:, l] = np.sum(lam * ge, axis=1)
    return E + O, pm * (E - O), a_out


@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("nside,lmax", [(16, 40), (64, 150)])
def test_lean_recurrence_has_the_reference_bits(nside, lmax, mp):
    """Dropping the second exponent and the rescale factor, keeping the
    emit gate as a factor, and dividing deep chains once per run of ells
    changes no bit of lamhat: every row of the lean replay equals the
    reference replay exactly. The sizes rescale many chains (polar seeds
    start many blocks of 2^30 down); the larger one has deep tiles."""
    pack = cuda_sht._coeff_pack(nside, lmax, mp, lmax)
    assert (pack[1] < -2).any()          # chains that start below emergence
    rows, stats = 0, {}
    for lam_lean, lam_ref in zip(replay_lamhat(pack, mp, True, stats),
                                 replay_lamhat(pack, mp, False)):
        assert np.array_equal(lam_lean, lam_ref)
        rows += 1
    assert rows == lmax + 1
    assert (stats["deep"] > 0) == (nside == 64)


@pytest.mark.parametrize("mp", MPS)
def test_device_pack_is_the_host_pack(mp):
    """The pack the kernels read (_device_pack, here through its CPU path)
    holds the host pack's values in the host pack's layout: rows of nm
    floats with no padding (the kernels copy 4 and 8 bytes at a time, so
    odd rows need no alignment), copied once per device and kept."""
    nside, lmax = 8, 21                  # nm = 22: rows not a multiple of 16 B
    otf = sht_otf.legendre_otf(nside, lmax, mp, dtype=torch.float32,
                               device="cpu")
    dev = cuda_sht._device_pack(otf, torch.device("cpu"))
    host = cuda_sht._coeff_pack(nside, lmax, mp, lmax)
    assert cuda_sht._device_pack(otf, torch.device("cpu")) is dev
    for d, h in zip(dev, host):
        assert d.is_contiguous() and tuple(d.shape) == h.shape
        np.testing.assert_array_equal(d.numpy(), h)
    assert dev[0].stride() == (lmax + 1, 1) and dev[2].stride() == (lmax + 1, 1)
    assert dev[1].dtype == torch.int32 and dev[2].dtype == torch.float32
    # the plain version runs on a pack of its own and leaves this one alone
    a = torch.zeros((1, lmax + 1, lmax + 1), dtype=torch.complex64)
    cuda_sht.synth_legendre_plain(otf, a, 2 * nside)
    for d, h in zip(dev, host):
        np.testing.assert_array_equal(d.numpy(), h)


@pytest.mark.parametrize("nh", [16, 32, 512, 2048, 4096])
def test_adjoint_ring_partition(nh):
    """The adjoint kernel's ring partition (cuda_sht.adjoint_plan): every
    ring has exactly one owner (slice, pass, rank, warp, k), the owner is
    where the kernel's index arithmetic puts the ring, and adding in owner
    order (k, then warp, then rank, then pass, then slice) is one fixed
    order that reaches every ring once."""
    plan = cuda_sht.adjoint_plan(nh)
    assert plan.cluster in (1, 2, 4, 8) and 1 <= plan.nslice <= 8
    assert plan.cluster * TY * R <= max(nh, TY * R)   # no idle block
    owners = [plan.owner(r) for r in range(nh)]
    assert len(set(owners)) == nh
    for ring, (s, p, rank, warp, k) in enumerate(owners):
        assert 0 <= s < plan.nslice and 0 <= p < plan.npass
        assert 0 <= rank < plan.cluster and 0 <= warp < TY and 0 <= k < R
        # legendre_adjoint.cu: sc = slice + pass * nslice,
        # ring0 = (sc * CL + rank) * RINGS_PER_BLOCK + ty * R
        sc = s + p * plan.nslice
        assert (sc * plan.cluster + rank) * TY * R + warp * R + k == ring
    if nh == 2048:      # the tutorial shape: one pass, rows written once
        assert (plan.cluster, plan.nslice, plan.npass) == (8, 8, 1)
    if nh == 4096:
        assert plan.npass == 2
    # the sum in the kernel's order, in float32, of one output entry
    rng = np.random.default_rng(nh)
    v = rng.standard_normal(nh).astype(np.float32)
    order = sorted(range(nh), key=lambda r: owners[r])
    levels = np.zeros((plan.nslice, plan.npass, plan.cluster, TY), np.float32)
    for r in order:                       # level 1: a thread adds its k
        s, p, rank, warp, _ = owners[r]
        levels[s, p, rank, warp] += v[r]
    total = np.float32(0)
    for s in range(plan.nslice):
        part = np.float32(0)
        for p in range(plan.npass):       # passes add into the slice's row
            clus = np.float32(0)
            for rank in range(plan.cluster):
                blk = levels[s, p, rank, 0]
                for warp in range(1, TY):
                    blk = np.float32(blk + levels[s, p, rank, warp])
                clus = np.float32(clus + blk)
            part = np.float32(part + clus)
        total = np.float32(total + part)
    assert abs(total - v.astype(np.float64).sum()) <= 1e-5 * np.abs(v).sum()


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
                               chunk=16, device="cpu")
    Fn, Fs = cuda_sht.synth_legendre_plain(otf, torch.as_tensor(alm), 2 * nside)
    a = cuda_sht.adjoint_legendre_plain(otf, torch.as_tensor(Gn),
                                        torch.as_tensor(Gs))
    assert _relmax(Fn_e, Fn.numpy()) <= 1e-6
    assert _relmax(Fs_e, Fs.numpy()) <= 1e-6
    assert _relmax(a_e, a.numpy()) <= 1e-6


def test_wrappers_refuse_what_the_kernels_do_not_take():
    otf = sht_otf.legendre_otf(8, 16, 0, dtype=torch.float32,
                               device="cpu")
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
    got = convert.legendre_otf(d, nside=8, device="cpu")
    ref = sht_otf.legendre_otf(8, 16, 2, dtype=torch.float64, chunk=16,
                               device="cpu")
    for f in ("seed_mant", "seed_exp", "A", "Bc", "beta", "x", "norm",
              "parity_m", "m_vals"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(ref, f).numpy())
    assert (got.lmax, got.mmax, got.mp, got.chunk) == (16, 16, 2, 16)


if __name__ == "__main__":
    import argparse
    import time
    ap = argparse.ArgumentParser(
        description="lean replay of the kernels' recurrence against the "
                    "reference form, at any size")
    ap.add_argument("--nside", type=int, default=64)
    ap.add_argument("--lmax", type=int, default=150)
    ap.add_argument("--mp", type=int, default=0)
    args = ap.parse_args()
    t0 = time.time()
    pack = cuda_sht._coeff_pack(args.nside, args.lmax, args.mp, args.lmax)
    stats, bad, rows = {}, 0, 0
    for lean, ref in zip(replay_lamhat(pack, args.mp, True, stats),
                         replay_lamhat(pack, args.mp, False)):
        bad += not np.array_equal(lean, ref)
        rows += 1
    print(f"nside {args.nside} lmax {args.lmax} mp {args.mp}: {rows} rows of "
          f"lamhat, {bad} differ from the reference form; "
          f"{stats.get('deep', 0)} chain-tiles ran deep; "
          f"{time.time() - t0:.0f} s")
    raise SystemExit(1 if bad else 0)
