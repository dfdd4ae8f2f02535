"""Tests of the port that need a CUDA card (marker `gpu`).

Each test decides inside its body whether a card is present and skips with
a reason where there is none. This file imports no JAX, so it runs on the
card's machine with `python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py` (tests/conftest.py configures JAX).
"""
import dataclasses

import numpy as np
import pytest
import torch

from commander_tpu_torch import entry
from commander_tpu_torch.sampling import amplitude as amp
from commander_tpu_torch.sampling import gibbs
from commander_tpu_torch.sphere import cuda_sht, sht, sht_otf


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _relmax(got, ref):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    return np.abs(got - ref).max() / np.abs(ref).max()


def _inputs(rng, nside, lmax, mp, batch, dev):
    nl, nh = lmax + 1, 2 * nside
    a = rng.standard_normal((batch, nl, nl)) \
        + 1j * rng.standard_normal((batch, nl, nl))
    a *= np.tril(np.ones((nl, nl)))
    a[:, : abs(mp)] = 0.0
    g = [rng.standard_normal((batch, nh, nl))
         + 1j * rng.standard_normal((batch, nh, nl)) for _ in range(2)]
    c = lambda x: torch.as_tensor(x.astype(np.complex64), device=dev)
    return c(a), c(g[0]), c(g[1])


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 3, 6])
@pytest.mark.parametrize("mp", [0, 2, -2])
@pytest.mark.parametrize("nside,lmax", [(16, 40), (64, 128)])
def test_cuda_kernels_match_plain(nside, lmax, mp, batch):
    """Both kernels against the float32 plain version (same coefficient
    pack, same single-rounded recurrence), and their adjointness, at 1e-5;
    batch 6 crosses the kernels' batch groups of 4."""
    dev = _card()
    rng = np.random.default_rng(50 + mp + batch)
    alm, Gn, Gs = _inputs(rng, nside, lmax, mp, batch, dev)
    otf = sht_otf.legendre_otf(nside, lmax, mp, torch.float32, device=dev)
    n0 = dict(cuda_sht.LAUNCHES)
    Fn, Fs = cuda_sht.synth_legendre(otf, alm, 2 * nside)
    a = cuda_sht.adjoint_legendre(otf, Gn, Gs)
    torch.cuda.synchronize()
    assert cuda_sht.LAUNCHES["synth"] == n0["synth"] + 1
    assert cuda_sht.LAUNCHES["adjoint"] == n0["adjoint"] + 1
    Fn_p, Fs_p = cuda_sht.synth_legendre_plain(otf, alm, 2 * nside)
    a_p = cuda_sht.adjoint_legendre_plain(otf, Gn, Gs)
    assert _relmax(Fn, Fn_p) <= 1e-5
    assert _relmax(Fs, Fs_p) <= 1e-5
    assert _relmax(a, a_p) <= 1e-5
    c = lambda t: t.to(torch.complex128)
    lhs = torch.sum(c(Fn) * c(Gn).conj() + c(Fs) * c(Gs).conj())
    rhs = torch.sum(c(alm) * c(a).conj())
    assert abs(complex(lhs - rhs)) <= 1e-5 * abs(complex(lhs))


@pytest.mark.gpu
def test_cuda_adjoint_is_deterministic():
    """The adjoint reduces across blocks without atomics: two runs give the
    same bits."""
    dev = _card()
    rng = np.random.default_rng(3)
    _, Gn, Gs = _inputs(rng, 64, 128, 0, 3, dev)
    otf = sht_otf.legendre_otf(64, 128, 0, torch.float32, device=dev)
    a1 = cuda_sht.adjoint_legendre(otf, Gn, Gs)
    a2 = cuda_sht.adjoint_legendre(otf, Gn, Gs)
    assert torch.equal(a1, a2)


@pytest.mark.gpu
def test_cuda_transforms_match_cpu_float64():
    """alm2map / alm2map_adjoint on the card (float32, kernels) against the
    CPU float64 plain path: 1e-4 of the max (float32 recurrence error at
    lmax 64 plus the float32 FFTs)."""
    dev = _card()
    nside, lmax = 32, 64
    rng = np.random.default_rng(4)
    nl = lmax + 1
    alm = rng.standard_normal((2, nl, nl)) + 1j * rng.standard_normal((2, nl, nl))
    alm *= np.tril(np.ones((nl, nl)))
    alm[..., 0] = alm[..., 0].real
    p32 = sht.get_plan(nside, lmax, dtype=torch.float32, device=dev)
    p64 = sht.get_plan(nside, lmax, dtype=torch.float64)
    m_ref = sht.alm2map(p64, torch.as_tensor(alm))
    m_gpu = sht.alm2map(p32, torch.as_tensor(alm, device=dev))
    assert _relmax(m_gpu, m_ref) <= 1e-4
    a_ref = sht.alm2map_adjoint(p64, m_ref)
    a_gpu = sht.alm2map_adjoint(p32, m_ref.to(dev, torch.float32))
    assert _relmax(a_gpu, a_ref) <= 1e-4


@pytest.mark.gpu
def test_cuda_gibbs_chain_is_reproducible():
    """Two 2-step chains on the card from the same seed give the same bits
    (no float atomics anywhere in the step)."""
    dev = _card()
    plan, sys_g, cfg, _ = entry.build_problem(16, 32, dtype=torch.float32,
                                              device=dev)
    runs = []
    for _ in range(2):
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        st = entry.initial_state(cfg, sys_g)
        for _ in range(2):
            st = gibbs.gibbs_step(cfg, sys_g, plan, st, gen)
        runs.append(st)
    assert torch.equal(runs[0].a, runs[1].a)
    assert torch.equal(runs[0].cl_bins, runs[1].cl_bins)


@pytest.mark.gpu
def test_cuda_gibbs_step_wiener_matches_cpu():
    """One Wiener-mean amplitude solve of the entry problem at nside 16 on
    the card (float32) against the CPU float64 solve: 1e-4 relative."""
    dev = _card()
    kw = dict(nside=16, lmax=32, nband=3, cg_tol=1e-6, cg_maxiter=60)
    plan_c, sys_c, cfg, _ = entry.build_problem(dtype=torch.float64, **kw)
    plan_g, sys_g, _, _ = entry.build_problem(dtype=torch.float32,
                                              device=dev, **kw)
    nbins = len(cfg.cl_cfg.bin_starts)
    cl = gibbs.eval_cl_all(cfg, sys_c, torch.full((3, 1, nbins), 100.0,
                                                   dtype=torch.float64))
    a_c, _ = amp.sample_amplitudes(dataclasses.replace(sys_c, cl=cl), plan_c,
                                   tol=1e-8)
    a_g, res = amp.sample_amplitudes(
        dataclasses.replace(sys_g, cl=cl.to(dev, torch.float32)), plan_g,
        tol=1e-6)
    assert res.rel_res <= 1e-6
    assert _relmax(a_g, a_c) <= 1e-4
