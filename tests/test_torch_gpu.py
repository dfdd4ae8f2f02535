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
from commander_tpu_torch.sampling import full_gibbs, gibbs, specind
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
@pytest.mark.parametrize("nside,lmax", [(8, 16), (16, 40), (64, 128),
                                        (256, 512)])
def test_cuda_kernels_match_plain(nside, lmax, mp, batch):
    """Both kernels against the float32 plain version (same coefficient
    pack, same single-rounded recurrence), and their adjointness, at 1e-5;
    batch 6 crosses the kernels' batch groups of 4; nside 8 has fewer rings
    (16) than one block holds, nside 256 fills two 8-block clusters."""
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
@pytest.mark.parametrize("cluster,nside,lmax,npass", [
    (1, 16, 40, 1), (2, 32, 64, 1), (4, 64, 128, 1), (8, 128, 256, 1),
    (8, 2048, 64, 2)])
def test_cuda_adjoint_cluster_sizes_agree(cluster, nside, lmax, npass):
    """Every cluster size that adjoint_plan chooses (by the number of rings)
    gives the plain version's sum to 1e-5; nh = 4096 rings take two passes
    that add into the partial rows."""
    dev = _card()
    plan = cuda_sht.adjoint_plan(2 * nside)
    assert (plan.cluster, plan.npass) == (cluster, npass)
    rng = np.random.default_rng(60 + cluster + npass)
    _, Gn, Gs = _inputs(rng, nside, lmax, 0, 3, dev)
    otf = sht_otf.legendre_otf(nside, lmax, 0, torch.float32, device=dev)
    a = cuda_sht.adjoint_legendre(otf, Gn, Gs)
    a_p = cuda_sht.adjoint_legendre_plain(otf, Gn, Gs)
    assert _relmax(a, a_p) <= 1e-5


@pytest.mark.gpu
def test_cuda_adjoint_scratch_is_what_the_wrapper_says():
    """The adjoint's peak device memory above its inputs is its output plus
    the partial rows that adjoint_scratch_bytes reports (the allocator
    rounds each block up to 2 MiB at most)."""
    dev = _card()
    nside, lmax, batch = 256, 512, 3
    rng = np.random.default_rng(61)
    _, Gn, Gs = _inputs(rng, nside, lmax, 0, batch, dev)
    otf = sht_otf.legendre_otf(nside, lmax, 0, torch.float32, device=dev)
    cuda_sht.adjoint_legendre(otf, Gn, Gs)      # builds, copies the pack
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a = cuda_sht.adjoint_legendre(otf, Gn, Gs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    scratch = cuda_sht.adjoint_scratch_bytes(otf, batch)
    plan = cuda_sht.adjoint_plan(2 * nside)
    assert scratch == plan.nslice * batch * (lmax + 1) ** 2 * 8
    want = scratch + a.numel() * 8
    assert want <= peak <= want + 2 * 2**21


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
    p64 = sht.get_plan(nside, lmax, dtype=torch.float64, device="cpu")
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
    plan_c, sys_c, cfg, _ = entry.build_problem(dtype=torch.float64,
                                                device="cpu", **kw)
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


@pytest.mark.gpu
@pytest.mark.parametrize("nside,lmax,batch", [(16, 40, 1), (64, 128, 3)])
def test_cuda_spin2_composed_matches_plain_route(nside, lmax, batch):
    """alm2map_spin2 on the card (two kernel calls at mp -2 / +2, batch
    2 x `batch`) against the plain two-recurrence route on the kernels'
    pack, 1e-5 of the max; the composed adjoint is the adjoint of that plain
    synthesis to 1e-5; each direction launches each kernel twice."""
    from commander_tpu_torch.sphere.alm import alm_dot

    dev = _card()
    rng = np.random.default_rng(70 + nside)
    plan = sht.get_plan(nside, lmax, spin2=True, dtype=torch.float32,
                        device=dev)
    E, _, _ = _inputs(rng, nside, lmax, 2, batch, dev)
    B, _, _ = _inputs(rng, nside, lmax, 2, batch, dev)
    E[..., 0] = E[..., 0].real.to(E.dtype)
    B[..., 0] = B[..., 0].real.to(B.dtype)
    m = torch.as_tensor(rng.standard_normal((2, batch, 12 * nside * nside))
                        .astype(np.float32), device=dev)
    n0 = dict(cuda_sht.LAUNCHES)
    Q, U = sht.alm2map_spin2(plan, E, B)
    assert cuda_sht.LAUNCHES == {"synth": n0["synth"] + 2,
                                 "adjoint": n0["adjoint"]}
    Eh, Bh = sht.alm2map_spin2_adjoint(plan, m[0], m[1])
    assert cuda_sht.LAUNCHES == {"synth": n0["synth"] + 2,
                                 "adjoint": n0["adjoint"] + 2}
    Qp, Up = sht_otf.alm2map_spin2_otf(
        plan, cuda_sht.pack_otf(plan.otf_p2), cuda_sht.pack_otf(plan.otf_m2),
        E, B)
    scale = max(float(Qp.abs().max()), float(Up.abs().max()))
    assert float((Q - Qp).abs().max()) <= 1e-5 * scale
    assert float((U - Up).abs().max()) <= 1e-5 * scale
    c = lambda t: t.to(torch.complex128)
    lhs = float(torch.sum(Qp.double() * m[0] + Up.double() * m[1]))
    rhs = float(alm_dot(c(E), c(Eh)) + alm_dot(c(B), c(Bh)))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.gpu
def test_cuda_teb_transforms_match_cpu_float64():
    """alm2map_teb / alm2map_teb_adjoint on the card (float32, kernels)
    against the CPU float64 plain path: 1e-4 of the max, as for spin 0."""
    dev = _card()
    nside, lmax = 32, 64
    rng = np.random.default_rng(8)
    nl = lmax + 1
    alm = rng.standard_normal((2, 3, nl, nl)) \
        + 1j * rng.standard_normal((2, 3, nl, nl))
    alm *= np.tril(np.ones((nl, nl)))
    alm[..., 0] = alm[..., 0].real
    alm[:, 1:, :2] = 0.0
    p32 = sht.get_plan(nside, lmax, spin2=True, dtype=torch.float32,
                       device=dev)
    p64 = sht.get_plan(nside, lmax, spin2=True, dtype=torch.float64,
                       device="cpu")
    m_ref = sht.alm2map_teb(p64, torch.as_tensor(alm))
    # complex64 in: the Stokes rows reach the kernels as strided views
    m_gpu = sht.alm2map_teb(p32, torch.as_tensor(alm.astype(np.complex64),
                                                 device=dev))
    assert _relmax(m_gpu, m_ref) <= 1e-4
    a_ref = sht.alm2map_teb_adjoint(p64, m_ref)
    a_gpu = sht.alm2map_teb_adjoint(p32, m_ref.to(dev, torch.float32))
    assert _relmax(a_gpu, a_ref) <= 1e-4


@pytest.mark.gpu
def test_cuda_polarized_chain_is_reproducible():
    """Two 2-step chains of the tutorial_pol preset at nside 16 on the card
    from the same seed give the same bits, with the launch counts the code
    implies (3 wrapper calls per transform)."""
    dev = _card()
    plan, sys_g, cfg, _ = entry.build_preset(
        "tutorial_pol", torch.float32, dev, nside=16, lmax=32)
    runs = []
    for _ in range(2):
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        st = entry.initial_state(cfg, sys_g)
        for _ in range(2):
            n0 = dict(cuda_sht.LAUNCHES)
            st = gibbs.gibbs_step(cfg, sys_g, plan, st, gen)
            n_apply = st.cg_iters + 1
            assert cuda_sht.LAUNCHES["synth"] - n0["synth"] == 3 * n_apply
            assert cuda_sht.LAUNCHES["adjoint"] - n0["adjoint"] \
                == 3 * (n_apply + 1)
        runs.append(st)
    assert torch.equal(runs[0].a, runs[1].a)
    assert torch.equal(runs[0].cl_bins, runs[1].cl_bins)
    assert torch.isfinite(runs[0].cl_bins).all()


@pytest.mark.gpu
def test_cuda_entry_full_step_matches_cpu():
    """One whole Gibbs iteration of entry_full at nside 32 / lmax 64 on the
    card (float32) against the CPU float64 step on the same data with the
    same draws: amplitudes to 1e-3, every index to 0.05 of its grid step;
    theta stays a float64 tensor on the card."""
    dev = _card()
    kw = dict(nside=32, lmax=64)
    pd = entry.build_preset("entry_full", torch.float32, dev, **kw)
    pc = entry.build_preset("entry_full", torch.float64, "cpu", **kw)
    sys_c = dataclasses.replace(pc.sys, data=pd.sys.data.double().cpu())
    gen = torch.Generator()
    gen.manual_seed(1)
    C, S = sys_c.F.shape[1], sys_c.F.shape[2]
    from commander_tpu_torch.sphere.alm import random_alm_white
    draws = {
        "eta1": torch.randn(sys_c.data.shape, generator=gen,
                            dtype=torch.float64),
        "eta2": random_alm_white(gen, (C, S, 65, 65)),
        "gamma": torch.as_tensor(np.random.default_rng(2).gamma(
            50.0, size=(C, S, len(pd.cfg.cl_cfg.bin_starts)))),
        "u": torch.rand(len(pd.slots), generator=gen, dtype=torch.float64),
    }
    to_d = {k: v.to(dev, torch.complex64 if v.is_complex() else (
        torch.float64 if k == "u" else torch.float32))
        for k, v in draws.items()}
    n0 = dict(cuda_sht.LAUNCHES)
    new_d, th_d, sys_d = full_gibbs.full_gibbs_step(
        pd.cfg, pd.comps, pd.bps, pd.slots, pd.sys, pd.plan,
        entry.initial_state(pd.cfg, pd.sys), pd.thetas0, draws=to_d,
        beam_consistent=True)
    n_apply = new_d.cg_iters + 1
    assert cuda_sht.LAUNCHES["synth"] - n0["synth"] \
        == 3 * n_apply + len(pd.slots) * 9
    assert cuda_sht.LAUNCHES["adjoint"] - n0["adjoint"] == 3 * (n_apply + 1)
    assert th_d.device.type == "cuda" and th_d.dtype == torch.float64
    assert sys_d.F.device.type == "cuda" and sys_d.F.dtype == torch.float32
    new_c, th_c, _ = full_gibbs.full_gibbs_step(
        dataclasses.replace(pc.cfg, cg_tol=1e-10, cg_maxiter=200), pc.comps,
        pc.bps, pc.slots, sys_c, pc.plan, entry.initial_state(pc.cfg, sys_c),
        pc.thetas0, draws=draws, beam_consistent=True)
    assert _relmax(new_d.a, new_c.a) <= 1e-3
    for s, d, c in zip(pd.slots, th_d.tolist(), th_c.tolist()):
        h = (s.cfg.grid_max - s.cfg.grid_min) / (s.cfg.ngrid - 1)
        assert abs(d - c) <= 0.05 * h


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["entry_full", "fullgibbs"])
def test_cuda_full_chain_is_reproducible(preset):
    """Two 2-step chains of the whole iteration at nside 16 on the card
    from the same seed give the same bits: amplitudes, C_ell bins and
    theta."""
    dev = _card()
    pb = entry.build_preset(preset, torch.float32, dev, nside=16, lmax=32)
    runs = []
    for _ in range(2):
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        st, th = entry.initial_state(pb.cfg, pb.sys), pb.thetas0
        for _ in range(2):
            st, th, _ = full_gibbs.full_gibbs_step(
                pb.cfg, pb.comps, pb.bps, pb.slots, pb.sys, pb.plan, st, th,
                gen, beam_consistent=pb.beam_consistent)
        runs.append((st, th))
    assert torch.equal(runs[0][0].a, runs[1][0].a)
    assert torch.equal(runs[0][0].cl_bins, runs[1][0].cl_bins)
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.isfinite(runs[0][1]).all()


@pytest.mark.gpu
def test_cuda_region_sampler_is_reproducible_and_matches_cpu():
    """The region sums on the card (membership products, no atomics): the
    same bits twice, and the CPU's values to float64 rounding."""
    dev = _card()
    pb = entry.build_preset("fullgibbs", torch.float64, "cpu", nside=16,
                            lmax=32)
    slot = pb.slots[1]
    rng = np.random.default_rng(3)
    P = pb.sys.data.shape[-1]
    amp_pix = torch.as_tensor(50.0 + rng.standard_normal((1, P)))
    rop = rng.integers(0, 7, P)
    u = torch.as_tensor(rng.random(7))
    args = lambda d: (pb.comps[slot.ci], pb.bps, slot.cfg,
                      pb.sys.data.to(d), amp_pix.to(d),
                      pb.sys.inv_rms2.to(d), (1.6, 19.6), rop, 7)
    ref = specind.sample_specind_regions(*args("cpu"), which=0, u=u)
    got = [specind.sample_specind_regions(*args(dev), which=0, u=u.to(dev))
           for _ in range(2)]
    assert torch.equal(got[0][0], got[1][0])
    assert float((got[0][0].cpu() - ref[0]).abs().max()) <= 1e-9


@pytest.mark.gpu
def test_cuda_index_phase_makes_no_host_sync():
    """The index phase (F rebuilds from theta on the card, syntheses, the
    64-point lnL grids, the inversions) runs with torch's sync debug mode
    set to "error": any .item(), host copy of a device value or pageable
    host-to-device copy inside it would raise."""
    dev = _card()
    pb = entry.build_preset("fullgibbs", torch.float32, dev, nside=16,
                            lmax=32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    args = (pb.comps, pb.bps, pb.slots, pb.sys, pb.plan, pb.a_true,
            pb.thetas0, gen)
    full_gibbs.sample_indices(*args, beam_consistent=True)   # first-use set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        th = full_gibbs.sample_indices(*args, beam_consistent=True)
        sys_new = full_gibbs.system_at(pb.sys, pb.comps, pb.bps, pb.slots, th)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(th).all() and torch.isfinite(sys_new.F).all()


def _entry_tod_pass_inputs(dev):
    """entry_tod on the card (nside 64 / lmax 128, 3 bands of 16 x 4 x 8192
    samples) and its model sky at the start values, after a warm-up pass
    that makes the first-use tensors (PSD grids, pixel vectors)."""
    from commander_tpu_torch.sampling import chisq, tod_gibbs

    pb = entry.build_preset("entry_tod", torch.float32, dev)
    sys0 = full_gibbs.system_at(pb.sys, pb.comps, pb.bps, pb.slots,
                                pb.thetas0)
    sky = chisq.sky_signal(sys0, pb.plan, pb.a_true)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tod_gibbs.tod_pass(pb.bands, pb.sys, sky, True, gen)
    torch.cuda.synchronize()
    return pb, sky


@pytest.mark.gpu
def test_cuda_tod_pass_is_reproducible():
    """Two TOD passes from the same generator seed give the same bits: the
    binned maps and their noise, gains and n_corr (the per-pixel sums run
    over pixel-sorted samples, with no float atomics)."""
    from commander_tpu_torch.sampling import tod_gibbs

    dev = _card()
    pb, sky = _entry_tod_pass_inputs(dev)
    runs = []
    for _ in range(2):
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        runs.append(tod_gibbs.tod_pass(pb.bands, pb.sys, sky, False, gen))
    (b0, s0), (b1, s1) = runs
    assert torch.equal(s0.data, s1.data)
    assert torch.equal(s0.inv_rms, s1.inv_rms)
    assert bool((s0.inv_rms > 0).any()) and bool((s0.inv_rms == 0).any())
    for x, y in zip(b0, b1):
        for f in ("gain", "sigma0", "alpha", "fknee", "n_corr"):
            assert torch.equal(getattr(x.state, f), getattr(y.state, f))


@pytest.mark.gpu
def test_cuda_tod_pass_makes_no_host_sync():
    """A TOD pass over the three bands of entry_tod and its system update
    run with torch's sync debug mode set to "error": no .item(), host copy
    of a device value or pageable host-to-device copy inside them."""
    from commander_tpu_torch.sampling import tod_gibbs

    dev = _card()
    pb, sky = _entry_tod_pass_inputs(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        bands, sys1 = tod_gibbs.tod_pass(pb.bands, pb.sys, sky, False, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(sys1.data).all() and torch.isfinite(
        bands[0].state.n_corr).all()


@pytest.mark.gpu
def test_cuda_preconditioners_make_no_host_sync_and_match_plain(monkeypatch):
    """On entry_tod's binned system (nside 64 / lmax 128, T/Q/U, after a TOD
    pass): a pseudo-inverse application, and a low-ell build (L 8) and
    application, run with torch's sync debug mode "error" (the
    pseudo-inverse's build runs before it: its batched SVD reads a status
    back to the host). Then the same work through the plain Legendre
    versions on the card, no kernel launched: the pseudo-inverse's
    application to 1e-4 of its max (two transforms in turn, each within
    1e-5 of its plain version) and the low-ell block to 1e-5 of its max."""
    from commander_tpu_torch.sampling import tod_gibbs

    dev = _card()
    pb, sky = _entry_tod_pass_inputs(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    _, base = tod_gibbs.tod_pass(pb.bands, pb.sys, sky, True, gen)
    sys_b = full_gibbs.system_at(base, pb.comps, pb.bps, pb.slots,
                                 pb.thetas0)
    C, S, nl = sys_b.F.shape[1], sys_b.F.shape[2], sys_b.tri.shape[0]
    rng = np.random.default_rng(4)
    r = rng.standard_normal((C, S, nl, nl)) \
        + 1j * rng.standard_normal((C, S, nl, nl))
    r = torch.as_tensor((r * np.tril(np.ones((nl, nl)))).astype(np.complex64),
                        device=dev)
    M_pi = amp.build_preconditioner_pseudoinv(sys_b, pb.plan)
    amp.build_preconditioner_lowl(sys_b, pb.plan, 8)   # first-use set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        z_pi = M_pi(r)
        z_l = amp.build_preconditioner_lowl(sys_b, pb.plan, 8)(r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    blk = amp.lowl_block(sys_b, 8)
    monkeypatch.setattr(cuda_sht, "synth_legendre",
                        cuda_sht.synth_legendre_plain)
    monkeypatch.setattr(cuda_sht, "adjoint_legendre",
                        cuda_sht.adjoint_legendre_plain)
    n0 = dict(cuda_sht.LAUNCHES)
    z_pi_plain = M_pi(r)
    blk_plain = amp.lowl_block(sys_b, 8)
    assert cuda_sht.LAUNCHES == n0
    monkeypatch.undo()
    assert bool(torch.isfinite(torch.view_as_real(z_l)).all())
    assert _relmax(z_pi, z_pi_plain) <= 1e-4
    assert _relmax(blk, blk_plain) <= 1e-5


def _entry_joint_inputs(dev):
    """entry_joint at nside 32 / lmax 64 in float32 on the card (a few scans
    of TOD), with its system at the start values."""
    tod = dict(entry.TOD_NOISE, nscan=4, ndet=2, ntod=2048)
    pb = entry.build_preset("entry_joint", torch.float32, dev, nside=32,
                            lmax=64, tod=tod)
    sys0 = full_gibbs.system_at(pb.sys, pb.comps, pb.bps, pb.slots,
                                pb.thetas0)
    return pb, sys0


@pytest.mark.gpu
def test_cuda_ptsrc_forward_is_deterministic():
    """The sources' scatter sums each pixel's run with segment_reduce and
    writes it once: two calls give the same bits, with stamps that overlap
    (20 sources, and 8 more on the same pixels)."""
    from commander_tpu_torch.sampling import joint

    dev = _card()
    pb, _ = _entry_joint_inputs(dev)
    ps = pb.ps
    npix = pb.sys.data.shape[-1]
    pix = torch.cat([ps.pix, ps.pix[:8]])
    stamp = torch.cat([ps.stamp, 0.5 * ps.stamp[:, :, :8]], dim=2)
    ps2 = joint.make_ptsrc_set(pix, stamp, npix, device=dev)
    assert ps2.uniq.numel() < ps2.flat.numel()
    p = torch.linspace(10.0, 200.0, pix.shape[0], device=dev)
    m1 = joint._ptsrc_fwd(ps2, p, npix)
    m2 = joint._ptsrc_fwd(ps2, p, npix)
    assert torch.equal(m1, m2)
    ref = torch.zeros(m1.numel(), dtype=torch.float64, device=dev)
    ref.index_add_(0, ps2.flat, (ps2.stamp.double() * p.double()[
        None, None, :, None]).reshape(-1))
    assert _relmax(m1.reshape(-1).double(), ref) <= 1e-6


@pytest.mark.gpu
def test_cuda_joint_operator_makes_no_host_sync():
    """An application of the joint operator (entry_joint: 5 components,
    T/Q/U, 13 template rows, 20 sources) and of its preconditioner run with
    torch's sync debug mode "error"; the rhs too (the preconditioner's
    float64 build runs before it)."""
    from commander_tpu_torch.sampling import joint

    dev = _card()
    pb, sys0 = _entry_joint_inputs(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    M = joint.build_joint_preconditioner(sys0, pb.plan, pb.ts, pb.ps)
    b = joint.compute_rhs_joint(sys0, pb.plan, pb.ts, pb.ps, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        Ab = joint.apply_A_joint(sys0, pb.plan, pb.ts, pb.ps, b)
        Mb = M(Ab)
        b2 = joint.compute_rhs_joint(sys0, pb.plan, pb.ts, pb.ps, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for v in (Ab, Mb, b2):
        assert bool(torch.isfinite(torch.view_as_real(v.a)).all())
        assert bool(torch.isfinite(v.t).all() and torch.isfinite(v.p).all())


def _entry_multires(dev):
    return entry.build_preset("entry_multires", torch.float32, dev,
                              nsides=(8, 8, 16), lmaxs=(16, 16, 32))


@pytest.mark.gpu
def test_cuda_multires_step_is_reproducible():
    """Two seeded multires_gibbs_steps of entry_multires (two resolution
    groups, T/Q/U, five slots, gains on) on the card give the same bits:
    amplitudes, C_l bins, theta, gains."""
    from commander_tpu_torch.sampling import multires_gibbs as mg

    dev = _card()
    pb = _entry_multires(dev)
    runs = []
    for _ in range(2):
        gen = torch.Generator(device=dev)
        gen.manual_seed(4)
        runs.append(mg.multires_gibbs_step(pb, mg.init_state(pb), gen))
    a, b = runs
    assert torch.equal(a.a, b.a) and torch.equal(a.cl_bins, b.cl_bins)
    assert torch.equal(a.thetas, b.thetas)
    assert torch.equal(a.gains, b.gains)
    assert torch.isfinite(a.thetas).all() and a.cg_iters == b.cg_iters


@pytest.mark.gpu
def test_cuda_multires_step_makes_no_host_sync_beyond_the_cg(monkeypatch):
    """A whole multires_gibbs_step under torch's sync debug mode "error",
    with the mode lifted only inside the CG (pcg reads its residual norm
    and the breakdown test back, two reads per iteration): the rhs, the
    preconditioner, the C_l draws, the index phase over both groups, the F
    rebuilds and the gains make no host sync."""
    from commander_tpu_torch.sampling import multires
    from commander_tpu_torch.sampling import multires_gibbs as mg

    dev = _card()
    pb = _entry_multires(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    mg.multires_gibbs_step(pb, mg.init_state(pb), gen)   # first-use set-up
    torch.cuda.synchronize()
    pcg0 = multires.pcg

    def pcg(*a, **k):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return pcg0(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(multires, "pcg", pcg)
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = mg.multires_gibbs_step(pb, mg.init_state(pb), gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(st.thetas).all() and torch.isfinite(st.gains).all()


@pytest.mark.gpu
@pytest.mark.parametrize("mp", [0, 2, -2])
def test_cuda_float64_cast_route_matches_complex64(mp):
    """complex128 alms and ring spectra go through the same kernels, cast
    to complex64 on the way in and back to complex128 on the way out (the
    Pallas route's cast): bit for bit the complex64 call, cast; one launch
    per call, as the complex64 call."""
    dev = _card()
    rng = np.random.default_rng(60 + mp)
    alm, Gn, Gs = _inputs(rng, 64, 128, mp, 3, dev)
    otf = sht_otf.legendre_otf(64, 128, mp, torch.float64, device=dev)
    n0 = dict(cuda_sht.LAUNCHES)
    Fn, Fs = cuda_sht.synth_legendre(otf, alm.to(torch.complex128), 128)
    a = cuda_sht.adjoint_legendre(otf, Gn.to(torch.complex128),
                                  Gs.to(torch.complex128))
    assert cuda_sht.LAUNCHES["synth"] == n0["synth"] + 1
    assert cuda_sht.LAUNCHES["adjoint"] == n0["adjoint"] + 1
    Fn32, Fs32 = cuda_sht.synth_legendre(otf, alm, 128)
    a32 = cuda_sht.adjoint_legendre(otf, Gn, Gs)
    torch.cuda.synchronize()
    assert Fn.dtype == Fs.dtype == a.dtype == torch.complex128
    assert torch.equal(Fn, Fn32.to(torch.complex128))
    assert torch.equal(Fs, Fs32.to(torch.complex128))
    assert torch.equal(a, a32.to(torch.complex128))


_CLI_SMALL = ["param_tutorial_full.txt", "--synthetic", "--pol", "--nside",
              "64", "--lmax", "128"]


@pytest.mark.gpu
def test_cuda_cli_is_reproducible(tmp_path):
    """python -m commander_tpu_torch at nside 64 (float64, the card's
    generator seeded from BASE_SEED and the chain) twice: the same chain
    bits, sample by sample."""
    from commander_tpu_torch import run as trun
    from commander_tpu_torch.io.chain import ChainFile

    _card()
    paths = []
    for k in range(2):
        (r,) = trun.main(_CLI_SMALL + ["--niter", "2", "--outdir",
                                       str(tmp_path / str(k))])
        paths.append(r.chain_path)
    with ChainFile(paths[0], "r") as c0, ChainFile(paths[1], "r") as c1:
        assert c0.last_sample() == c1.last_sample() == 2
        for i in (1, 2):
            s0, s1 = c0.read_sample(i), c1.read_sample(i)
            for name, f in s0["comps"].items():
                for k, v in f.items():
                    assert np.array_equal(v, s1["comps"][name][k]), (i, k)
            for k, v in s0["aux"].items():
                assert np.array_equal(v, s1["aux"][k]), (i, k)


@pytest.mark.gpu
def test_cuda_loop_iteration_makes_no_host_sync(tmp_path, monkeypatch):
    """From the second attempt on, the loop's TOD phase and sky phase
    (--tod --f32: the TOD pass, full_gibbs_step with the md, relquad and
    source rows, the chi^2) run with torch's sync debug mode "error",
    except inside the CG (its two reads per iteration, and the joint
    preconditioner's float64 build before it): the loop's only other read
    is the chi^2 and relres after the phase, for the reject rule."""
    from commander_tpu_torch import run as trun
    from commander_tpu_torch.driver import loop
    from commander_tpu_torch.sampling import joint

    _card()
    calls = {"n": 0}

    def checked(fn):
        def run(*a, **k):
            calls["n"] += 1
            if calls["n"] <= 2:          # the first attempt: set-up copies
                return fn(*a, **k)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    def allowed(fn):
        def run(*a, **k):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return run

    for mod, name in ((loop, "tod_phase"), (loop, "sky_phase")):
        monkeypatch.setattr(mod, name, checked(getattr(mod, name)))
    for mod, name in ((amp, "pcg"), (joint, "pcg"),
                      (joint, "build_joint_preconditioner")):
        monkeypatch.setattr(mod, name, allowed(getattr(mod, name)))
    (r,) = trun.main(_CLI_SMALL + [
        "--niter", "2", "--tod", "--f32", "--outdir", str(tmp_path),
        "--SYNTH_TOD_NSCAN=8", "--SYNTH_TOD_NTOD=8192"])
    assert calls["n"] >= 4 and len(r.records) >= 2
    assert all(np.isfinite(x["chisq"]) for x in r.records)


@pytest.mark.gpu
def test_cuda_cli_matches_its_cpu_twin(tmp_path):
    """The float64 command at nside 16 on the card, and on the CPU with the
    card's generator (run.main(..., rng_device="cuda"): every draw made on
    the card and moved): the same chain to the cast route's precision, alms
    1e-3 of their max and indices 0.05 grid step."""
    from commander_tpu_torch import run as trun
    from commander_tpu_torch.driver.model import (comp_to_diffuse,
                                                  diffuse_configs)
    from commander_tpu_torch.io.chain import ChainFile
    from commander_tpu_torch.io.params import Params, lower_params
    from commander_tpu_torch.sampling.full_gibbs import make_index_slots

    _card()
    argv = ["param_tutorial_full.txt", "--synthetic", "--pol", "--nside",
            "16", "--lmax", "32", "--niter", "2"]
    (rc,) = trun.main(argv + ["--outdir", str(tmp_path / "card")])
    (rh,) = trun.main(argv + ["--cpu", "--outdir", str(tmp_path / "cpu")],
                      rng_device="cuda")
    pc = diffuse_configs(lower_params(Params.load(argv[0])))
    diffuse = [comp_to_diffuse(c) for c in pc]
    with ChainFile(rc.chain_path, "r") as cd, \
            ChainFile(rh.chain_path, "r") as ch:
        for i in (1, 2):
            sd, sh = cd.read_sample(i), ch.read_sample(i)
            for name in sh["comps"]:
                a, b = sd["comps"][name]["alm"], sh["comps"][name]["alm"]
                assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
            for s in make_index_slots(diffuse, pc):
                step = (s.cfg.grid_max - s.cfg.grid_min) / (s.cfg.ngrid - 1)
                name = diffuse[s.ci].name
                assert abs(sd["comps"][name]["specind"][s.which]
                           - sh["comps"][name]["specind"][s.which]) \
                    <= 0.05 * step



def _diff_pass(block, sky, pvec, draws, nside):
    from commander_tpu_torch.tod import differential as td
    from commander_tpu_torch.tod.process import TodConfig, init_tod_state

    cfg = TodConfig(nside=nside, nu=70e9, pol=True)
    return td.process_tod_diff(cfg, block, init_tod_state(block), sky, pvec,
                               draws=draws)


@pytest.mark.gpu
def test_cuda_differential_pass_matches_cpu_and_is_reproducible():
    """A differential pass (T/Q/U, nside 32, 8 scans x 2 detectors x 4096
    samples) on the card twice from the same draws gives the same bits
    (each horn's adjoint sums its pixel-sorted runs, no float atomics).
    Against the CPU's float64 pass: gains, sigma0, n_corr and x_im within
    1e-6 of their max, the same mapmaker iteration count, and the map
    within 10x the CPU map's own move under a 1e-14 move of the sky (the
    pass's imbalance comes out near 0.01, where the mapmaker stops at
    maxiter and rounding moves the map: tests/test_torch_differential.py);
    the mapmaker alone on T at x_im 0.2, where it converges (on T/Q/U
    pixels seen at fewer than three angles leave it at maxiter), within
    1e-6."""
    from commander_tpu_torch.sampling.tod_gibbs import pixel_vectors
    from commander_tpu_torch.tod import differential as td
    from commander_tpu_torch.tod.process import TodConfig

    dev = _card()
    ns = 32
    rng = np.random.default_rng(0)
    sky = torch.as_tensor(rng.standard_normal((3, 12 * ns * ns)) * 50.0)
    blk_c, _ = td.simulate_tod_diff(ns, sky, nscan=8, ndet=2, ntod=4096,
                                    pol=True, seed=3, device="cpu")
    draws = td.diff_pass_draws(TodConfig(nside=ns, nu=70e9, pol=True),
                               blk_c, torch.Generator().manual_seed(1))
    blk_d = blk_c.to(dev)
    pv = lambda d: pixel_vectors(ns, torch.float64, d)
    out = [_diff_pass(blk_d, sky.to(dev), pv("cuda"), draws, ns)
           for _ in range(2)]
    ref = _diff_pass(blk_c, sky, pv("cpu"), draws, ns)
    moved = _diff_pass(blk_c, sky * (1.0 + 1e-14), pv("cpu"), draws, ns)
    (s0, p0), (s1, p1) = out
    for k in ("map", "rms", "x_im"):
        assert torch.equal(p0[k], p1[k])
    for f in ("gain", "sigma0", "n_corr"):
        assert torch.equal(getattr(s0, f), getattr(s1, f))
        assert _relmax(getattr(s0, f), getattr(ref[0], f)) <= 1e-6, f
    assert _relmax(p0["x_im"], ref[1]["x_im"]) <= 1e-6
    assert p0["cg_iters"] == ref[1]["cg_iters"]
    spread = _relmax(moved[1]["map"], ref[1]["map"])
    assert _relmax(p0["map"], ref[1]["map"]) <= max(1e-6, 10 * spread)
    npix = 12 * ns * ns
    inv_var = torch.ones(8, 2, dtype=torch.float64)
    sol = [td.solve_diff_map(b.tod, b.pixA, b.psiA, b.pixB, b.psiB, 0.2,
                             b.mask, inv_var.to(b.tod.device), npix, False,
                             horns=b.horns(npix)) for b in (blk_d, blk_c)]
    assert sol[0][1].iters == sol[1][1].iters < td.MAPMAKER_MAXITER
    assert _relmax(sol[0][0], sol[1][0]) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("nside,lmax", [(1, 2), (16, 32), (256, 512)])
def test_cuda_table_path_matches_kernels(nside, lmax):
    """The float32 table plan's transforms (spin 0, spin 2, T/E/B,
    synthesis and adjoint; one bmm over m per Legendre stage) against the
    float64 table plan's at 1e-5 of the max, launching no kernel, and
    against the kernel plan's within the kernels' own float32 recurrence
    error (their distance from the float64 transform) plus 1e-5; nside 1
    takes the whole-sphere Bluestein ring stage in every plan."""
    dev = _card()
    rng = np.random.default_rng(nside)
    nl, npix = lmax + 1, 12 * nside * nside
    a = rng.standard_normal((2, 3, nl, nl)) \
        + 1j * rng.standard_normal((2, 3, nl, nl))
    a *= np.tril(np.ones((nl, nl)))
    a[..., 0] = a[..., 0].real
    alm = torch.as_tensor(a.astype(np.complex64), device=dev)
    maps = torch.as_tensor(rng.standard_normal((2, 3, npix)),
                           dtype=torch.float32, device=dev)
    plan = lambda dt, tab: sht.get_plan(nside, lmax, spin2=True, dtype=dt,
                                        device=dev, tables=tab)
    pt, p64, pk = (plan(torch.float32, True), plan(torch.float64, True),
                   plan(torch.float32, False))
    for name, x in (("alm2map_teb", alm), ("alm2map_teb_adjoint", maps),
                    ("map2alm", maps[:, 0]), ("alm2map", alm[:, 0])):
        fn = getattr(sht, name)
        exact = fn(p64, x.to(torch.complex128 if x.is_complex()
                             else torch.float64))
        ref = fn(pk, x)
        n0 = dict(cuda_sht.LAUNCHES)
        got = fn(pt, x)
        assert cuda_sht.LAUNCHES == n0, name
        assert _relmax(got, exact) <= 1e-5, name
        assert _relmax(got, ref) <= _relmax(ref, exact) + 1e-5, name


@pytest.mark.gpu
def test_cuda_conviqt_and_zodi_match_cpu():
    """conviqt's f-maps, the sidelobe signal and the zodi template in
    float64, the card against the CPU, to 1e-10 of their max."""
    from commander_tpu_torch.tod import conviqt, zodi

    dev = _card()
    rng = np.random.default_rng(3)
    nl, M = 17, 3
    a = rng.standard_normal((nl, nl)) + 1j * rng.standard_normal((nl, nl))
    a *= np.tril(np.ones((nl, nl)))
    a[:, 0] = a[:, 0].real
    b = (rng.standard_normal((2, nl, M + 1))
         + 1j * rng.standard_normal((2, nl, M + 1))) * 0.02
    pix = torch.as_tensor(rng.integers(0, 12 * 64 ** 2, (3, 2, 500)))
    psi = torch.as_tensor(rng.uniform(0, 2 * np.pi, (3, 2, 500)))
    satpos = np.stack([np.linspace(0, 300, 3), np.zeros(3)], -1)
    out = {}
    for d in ("cpu", dev):
        plan = sht.get_plan(8, nl - 1, device=d)
        fm = conviqt.build_sl_fmaps(plan, conviqt.conviqt_tables(
            8, nl - 1, M, device=d), torch.as_tensor(a).to(d),
            torch.as_tensor(b).to(d))
        sl_pix = torch.as_tensor(conviqt.degrade_table(64, 8)).to(d)[
            pix.to(d)]
        out[str(d)] = (fm, conviqt.conviqt_interp_dets(fm, sl_pix,
                                                       psi.to(d)),
                       zodi.zodi_tod_template(64, pix.to(d), satpos, 30e9))
    for got, ref in zip(out["cuda"], out["cpu"]):
        assert _relmax(got, ref) <= 1e-10
