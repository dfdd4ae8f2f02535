"""Smoke run of the PyTorch / CUDA port on one card.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # small shapes, CPU, plain versions

Phases (each prints its lines; any failure raises and the exit code is not 0):
  1. the card: name and power limit (nvidia-smi), device count;
  2. build the CUDA Legendre kernels from commander_tpu_torch/csrc/; a
     register spill reported by ptxas fails the run;
  3. each kernel against its plain torch version on the card, with times,
     the least time the card could take (bound) and the adjoint's scratch:
     nside 256 / lmax 512 at mp 0, +2, -2, batch 3, and the main paths'
     shapes at nside 1024 / lmax 2000: mp 0 at batch 3, mp -2 and +2 at
     batch 6; max |diff| <= 1e-5 max |ref| and adjointness to 1e-5;
  4. the spin-2 transform composed from the kernels (alm2map_spin2 and its
     adjoint) against the plain two-recurrence route, at nside 256 and at
     nside 1024 / lmax 2000, to 1e-5 of the max, the adjointness of the
     T/E/B pair under the alm metric to 1e-5, and (reported, not gated) the
     float32 transform's error against the float64 plain transform;
  5. the entry problems (nside 64 / lmax 128, 3 bands), T only and
     polarized: one Gibbs step on the card against the same step in float64
     on the CPU, given the same draws, to 1e-3;
  6. the main paths, with the kernels' launch counts set to 0 before each
     and read after it, and held to what the code implies: the tutorial
     preset (nside 1024 / lmax 2000, 3 LFI bands, 3 components, float32, T
     only) for 3 Gibbs steps, and the polarized tutorial_pol preset (T/Q/U,
     CMB binned, synch and dust on fixed gauss priors) for 2; after each,
     outside the counts, its reduced chi-square and one step whose CG runs
     10-20 iterations, nearer the depth of a solve on real maps;
  7. a JSON line of the kernels, the card's name and power limit, and the
     result line {"ok": true, "device": {...}}.
Without a card it stops before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-5

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 bandwidth
H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def relmax(got, ref) -> float:
    d = (got.to(torch.complex128) - ref.to(torch.complex128)).abs().max()
    return float(d / ref.abs().max())


def absmax(got, ref) -> float:
    return float((got.to(torch.complex128) - ref.to(torch.complex128))
                 .abs().max())


class Timer:
    """Milliseconds per call: CUDA events on the card, host clock on CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def __call__(self, fn, reps=1) -> float:
        if self.cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            torch.cuda.synchronize()
            return t0.elapsed_time(t1) / reps
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps


def legendre_bound(nside, lmax, mp, batch):
    """(ms, "operations" | "bytes"): the least time the card could take for
    one Legendre synthesis or adjoint (the two do the same work).

    Operations: every (ring, l, m) step with l >= max(m, |mp|) needs the
    recurrence, alpha = A x + B and new = alpha cur - beta prev (5 flops),
    and 2 FMAs per batch entry (re, im; the even/odd-l fold halves the 4
    products). Bytes: the coefficient pack (A, B, beta), the seeds with
    their exponents, cos(theta), the alm and both ring spectra, each moved
    once."""
    nl = nm = lmax + 1
    nh = 2 * nside
    steps = nh * sum(nl - max(m, abs(mp)) for m in range(nm))
    flops = steps * (5 + 4 * batch)
    nbytes = (3 * nl * nm * 4 + nh * nm * 8 + nh * 4 + batch * nl * nm * 8
              + 2 * batch * nh * nm * 8)
    t_ops = flops / H100_FP32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_phase(dev, sizes):
    """Phase 3: each kernel against its plain version at each (nside, lmax,
    mps, batch); returns {(nside, mp, batch): {"synth": row, "adjoint":
    row}}."""
    from commander_tpu_torch.sphere import cuda_sht, sht_otf

    timer = Timer(dev)
    rows = {}
    for nside, lmax, mps, batch in sizes:
        for mp in mps:
            rng = np.random.default_rng(100 + nside + mp)
            nl, nh = lmax + 1, 2 * nside
            a = rng.standard_normal((batch, nl, nl)) \
                + 1j * rng.standard_normal((batch, nl, nl))
            a *= np.tril(np.ones((nl, nl)))
            a[:, : abs(mp)] = 0.0
            c64 = lambda x: torch.as_tensor(x.astype(np.complex64),
                                            device=dev)
            alm = c64(a)
            Gn = c64(rng.standard_normal((batch, nh, nl))
                     + 1j * rng.standard_normal((batch, nh, nl)))
            Gs = c64(rng.standard_normal((batch, nh, nl))
                     + 1j * rng.standard_normal((batch, nh, nl)))
            otf = sht_otf.legendre_otf(nside, lmax, mp, torch.float32,
                                       device=dev)
            Fn, Fs = cuda_sht.synth_legendre(otf, alm, nh)
            ad = cuda_sht.adjoint_legendre(otf, Gn, Gs)
            Fn_p, Fs_p = cuda_sht.synth_legendre_plain(otf, alm, nh)
            ad_p = cuda_sht.adjoint_legendre_plain(otf, Gn, Gs)
            e_syn = max(relmax(Fn, Fn_p), relmax(Fs, Fs_p))
            e_adj = relmax(ad, ad_p)
            c = lambda t: t.to(torch.complex128)
            lhs = torch.sum(c(Fn) * c(Gn).conj() + c(Fs) * c(Gs).conj())
            rhs = torch.sum(c(alm) * c(ad).conj())
            e_dot = abs(complex(lhs - rhs)) / abs(complex(lhs))
            # float64 plain on unrounded coefficients: the float32 pack's
            # own error, mostly cos(theta) of the polar rings rounded to
            # float32 (reported, not gated)
            otf64 = sht_otf.legendre_otf(nside, lmax, mp, torch.float64,
                                         device=dev)
            e64_syn = relmax(Fn, cuda_sht.synth_legendre_plain(otf64, alm,
                                                               nh)[0])
            e64_adj = relmax(ad, cuda_sht.adjoint_legendre_plain(otf64, Gn,
                                                                 Gs))
            del otf64
            # times: warm-up, then plain, kernel, kernel, plain
            k_syn = lambda: cuda_sht.synth_legendre(otf, alm, nh)
            p_syn = lambda: cuda_sht.synth_legendre_plain(otf, alm, nh)
            k_adj = lambda: cuda_sht.adjoint_legendre(otf, Gn, Gs)
            p_adj = lambda: cuda_sht.adjoint_legendre_plain(otf, Gn, Gs)
            t = {}
            for name, k, p in (("synth", k_syn, p_syn),
                               ("adjoint", k_adj, p_adj)):
                k()
                p()
                tp1, tk1, tk2, tp2 = timer(p), timer(k, 3), timer(k, 3), \
                    timer(p)
                t[name] = ((tk1 + tk2) / 2, (tp1 + tp2) / 2)
            bound_ms, bound_by = legendre_bound(nside, lmax, mp, batch)
            plan = cuda_sht.adjoint_plan(nh)
            scratch = cuda_sht.adjoint_scratch_bytes(otf, batch)
            say(f"[3] nside {nside} lmax {lmax} mp {mp:+d} batch {batch}: "
                f"synth err {e_syn:.2e} adjoint err {e_adj:.2e} "
                f"adjointness {e_dot:.2e} (vs float64 plain: synth "
                f"{e64_syn:.2e} adjoint {e64_adj:.2e}); ms kernel/plain "
                f"synth {t['synth'][0]:.3f}/{t['synth'][1]:.3f} adjoint "
                f"{t['adjoint'][0]:.3f}/{t['adjoint'][1]:.3f}; bound "
                f"{bound_ms:.3f} ms by {bound_by}; adjoint scratch "
                f"{scratch} bytes ({plan.nslice} slices, cluster "
                f"{plan.cluster}, {plan.npass} pass)")
            if not (e_syn <= TOL and e_adj <= TOL and e_dot <= TOL):
                raise AssertionError(
                    f"kernel disagrees with its plain version at nside "
                    f"{nside} mp {mp}: {e_syn}, {e_adj}, {e_dot}")
            # no single PyTorch call computes an on-the-fly Legendre
            # transform: library_ms is null
            common = dict(nside=nside, lmax=lmax, mp=mp, batch=batch,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None)
            rows[(nside, mp, batch)] = {
                "synth": dict(max_abs_err=max(absmax(Fn, Fn_p),
                                              absmax(Fs, Fs_p)),
                              max_rel_err=e_syn, ms=t["synth"][0],
                              plain_ms=t["synth"][1],
                              share_of_bound=bound_ms / t["synth"][0],
                              **common),
                "adjoint": dict(max_abs_err=absmax(ad, ad_p),
                                max_rel_err=e_adj, ms=t["adjoint"][0],
                                plain_ms=t["adjoint"][1],
                                share_of_bound=bound_ms / t["adjoint"][0],
                                scratch_bytes=scratch, **common),
            }
            del Fn, Fs, ad, Fn_p, Fs_p, ad_p, alm, Gn, Gs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def spin2_phase(dev, nside, lmax, batch=3, f64=True):
    """Phase 4: alm2map_spin2 / alm2map_spin2_adjoint, composed from two
    kernel calls per direction at mp -2 and +2, against the plain
    two-recurrence route alm2map_spin2_otf on the kernels' coefficient
    pack; then <Y a, m> = <a, Yt m> for the T/E/B pair."""
    from commander_tpu_torch.sphere import cuda_sht, sht, sht_otf
    from commander_tpu_torch.sphere.alm import alm_dot

    rng = np.random.default_rng(200 + nside)
    nl, npix = lmax + 1, 12 * nside * nside
    plan = sht.get_plan(nside, lmax, spin2=True, dtype=torch.float32,
                        device=dev)

    def alm(shape):
        a = rng.standard_normal(shape + (nl, nl)) \
            + 1j * rng.standard_normal(shape + (nl, nl))
        a *= np.tril(np.ones((nl, nl)))
        a[..., 0] = a[..., 0].real
        return torch.as_tensor(a.astype(np.complex64), device=dev)

    teb = alm((batch, 3))
    teb[:, 1:, :2] = 0.0
    E, B = teb[:, 1].contiguous(), teb[:, 2].contiguous()
    m = torch.as_tensor(rng.standard_normal((batch, 3, npix))
                        .astype(np.float32), device=dev)
    timer = Timer(dev)
    n0 = dict(cuda_sht.LAUNCHES)
    Q, U = sht.alm2map_spin2(plan, E, B)
    Eh, Bh = sht.alm2map_spin2_adjoint(plan, m[:, 1], m[:, 2])
    used = {k: cuda_sht.LAUNCHES[k] - n0[k] for k in n0}
    want = {"synth": 2, "adjoint": 2} if dev.type == "cuda" \
        else {"synth": 0, "adjoint": 0}
    if used != want:
        raise AssertionError(f"spin-2 transform pair launched {used}, "
                             f"expected {want}")
    plain = lambda: sht_otf.alm2map_spin2_otf(
        plan, cuda_sht.pack_otf(plan.otf_p2), cuda_sht.pack_otf(plan.otf_m2),
        E, B)
    Qp, Up = plain()
    scale = float(torch.maximum(Qp.abs().max(), Up.abs().max()))
    e_syn = max(absmax(Q, Qp), absmax(U, Up)) / scale
    # the composed adjoint is the adjoint of the plain synthesis
    lhs = float(torch.sum(Qp.double() * m[:, 1] + Up.double() * m[:, 2]))
    rhs = float(alm_dot(E.to(torch.complex128), Eh.to(torch.complex128))
                + alm_dot(B.to(torch.complex128), Bh.to(torch.complex128)))
    e_adj = abs(lhs - rhs) / abs(lhs)
    # the T/E/B pair
    lhs = float(torch.sum(sht.alm2map_teb(plan, teb).double() * m))
    rhs = float(alm_dot(teb.to(torch.complex128),
                        sht.alm2map_teb_adjoint(plan, m)
                        .to(torch.complex128)))
    e_teb = abs(lhs - rhs) / abs(lhs)
    t_k = timer(lambda: sht.alm2map_spin2(plan, E, B), 3)
    t_a = timer(lambda: sht.alm2map_spin2_adjoint(plan, m[:, 1], m[:, 2]), 3)
    t_p = timer(plain)
    # what the composition costs around its kernel calls: the Legendre stage
    # as the transforms run it (mask, stack, two calls, flip, cat; zero
    # entries and pads in the adjoint) against the bare calls on ready
    # batches of 2 x batch
    cp, cm = -(E + 1j * B), -(E - 1j * B)
    both = torch.stack([cp, cm])
    Gp, K = (torch.as_tensor(
        (rng.standard_normal((batch, plan.nring, nl)) + 1j
         * rng.standard_normal((batch, plan.nring, nl))).astype(np.complex64),
        device=dev) for _ in range(2))
    G2 = torch.stack([Gp[..., : plan.nh, :], K[..., : plan.nh, :]])
    t_stage = (
        timer(lambda: sht._legendre_synth_spin2_otf(plan, cp, cm), 3),
        timer(lambda: [sht_otf.synth_legendre_otf(o, both, plan.nh)
                       for o in (plan.otf_p2, plan.otf_m2)], 3),
        timer(lambda: sht._legendre_adjoint_spin2_otf(plan, Gp, K), 3),
        timer(lambda: [sht_otf.adjoint_legendre_otf(o, G2, G2)
                       for o in (plan.otf_p2, plan.otf_m2)], 3))
    del both, Gp, K, G2
    line = (f"[4] spin 2 at nside {nside} lmax {lmax} batch {batch}: "
            f"composed vs plain two-recurrence route {e_syn:.2e} of the max;"
            f" composed adjoint vs plain synthesis (adjointness) "
            f"{e_adj:.2e}; T/E/B adjointness {e_teb:.2e}; ms alm2map_spin2 "
            f"{t_k:.2f} (plain route {t_p:.1f}), its adjoint {t_a:.2f}; "
            f"Legendre stage as composed / its two bare kernel calls: "
            f"synthesis {t_stage[0]:.2f} / {t_stage[1]:.2f}, adjoint "
            f"{t_stage[2]:.2f} / {t_stage[3]:.2f}")
    if f64:
        # float64 plain transform on unrounded coefficients: the float32
        # recurrences' own error at mp -2 / +2 (reported, not gated)
        p64 = sht.get_plan(nside, lmax, spin2=True, dtype=torch.float64,
                           device=dev)
        Q64, U64 = sht_otf.alm2map_spin2_otf(
            p64, p64.otf_p2, p64.otf_m2, E.to(torch.complex128),
            B.to(torch.complex128))
        e64 = max(absmax(Q, Q64), absmax(U, U64)) / float(
            torch.maximum(Q64.abs().max(), U64.abs().max()))
        rms64 = float(torch.sqrt(((Q - Q64) ** 2 + (U - U64) ** 2).mean()
                                 / (Q64 ** 2 + U64 ** 2).mean()))
        line += (f"; float32 transform vs float64 plain transform: max "
                 f"{e64:.2e} of the max, rms {rms64:.2e} of the rms")
        del p64, Q64, U64
    say(line)
    if not (e_syn <= TOL and e_adj <= TOL and e_teb <= TOL):
        raise AssertionError(f"spin-2 transform at nside {nside} disagrees "
                             f"with its plain route: {e_syn}, {e_adj}, "
                             f"{e_teb}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def entry_phase(dev, preset, nside, lmax):
    """Phase 5: one Gibbs step of an entry preset on `dev` (float32) against
    the same step in float64 on the CPU, with the same draws."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import gibbs
    from commander_tpu_torch.sphere.alm import random_alm_white

    kw = dict(entry.PRESETS[preset], nside=nside, lmax=lmax)
    plan, sys_d, cfg, _ = entry.build_problem(dtype=torch.float32,
                                              device=dev, **kw)
    plan_c, sys_c, _, _ = entry.build_problem(dtype=torch.float64,
                                              device="cpu", **kw)
    gen = torch.Generator()
    gen.manual_seed(1)
    C, S = sys_c.F.shape[1], sys_c.F.shape[2]
    nbins = len(cfg.cl_cfg.bin_starts)
    draws = {
        "eta1": torch.randn(sys_c.data.shape, generator=gen,
                            dtype=torch.float64),
        "eta2": random_alm_white(gen, (C, S, lmax + 1, lmax + 1)),
        "gamma": torch.as_tensor(np.random.default_rng(2).gamma(
            50.0, size=(C, S, nbins))),
    }
    to_d = {k: v.to(dev, torch.complex64 if v.is_complex()
                    else torch.float32) for k, v in draws.items()}
    st_d = entry.initial_state(cfg, sys_d)
    st_c = entry.initial_state(cfg, sys_c)
    t0 = time.perf_counter()
    new_d = gibbs.gibbs_step(cfg, sys_d, plan, st_d, draws=to_d)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    new_c = gibbs.gibbs_step(dataclasses.replace(cfg, cg_tol=1e-10,
                                                 cg_maxiter=200),
                             sys_c, plan_c, st_c, draws=draws)
    e_a = relmax(new_d.a.cpu(), new_c.a)
    # bins whose modes carry no power (E, B below l = 2) are 0 on both sides
    ref = new_c.cl_bins
    e_cl = float(((new_d.cl_bins.cpu().double() - ref).abs()
                  / ref.abs().clamp(min=1e-30 * float(ref.abs().max())))
                 .max())
    finite = bool(torch.isfinite(torch.view_as_real(new_d.a)).all()
                  and torch.isfinite(new_d.cl_bins).all())
    say(f"[5] {preset} nside {nside} lmax {lmax} (S = {S}): {secs:.3f} s, CG "
        f"iters {new_d.cg_iters} relres {new_d.cg_relres:.2e}; vs CPU "
        f"float64 step: a {e_a:.2e} cl_bins {e_cl:.2e}")
    if not finite or not e_a <= 1e-3 or not e_cl <= 1e-3 \
            or new_d.cg_relres > cfg.cg_tol:
        raise AssertionError(f"{preset} step disagrees with the CPU "
                             f"reference")


def main_path_phase(dev, preset, steps, deep_iters, **overrides):
    """Phase 6: one main path: `steps` Gibbs steps of `preset` from a seeded
    generator, the launch counts set to 0 before them and read after them;
    returns those counts and a dict of what was measured. After the counts
    are read: the reduced chi-square of the last state, and one more step
    with a CG tolerance float32 cannot reach and at most `deep_iters`
    iterations (the solve ends earlier only when its float32 residual is
    exhausted: exactly 0, or too small for the next step): the presets'
    synthetic white data converge in a few iterations, a solve on real maps
    takes 80-100, and this step shows what an iteration costs."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import chisq, gibbs
    from commander_tpu_torch.sphere import cuda_sht

    t0 = time.perf_counter()
    plan, sys_d, cfg, _ = entry.build_preset(preset, torch.float32, dev,
                                             seed=0, **overrides)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = entry.initial_state(cfg, sys_d)
    S = sys_d.F.shape[2]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    say(f"[6] {preset} preset nside {plan.nside} lmax {plan.lmax} bands "
        f"{sys_d.F.shape[0]} comps {sys_d.F.shape[1]} Stokes {S}: set-up "
        f"{time.perf_counter() - t0:.1f} s")
    # wrapper calls per transform: spin 0 alone, or spin 0 and the two
    # spin-2 recurrences (mp -2 and +2)
    per_transform = 3 if S == 3 else 1
    for k in cuda_sht.LAUNCHES:
        cuda_sht.LAUNCHES[k] = 0
    secs_all, mem = [], None
    for step in range(steps):
        n0 = dict(cuda_sht.LAUNCHES)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = gibbs.gibbs_step(cfg, sys_d, plan, state, gen)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs_all.append(time.perf_counter() - t0)
        if dev.type == "cuda":
            mem = torch.cuda.max_memory_allocated() / 2**30
        d_syn = cuda_sht.LAUNCHES["synth"] - n0["synth"]
        d_adj = cuda_sht.LAUNCHES["adjoint"] - n0["adjoint"]
        say(f"[6] {preset} step {step + 1}: {secs_all[-1]:.2f} s, CG iters "
            f"{state.cg_iters}, relres {state.cg_relres:.2e}, peak device "
            f"memory {mem if mem is None else round(mem, 2)} GiB, launches "
            f"synth {d_syn} adjoint {d_adj}, cl_bins[cmb] "
            f"{state.cl_bins[0, :, :4].tolist()}")
        finite = bool(torch.isfinite(torch.view_as_real(state.a)).all()
                      and torch.isfinite(state.cl_bins).all())
        if not finite:
            raise AssertionError("non-finite sampler state")
        if not (state.cg_relres <= cfg.cg_tol
                or state.cg_iters == cfg.cg_maxiter):
            raise AssertionError("CG neither converged nor hit maxiter")
        # one synthesis and one adjoint transform per operator application
        # (CG's initial A(x0) plus one per iteration), one more adjoint
        # transform for the rhs
        n_apply = state.cg_iters + 1
        want = (per_transform * n_apply, per_transform * (n_apply + 1)) \
            if dev.type == "cuda" else (0, 0)
        if (d_syn, d_adj) != want:
            raise AssertionError(f"launch counts {(d_syn, d_adj)} != {want}")
    launches = dict(cuda_sht.LAUNCHES)

    chi2, _, ndof = chisq.compute_chisq(sys_d, plan, state.a)
    red = float(chi2) / int(ndof)
    say(f"[6] {preset}: reduced chi-square of the last state {red:.4f} "
        f"({int(ndof)} unmasked pixels)")
    if not np.isfinite(red):
        raise AssertionError("non-finite chi-square")

    deep = dataclasses.replace(cfg, cg_tol=1e-30, cg_maxiter=deep_iters)
    t0 = time.perf_counter()
    state = gibbs.gibbs_step(deep, sys_d, plan, state, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    per_apply = secs / (state.cg_iters + 1) * 1e3
    say(f"[6] {preset} deep step: {secs:.2f} s with {state.cg_iters} CG "
        f"iterations, relres {state.cg_relres:.2e} ({per_apply:.1f} ms per "
        f"operator application, rhs and C_l draw included)")
    if state.cg_iters < min(10, deep_iters) or not bool(
            torch.isfinite(torch.view_as_real(state.a)).all()):
        raise AssertionError("the deep step did not run its iterations")
    del sys_d, plan, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches, dict(step_s=secs_all, peak_gib=mem, chisq_red=red,
                          deep_ms_per_apply=per_apply)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase at small shapes on the CPU, "
                         "through the plain versions (never reports a gpu)")
    args = ap.parse_args(argv)

    if args.cpu_rehearsal:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; nothing was run",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda")

    import commander_tpu_torch  # noqa: F401  (fails outside the repo)
    from commander_tpu_torch.sphere import cuda_sht

    # [1] the card
    card = card_line() if dev.type == "cuda" else "cpu rehearsal"
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    say(f"[1] {card}; cuda device count {count}; torch {torch.__version__}")

    # [2] build
    if dev.type == "cuda":
        info = cuda_sht.build()
        say(f"[2] kernels built in {info['seconds']:.1f} s")
        for ln in info["ptxas"]:
            say("[2]   " + ln.strip())
        spilled = [ln.strip() for ln in info["ptxas"] if any(
            int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        if spilled:
            raise AssertionError(f"the kernels must build free of register "
                                 f"spills; ptxas said: {spilled}")

    # [3] kernels against their plain versions, the main paths' shapes last
    on_card = dev.type == "cuda"
    big = (1024, 2000) if on_card else (32, 64)
    small = (256, 512) if on_card else (16, 32)
    rows = kernel_phase(dev, [small + ((0, 2, -2), 3), big + ((0,), 3),
                              big + ((-2, 2), 6)])

    # [4] the spin-2 transform composed from the kernels
    spin2_phase(dev, *small)
    spin2_phase(dev, *big)

    # [5] the entry problems against the CPU float64 step
    for preset in ("entry", "entry_pol"):
        entry_phase(dev, preset, *((64, 128) if on_card else (16, 32)))

    # [6] the main paths
    over = {} if on_card else dict(nside=big[0], lmax=big[1])
    paths = {"tutorial": 3, "tutorial_pol": 2}
    launches, measured = {}, {}
    for preset, steps in paths.items():
        launches[preset], measured[preset] = main_path_phase(
            dev, preset, steps, 20 if on_card else 5, **over)
    say("[6] " + json.dumps({"main_paths": measured}))

    # [7] results: each kernel at the shape both paths give it (mp 0, batch
    # 3), its other shapes under by_shape, its launches summed over the
    # main paths and per path
    src = {"synth": ("legendre_synth",
                     "commander_tpu_torch/csrc/legendre_synth.cu",
                     "commander_tpu/sphere/pallas_sht.py:544"),
           "adjoint": ("legendre_adjoint",
                       "commander_tpu_torch/csrc/legendre_adjoint.cu",
                       "commander_tpu/sphere/pallas_sht.py:683")}
    kernels = []
    for k in ("synth", "adjoint"):
        by_path = {preset: launches[preset][k] for preset in paths}
        kernels.append(dict(
            name=src[k][0], route="cuda", source=src[k][1],
            replaces=src[k][2], launches=sum(by_path.values()),
            launches_by_path=by_path,
            launches_per_step={p: by_path[p] / paths[p] for p in paths},
            **rows[(big[0], 0, 3)][k],
            by_shape=[r[k] for key, r in rows.items() if key[0] == big[0]]))
    if on_card and min(n for k in kernels
                       for n in k["launches_by_path"].values()) < 1:
        raise AssertionError("a kernel of a main path never launched")
    say(json.dumps({"kernels": kernels}))
    say(card)
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    platform = "gpu" if dev.type == "cuda" else "cpu"
    print(json.dumps({"ok": True, "device": {"platform": platform,
                                             "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
