"""Smoke run of the PyTorch / CUDA port on one card.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # small shapes, CPU, plain versions

Phases (each prints its lines; any failure raises and the exit code is not 0):
  1. the card: name and power limit (nvidia-smi), device count;
  2. build the CUDA Legendre kernels from commander_tpu_torch/csrc/;
  3. each kernel against its plain torch version on the card, with times:
     nside 256 / lmax 512 at mp 0, +2, -2 and the slice's nside 1024 /
     lmax 2000 at mp 0, batch 3; max |diff| <= 1e-5 max |ref| and
     adjointness to 1e-5;
  4. the entry problem (nside 64 / lmax 128, 3 bands): one Gibbs step on the
     card against the same step in float64 on the CPU, given the same draws;
  5. the main path: the tutorial preset (nside 1024 / lmax 2000, 3 LFI
     bands, 3 components, float32) for 3 Gibbs steps, with the kernels'
     launch counts read around it;
  6. a JSON line of the kernels, the card's name and power limit, and the
     result line {"ok": true, "device": {...}}.
Without a card it stops before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-5


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


def kernel_phase(dev, sizes, batch=3):
    """Phase 3: each kernel against its plain version at each size; returns
    the rows measured at the last (the slice's) size."""
    from commander_tpu_torch.sphere import cuda_sht, sht_otf

    timer = Timer(dev)
    rows = {}
    for nside, lmax, mps in sizes:
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
            say(f"[3] nside {nside} lmax {lmax} mp {mp:+d} batch {batch}: "
                f"synth err {e_syn:.2e} adjoint err {e_adj:.2e} "
                f"adjointness {e_dot:.2e} (vs float64 plain: synth "
                f"{e64_syn:.2e} adjoint {e64_adj:.2e}); ms kernel/plain "
                f"synth {t['synth'][0]:.3f}/{t['synth'][1]:.3f} adjoint "
                f"{t['adjoint'][0]:.3f}/{t['adjoint'][1]:.3f}")
            if not (e_syn <= TOL and e_adj <= TOL and e_dot <= TOL):
                raise AssertionError(
                    f"kernel disagrees with its plain version at nside "
                    f"{nside} mp {mp}: {e_syn}, {e_adj}, {e_dot}")
            rows = {
                "synth": dict(max_abs_err=max(absmax(Fn, Fn_p),
                                              absmax(Fs, Fs_p)),
                              max_rel_err=e_syn, ms=t["synth"][0],
                              plain_ms=t["synth"][1]),
                "adjoint": dict(max_abs_err=absmax(ad, ad_p),
                                max_rel_err=e_adj, ms=t["adjoint"][0],
                                plain_ms=t["adjoint"][1]),
            }
            del Fn, Fs, ad, Fn_p, Fs_p, ad_p, alm, Gn, Gs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def entry_phase(dev, nside, lmax):
    """Phase 4: one Gibbs step of the entry problem on `dev` (float32)
    against the same step in float64 on the CPU, with the same draws."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import gibbs
    from commander_tpu_torch.sphere.alm import random_alm_white

    kw = dict(entry.PRESETS["entry"], nside=nside, lmax=lmax)
    plan, sys_d, cfg, _ = entry.build_problem(dtype=torch.float32,
                                              device=dev, **kw)
    plan_c, sys_c, _, _ = entry.build_problem(dtype=torch.float64, **kw)
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
    e_cl = float(((new_d.cl_bins.cpu().double() - new_c.cl_bins).abs()
                  / new_c.cl_bins.abs()).max())
    finite = bool(torch.isfinite(torch.view_as_real(new_d.a)).all()
                  and torch.isfinite(new_d.cl_bins).all())
    say(f"[4] entry nside {nside} lmax {lmax}: {secs:.3f} s, CG iters "
        f"{new_d.cg_iters} relres {new_d.cg_relres:.2e}; vs CPU float64 "
        f"step: a {e_a:.2e} cl_bins {e_cl:.2e}")
    if not finite or e_a > 1e-3 or e_cl > 1e-3 \
            or new_d.cg_relres > cfg.cg_tol:
        raise AssertionError("entry step disagrees with the CPU reference")


def main_path_phase(dev, steps, **overrides):
    """Phase 5: the tutorial preset, `steps` Gibbs steps from a seeded
    generator; returns the launch counts of the whole run."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import gibbs
    from commander_tpu_torch.sphere import cuda_sht

    t0 = time.perf_counter()
    plan, sys_d, cfg, _ = entry.build_preset("tutorial", torch.float32, dev,
                                             seed=0, **overrides)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = entry.initial_state(cfg, sys_d)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    say(f"[5] tutorial preset nside {plan.nside} lmax {plan.lmax} bands "
        f"{sys_d.F.shape[0]} comps {sys_d.F.shape[1]}: set-up "
        f"{time.perf_counter() - t0:.1f} s")
    for k in cuda_sht.LAUNCHES:
        cuda_sht.LAUNCHES[k] = 0
    for step in range(steps):
        n0 = dict(cuda_sht.LAUNCHES)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = gibbs.gibbs_step(cfg, sys_d, plan, state, gen)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        mem = torch.cuda.max_memory_allocated() / 2**30 \
            if dev.type == "cuda" else float("nan")
        d_syn = cuda_sht.LAUNCHES["synth"] - n0["synth"]
        d_adj = cuda_sht.LAUNCHES["adjoint"] - n0["adjoint"]
        say(f"[5] step {step + 1}: {secs:.2f} s, CG iters {state.cg_iters}, "
            f"relres {state.cg_relres:.2e}, peak device memory {mem:.2f} "
            f"GiB, launches synth {d_syn} adjoint {d_adj}, cl_bins[cmb] "
            f"{state.cl_bins[0, 0, :4].tolist()}")
        finite = bool(torch.isfinite(torch.view_as_real(state.a)).all()
                      and torch.isfinite(state.cl_bins).all())
        if not finite:
            raise AssertionError("non-finite sampler state")
        if not (state.cg_relres <= cfg.cg_tol
                or state.cg_iters == cfg.cg_maxiter):
            raise AssertionError("CG neither converged nor hit maxiter")
        # one synthesis and one adjoint per operator application (CG's
        # initial A(x0) plus one per iteration), one more adjoint for the rhs
        n_apply = state.cg_iters + 1
        want = (n_apply, n_apply + 1) if dev.type == "cuda" else (0, 0)
        if (d_syn, d_adj) != want:
            raise AssertionError(f"launch counts {(d_syn, d_adj)} != {want}")
    return dict(cuda_sht.LAUNCHES)


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

    # [3] kernels against their plain versions
    if dev.type == "cuda":
        sizes = [(256, 512, (0, 2, -2)), (1024, 2000, (0,))]
    else:
        sizes = [(16, 32, (0, 2, -2)), (32, 64, (0,))]
    rows = kernel_phase(dev, sizes)

    # [4] the entry problem against the CPU float64 step
    entry_phase(dev, *((64, 128) if dev.type == "cuda" else (16, 32)))

    # [5] the main path
    if dev.type == "cuda":
        launches = main_path_phase(dev, steps=3)
    else:
        launches = main_path_phase(dev, steps=2, nside=32, lmax=64)

    # [6] results
    src = {"synth": ("legendre_synth",
                     "commander_tpu_torch/csrc/legendre_synth.cu",
                     "commander_tpu/sphere/pallas_sht.py:544"),
           "adjoint": ("legendre_adjoint",
                       "commander_tpu_torch/csrc/legendre_adjoint.cu",
                       "commander_tpu/sphere/pallas_sht.py:683")}
    kernels = [dict(name=src[k][0], route="cuda", source=src[k][1],
                    replaces=src[k][2], launches=launches[k], **rows[k])
               for k in ("synth", "adjoint")]
    if dev.type == "cuda" and min(k["launches"] for k in kernels) < 1:
        raise AssertionError("a kernel of the main path never launched")
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
