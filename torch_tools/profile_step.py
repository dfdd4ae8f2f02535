"""Profile Gibbs steps of a preset on one card: device time by kernel, the
device's idle share, peak device memory.

    python3 torch_tools/profile_step.py [--preset tutorial] \
        [--warmup 2] [--cg-iters N] [--out FILE]

Builds the preset on the card, takes --warmup steps, then one step under
torch.profiler (CPU and CUDA activities). With --cg-iters the profiled
step's CG gets a tolerance float32 cannot reach and at most that many
iterations, nearer the depth of a solve on real maps; without it the
preset's own tolerance decides. A preset of the whole Gibbs iteration
(tutorial_full, fullgibbs: entry.build_preset returns a FullProblem with
index slots) is stepped with full_gibbs_step, theta carried from step to
step. Prints one JSON object: the step's host
seconds with and without the profiler, CG iterations, device milliseconds by
kernel group and their shares, the idle share (1 - device ms / host span)
and the peak device memory of the step, with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

GROUPS = (
    ("adjoint_kernel", "legendre adjoint kernel"),
    ("synth_kernel", "legendre synthesis kernel"),
    ("sum_slices", "adjoint slice sum"),
    ("reduce_kernel", "torch reductions (pixel sums, dots)"),
    ("fft", "cuFFT"),
    ("gemm", "GEMM"), ("cutlass", "GEMM"), ("cublas", "GEMM"),
    ("Memcpy", "memcpy / memset"), ("Memset", "memcpy / memset"),
    ("segment_reduce", "segment sums (TOD binning)"),
    ("index_select", "gathers (TOD pointing, binning)"),
    ("indexSelect", "gathers (TOD pointing, binning)"),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tutorial")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--cg-iters", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import (chisq, full_gibbs, gibbs,
                                              tod_gibbs)

    pb = entry.build_preset(args.preset, torch.float32)
    plan, sys_d, cfg = pb[:3]
    full = isinstance(pb, entry.FullProblem)
    tod = full and pb.bands is not None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def advance(cfg, st):
        """One step of the preset's kind; st = (state, thetas, bands,
        base system)."""
        if tod:
            bands, base, state, thetas = tod_gibbs.tod_gibbs_step(
                cfg, pb.comps, pb.bps, pb.slots, st[2], st[3], plan, st[0],
                st[1], generator=gen, beam_consistent=pb.beam_consistent)
            return state, thetas, bands, base
        if not full:
            return gibbs.gibbs_step(cfg, sys_d, plan, st[0], gen), None
        state, thetas, _ = full_gibbs.full_gibbs_step(
            cfg, pb.comps, pb.bps, pb.slots, sys_d, plan, st[0], st[1], gen,
            beam_consistent=pb.beam_consistent)
        return state, thetas

    state = (entry.initial_state(cfg, sys_d), pb.thetas0 if full else None)
    if tod:
        bands, st0 = tod_gibbs.tod_burnin(
            cfg, pb.bands, full_gibbs.system_at(sys_d, pb.comps, pb.bps,
                                                pb.slots, pb.thetas0),
            plan, entry.prior_state(cfg, sys_d), gen)
        state = (st0, pb.thetas0, bands, sys_d)
    for _ in range(args.warmup):
        state = advance(cfg, state)
    if args.cg_iters is not None:
        cfg = dataclasses.replace(cfg, cg_tol=1e-30,
                                  cg_maxiter=args.cg_iters)

    def step(st):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st = advance(cfg, st)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0

    state, plain_s = step(state)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, prof_s = step(state)

    def grouped(prof) -> dict:
        """Device milliseconds by kernel group, largest first."""
        by_group: dict = {}
        for ev in prof.key_averages():
            # kernel rows only: an operator's row repeats its kernels' time
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us <= 0:
                continue
            name = next((g for key, g in GROUPS
                         if key.lower() in ev.key.lower()),
                        "torch elementwise, index, copy, other")
            by_group[name] = by_group.get(name, 0.0) + us / 1e3
        return dict(sorted(by_group.items(), key=lambda kv: -kv[1]))

    by_group = grouped(prof)
    device_ms = sum(by_group.values())
    index_phase = None
    if full:
        # the index phase alone, on the last state
        def indices():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full_gibbs.sample_indices(
                pb.comps, pb.bps, pb.slots, state[3] if tod else sys_d, plan,
                state[0].a,
                state[1], gen, beam_consistent=pb.beam_consistent)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        host_s = indices()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_i:
            prof_i_s = indices()
        g = grouped(prof_i)
        index_phase = {"slots": len(pb.slots), "host_s": host_s,
                       "host_s_profiled": prof_i_s,
                       "device_ms": sum(g.values()),
                       "idle_share": 1.0 - sum(g.values()) / (prof_i_s * 1e3),
                       "ms_by_kernel": g}
    tod_stage = None
    if tod:
        # one TOD pass over the bands on the last state's model sky
        base = state[3]
        sky = chisq.sky_signal(full_gibbs.system_at(
            base, pb.comps, pb.bps, pb.slots, state[1]), plan, state[0].a)

        def tod_pass():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tod_gibbs.tod_pass(state[2], base, sky, False, gen)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        host_s = tod_pass()
        tod_peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_t:
            prof_t_s = tod_pass()
        g = grouped(prof_t)
        tod_stage = {"bands": len(state[2]), "host_s": host_s,
                     "host_s_profiled": prof_t_s,
                     "device_ms": sum(g.values()),
                     "idle_share": 1.0 - sum(g.values()) / (prof_t_s * 1e3),
                     "peak_device_memory_gib": tod_peak,
                     "ms_by_kernel": g}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {
        "preset": args.preset, "card": card, "cg_iters": state[0].cg_iters,
        "theta": state[1].tolist() if full else None,
        "step_s": plain_s, "step_s_profiled": prof_s,
        "device_ms": device_ms,
        "idle_share": 1.0 - device_ms / (prof_s * 1e3),
        "peak_device_memory_gib": peak / 2**30,
        "ms_by_kernel": by_group,
        "share_by_kernel": {k: v / device_ms for k, v in by_group.items()},
        "index_phase": index_phase,
        "tod_stage": tod_stage,
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
