"""Run the program's host loop at full width in several configurations, on
one card, and report each run by attempt.

    python3 torch_tools/host_loop_runs.py [--niter 2] [--limit 300] \
        [--out FILE] [--only NAME ...]
    python3 torch_tools/host_loop_runs.py --cpu-rehearsal   # nside 16, CPU

The command is param_tutorial_full.txt --synthetic --pol --pixind
--COMP_LMAX_IND02=100 at the file's nside 1024 / lmax 2000, through
run.main as a user runs it, in these configurations:

  f32_whole    --f32, the file's whole 8-component model;
  f64_whole    float64 (the Legendre kernels in float32 through their cast
               route, everything else in float64), the whole model;
  f32_three    --f32, cmb, synch and dust with the template and source rows
               (float32 converges there: no more components than bands).

Each run must end within --limit seconds: an attempt started after that
stops the run (a chain that keeps rejecting) and the run is reported as
cut. Per attempt: accepted or rejected, s/step, CG iterations, relres, the
index phase by parameter; per run: seconds, peak device memory and ms per
operator application of the last system (under F_pix and at its scalar
mean F, CUDA events). Prints one JSON object with the card's name and
power limit, and writes it to --out (default build/host_loop_runs.json).
Without a card it stops (use --cpu-rehearsal).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

BASE = ["param_tutorial_full.txt", "--synthetic", "--pol", "--pixind",
        "--COMP_LMAX_IND02=100"]
THREE = ["--INCLUDE_COMP06=.false.", "--INCLUDE_COMP07=.false."]
CONFIGS = {"f32_whole": ["--f32"], "f64_whole": [],
           "f32_three": ["--f32"] + THREE}


class _Cut(Exception):
    pass


def run_one(name, argv, limit, dev):
    """One run of run.main(argv) with an attempt started after `limit`
    seconds stopping it. Returns its report."""
    from chip_smoke import Timer
    from commander_tpu_torch import run as trun
    from commander_tpu_torch.driver import loop
    from commander_tpu_torch.sampling import joint

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    real = loop.host_phase
    seen = []

    def guarded(*a, **k):
        if time.perf_counter() - t0 > limit:
            raise _Cut()
        out = real(*a, **k)
        seen.append(a[-1])              # the attempt's record
        return out

    t0 = time.perf_counter()
    loop.host_phase = guarded
    res, cut = None, False
    try:
        (res,) = trun.main(argv)
    except _Cut:
        cut = True
    finally:
        loop.host_phase = real
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    attempts = [dict(ok=r.get("ok"), seconds=r.get("seconds"),
                     cg_iters=r.get("cg_iters"), cg_relres=r.get("cg_relres"),
                     index_s={f"{ci}.{j}": v["seconds"]
                              for (ci, j), v in r.get("specind", {}).items()})
                for r in seen]
    ms = None
    if res is not None:
        timer, m, st = Timer(dev), res.model, res.state
        x = joint.JointState(a=st.a, t=st.t, p=st.p)
        ms = {}
        for key, sys_ in (("F_pix", res.sys),
                          ("scalar_F", dataclasses.replace(res.sys,
                                                           F_pix=None))):
            f = lambda: joint.apply_A_joint(sys_, m.plan, m.ts, m.ps, x)
            f()
            ms[key] = timer(f, 3)
    rep = dict(name=name, argv=argv, cut=cut, seconds=secs, peak_gib=peak,
               attempts=attempts, ms_per_apply=ms,
               timers=None if res is None else res.timer.acc)
    print(f"[host_loop_runs] {json.dumps(rep)}", flush=True)
    del res
    if on_card:
        torch.cuda.empty_cache()
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--niter", type=int, default=2)
    ap.add_argument("--limit", type=float, default=300.0)
    ap.add_argument("--out", default="build/host_loop_runs.json")
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--cpu-rehearsal", action="store_true")
    args = ap.parse_args(argv)
    if args.cpu_rehearsal:
        dev, extra, card = torch.device("cpu"), ["--cpu", "--nside", "16",
                                                 "--lmax", "32"], "cpu"
    else:
        if not torch.cuda.is_available():
            print("host_loop_runs: no CUDA device", file=sys.stderr)
            return 2
        from chip_smoke import card_line
        from commander_tpu_torch.sphere import cuda_sht
        dev, extra, card = torch.device("cuda"), [], card_line()
        cuda_sht.build()
    out = {"card": card, "runs": []}
    for name, opts in CONFIGS.items():
        if args.only and name not in args.only:
            continue
        d = os.path.join("build", f"host_loop_runs_{name}")
        shutil.rmtree(d, ignore_errors=True)
        out["runs"].append(run_one(
            name, BASE + opts + extra + ["--niter", str(args.niter),
                                         "--outdir", d], args.limit, dev))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
