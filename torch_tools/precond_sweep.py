"""Solve one amplitude system of the iteration from TOD with each CG
preconditioner, on one card.

    python3 torch_tools/precond_sweep.py [--preset tutorial_tod] \
        [--lmax-lowl 8 16 32] [--tol 1e-6] [--maxiter 400] [--out FILE]
    python3 torch_tools/precond_sweep.py --cpu-rehearsal   # small, CPU

Builds the preset (simulated TOD), takes the warm start (one amplitude step,
three TOD passes) and one TOD pass whose binned maps replace the data, then
fixes one system (the start values' mixing, the warm state's C_ell) and one
right-hand side (one eta1, eta2 draw). That rhs is solved by preconditioned
CG with the diagonal preconditioner, the pseudo-inverse one, and the low-ell
block at each --lmax-lowl (inverted in the system's float32, as the port
does, and, for the record, in float64). Per solve: CG iterations, final
relres and the true residual |b - A x| / |b|, the preconditioner's build
ms and the solve's s (CUDA events), ms per iteration, peak device memory,
and the largest difference of its amplitudes from the diagonal solve's
(relative to their max); per low-ell block its size and its inverse's
largest error against the float64 inverse of the same block (relative to
its max). Prints one JSON object with the card's name and power limit, and
writes it to --out (default build/precond_sweep.json). Without a card
it stops (use --cpu-rehearsal to run it at nside 32 on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from functools import partial


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tutorial_tod")
    ap.add_argument("--lmax-lowl", type=int, nargs="*", default=[8, 16, 32])
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=400)
    ap.add_argument("--out", default=os.path.join("build",
                                                  "precond_sweep.json"))
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="nside 32 / lmax 64 with little TOD, on the CPU")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    from commander_tpu_torch import entry
    from commander_tpu_torch.ops.cg import pcg
    from commander_tpu_torch.sampling import amplitude as amp
    from commander_tpu_torch.sampling import chisq, full_gibbs, gibbs
    from commander_tpu_torch.sampling import tod_gibbs
    from commander_tpu_torch.sphere.alm import alm_dot

    if args.cpu_rehearsal:
        dev = torch.device("cpu")
        over = dict(nside=32, lmax=64, tod=dict(
            entry.PRESETS[args.preset]["tod"], nscan=6, ntod=2048))
        card = "cpu rehearsal"
    else:
        if not torch.cuda.is_available():
            print("precond_sweep: no CUDA device; nothing was run",
                  file=sys.stderr)
            return 2
        dev, over, card = torch.device("cuda"), {}, _card_line()
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def timed(fn):
        """(fn(), ms): CUDA events on the card, the host clock on the CPU."""
        if not on_card:
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    t0 = time.perf_counter()
    pb = entry.build_preset(args.preset, torch.float32, dev, seed=0, **over)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sys0 = full_gibbs.system_at(pb.sys, pb.comps, pb.bps, pb.slots,
                                pb.thetas0)
    bands, state = tod_gibbs.tod_burnin(pb.cfg, pb.bands, sys0, pb.plan,
                                        entry.prior_state(pb.cfg, pb.sys),
                                        gen)
    sky = chisq.sky_signal(sys0, pb.plan, state.a)
    bands, base = tod_gibbs.tod_pass(bands, pb.sys, sky, True, gen)
    del sky, sys0, bands
    # the system gibbs_step solves at the warm state (gibbs.py)
    sys_s = full_gibbs.system_at(base, pb.comps, pb.bps, pb.slots,
                                 pb.thetas0)
    cl = gibbs.eval_cl_all(pb.cfg, sys_s, state.cl_bins)
    if sys_s.ell_mask is not None:
        cl = cl * sys_s.ell_mask
    sys_s = dataclasses.replace(sys_s, cl=cl)
    rhs = amp.compute_rhs(sys_s, pb.plan, gen)
    bnorm = float(torch.sqrt(alm_dot(rhs, rhs)))
    A = partial(amp.apply_A, sys_s, pb.plan)
    sync()
    setup_s = time.perf_counter() - t0
    solved = float((base.inv_rms[:, 0] > 0).double().mean())
    print(f"[sweep] {args.preset} nside {pb.plan.nside} lmax {pb.plan.lmax}:"
          f" set-up {setup_s:.1f} s (simulator {pb.sim_seconds:.1f} s), "
          f"{solved:.3f} of the pixels solved", flush=True)

    lowl_inverses = {}

    def lowl_float64(L):
        """The low-ell preconditioner with the block inverted in float64,
        for the record, and the system dtype's inverse's error against it."""
        M = amp.lowl_block(sys_s, L)
        inv = torch.linalg.inv_ex(M).inverse
        inv64 = torch.linalg.inv_ex(M.double()).inverse
        lowl_inverses[L] = dict(
            n=int(M.shape[0]),
            inv_err=float((inv.double() - inv64).abs().max()
                          / inv64.abs().max()))
        return amp._lowl_apply(sys_s, L, inv64,
                               amp.build_preconditioner(sys_s, pb.plan))

    runs = [("diagonal", lambda: amp.build_precond(sys_s, pb.plan)),
            ("pseudoinv", lambda: amp.build_precond(sys_s, pb.plan,
                                                    "pseudoinv"))]
    for L in args.lmax_lowl:
        runs.append((f"lowl{L}", partial(amp.build_precond, sys_s, pb.plan,
                                         lowl_lmax=L)))
        runs.append((f"lowl{L}_float64_inverse", partial(lowl_float64, L)))
    results, a_diag = {}, None
    for name, build in runs:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        M, build_ms = timed(build)
        res, solve_ms = timed(lambda: pcg(A, rhs, M_inv=M, dot=alm_dot,
                                          tol=args.tol, maxiter=args.maxiter))
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
        a = amp._sqrtS(sys_s, res.x)
        r = rhs - A(res.x)
        true_res = float(torch.sqrt(alm_dot(r, r))) / bnorm
        if a_diag is None:
            a_diag = a
        diff = float((a - a_diag).abs().max() / a_diag.abs().max())
        results[name] = dict(
            iters=res.iters, relres=res.rel_res, converged=res.converged,
            true_relres=true_res, build_ms=build_ms, solve_s=solve_ms / 1e3,
            ms_per_iter=solve_ms / max(res.iters, 1), peak_gib=peak,
            max_diff_from_diagonal=diff)
        print(f"[sweep] {name}: " + json.dumps(results[name]), flush=True)
        del M, res, a, r
    for L, d in lowl_inverses.items():
        results[f"lowl{L}"].update(block_size=d["n"],
                                   inverse_err_vs_float64=d["inv_err"])
    out = dict(preset=args.preset, card=card, device=str(dev),
               nside=pb.plan.nside, lmax=pb.plan.lmax, tol=args.tol,
               maxiter=args.maxiter, solved_fraction=solved,
               setup_s=setup_s, solves=results)
    line = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(card)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
