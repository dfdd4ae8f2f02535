"""How fast a free chain of a whole-iteration preset moves toward its truth.

    python3 torch_tools/chain_drift.py [--preset fullgibbs] [--nside 16] \
        [--lmax 32] [--steps 40] [--device cpu] [--dtype float64]

Builds the preset's simulated sky at the given size, takes --steps
full_gibbs_step calls from the start values with a seeded generator and
prints one JSON object: per step the distance of every index from its truth
in grid steps and the reduced chi-square of the state at its own indices,
and the same chi-square for the true amplitudes at the true indices. A chain
whose distances shrink by a small, steady amount per step while chi-square
stays near its value at the truth mixes slowly (each index draw is made at
amplitudes that were drawn at the previous indices); one whose distances do
not shrink at all is not constrained by the data.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="fullgibbs")
    ap.add_argument("--nside", type=int, default=16)
    ap.add_argument("--lmax", type=int, default=32)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", default="float64",
                    choices=("float32", "float64"))
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import chisq, full_gibbs

    pb = entry.build_preset(args.preset, getattr(torch, args.dtype),
                            args.device, nside=args.nside, lmax=args.lmax)
    hs = [(s.cfg.grid_max - s.cfg.grid_min) / (s.cfg.ngrid - 1)
          for s in pb.slots]
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)

    def chi2_red(sys_at, a):
        chi2, _, ndof = chisq.compute_chisq(sys_at, pb.plan, a)
        return float(chi2) / int(ndof)

    truth = torch.tensor(pb.theta_true, dtype=torch.float64,
                         device=args.device)
    out = dict(preset=args.preset, nside=args.nside, lmax=args.lmax,
               dtype=args.dtype, device=args.device,
               theta_true=list(pb.theta_true), theta0=pb.thetas0.tolist(),
               chisq_red_at_truth=chi2_red(full_gibbs.system_at(
                   pb.sys, pb.comps, pb.bps, pb.slots, truth), pb.a_true),
               steps=[])
    state, thetas = entry.initial_state(pb.cfg, pb.sys), pb.thetas0
    for _ in range(args.steps):
        state, thetas, sys_new = full_gibbs.full_gibbs_step(
            pb.cfg, pb.comps, pb.bps, pb.slots, pb.sys, pb.plan, state,
            thetas, gen, beam_consistent=pb.beam_consistent)
        out["steps"].append(dict(
            grid_steps_from_truth=[round((t - tt) / h, 2) for t, tt, h in zip(
                thetas.tolist(), pb.theta_true, hs)],
            cg_iters=state.cg_iters,
            chisq_red=round(chi2_red(sys_new, state.a), 4)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
