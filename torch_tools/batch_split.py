"""Time how the Legendre wrappers cut a batch into kernel launches.

    python3 torch_tools/batch_split.py [--nside 1024] [--lmax 2000] \
        [--batch 6] [--reps 5] [--out FILE]

The kernels take at most MAX_NB = 4 batch entries per launch, and
cuda_sht.batch_groups decides how a larger batch is cut. This script times
both kernels at mp -2 and +2 on one card with batch_groups replaced, for the
time of the measurement, by each candidate split of the batch (for 6: 4 + 2,
3 + 3, 2 + 2 + 2), in the order A, B, C, C, B, A, and checks that every split
gives the same bits. Prints one JSON object with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def splits(nb: int, max_nb: int):
    """Candidate cuts of nb: greedy (max_nb first), and the even cuts into
    the fewest launches and into one launch more."""
    out = []
    greedy = [max_nb] * (nb // max_nb) + ([nb % max_nb] if nb % max_nb else [])
    out.append(tuple(greedy))
    for n in range(-(-nb // max_nb), -(-nb // max_nb) + 2):
        cut = tuple(nb // n + (i < nb % n) for i in range(n))
        if cut not in out and min(cut) > 0:
            out.append(cut)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nside", type=int, default=1024)
    ap.add_argument("--lmax", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    from commander_tpu_torch.sphere import cuda_sht, sht_otf

    dev = torch.device("cuda")
    nl, nh, nb = args.lmax + 1, 2 * args.nside, args.batch
    cands = splits(nb, cuda_sht.MAX_NB)
    shipped = cuda_sht.batch_groups(nb)
    original = cuda_sht.batch_groups

    def timed(fn):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        fn()
        t0.record()
        for _ in range(args.reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / args.reps

    results = {}
    try:
        for mp in (-2, 2):
            rng = np.random.default_rng(mp + 10)
            c = lambda x: torch.as_tensor(x.astype(np.complex64), device=dev)
            a = rng.standard_normal((nb, nl, nl)) \
                + 1j * rng.standard_normal((nb, nl, nl))
            a *= np.tril(np.ones((nl, nl)))
            a[:, :2] = 0.0
            alm = c(a)
            Gn, Gs = (c(rng.standard_normal((nb, nh, nl))
                        + 1j * rng.standard_normal((nb, nh, nl)))
                      for _ in range(2))
            otf = sht_otf.legendre_otf(args.nside, args.lmax, mp,
                                       torch.float32, device=dev)
            ms = {cut: {"synth": [], "adjoint": []} for cut in cands}
            ref = None
            for cut in cands + cands[::-1]:
                cuda_sht.batch_groups = lambda n, cut=cut: cut
                ms[cut]["synth"].append(timed(
                    lambda: cuda_sht.synth_legendre(otf, alm, nh)))
                ms[cut]["adjoint"].append(timed(
                    lambda: cuda_sht.adjoint_legendre(otf, Gn, Gs)))
                out = (cuda_sht.synth_legendre(otf, alm, nh)
                       + (cuda_sht.adjoint_legendre(otf, Gn, Gs),))
                if ref is None:
                    ref = out
                elif not all(torch.equal(x, y) for x, y in zip(out, ref)):
                    raise AssertionError(f"split {cut} changes the result")
            results[f"mp{mp:+d}"] = {
                "+".join(map(str, cut)): {k: sum(v) / len(v)
                                          for k, v in ms[cut].items()}
                for cut in cands}
    finally:
        cuda_sht.batch_groups = original
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    line = json.dumps({"card": card, "nside": args.nside, "lmax": args.lmax,
                       "batch": nb, "reps": args.reps,
                       "shipped_split": "+".join(map(str, shipped)),
                       "ms_per_call": results})
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
