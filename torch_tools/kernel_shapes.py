"""Time the two Legendre kernels at chosen shapes, on one card, beside their
plain versions, their bound and the library call.

    python3 torch_tools/kernel_shapes.py [--nside 1024] [--lmax 2000] \
        [--shape=MP:BATCH ...] [--out FILE]

Each --shape=MP:BATCH (with "=", so that a negative mp is not read as an
option; repeat it for more shapes) is an mp (0, 2 or -2) and a batch; the
default is the pixel-mixing operator's component batch at nside 1024 /
lmax 2000: mp 0 at batch 5 and mp -2, +2 at batch 10 (five components;
spin 2 stacks two coefficient sets). Through chip_smoke.kernel_phase: each kernel against
its plain version (1e-5 of the max, adjointness), CUDA-event times of the
kernel (two 3-call timings) and the plain version (one call), the bound
(chip_smoke.legendre_bound) and the library call (chip_smoke.library_phase:
one torch.bmm against the lambda-hat table, TF32 off). Prints one JSON
object with the card's name and power limit and writes it to --out
(default build/kernel_shapes.json). Without a card it stops.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nside", type=int, default=1024)
    ap.add_argument("--lmax", type=int, default=2000)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--out", default="build/kernel_shapes.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_shapes: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from commander_tpu_torch.sphere import cuda_sht

    cuda_sht.build()
    sizes = []
    for sh in args.shape or ["0:5", "-2:10", "2:10"]:
        mp, batch = (int(x) for x in sh.split(":"))
        sizes.append((args.nside, args.lmax, (mp,), batch, True, True))
    rows = cs.kernel_phase(torch.device("cuda"), sizes)
    out = {"card": cs.card_line(),
           "rows": [dict(shape=f"nside {k[0]} mp {k[1]} batch {k[2]}",
                         **{n: {f: v for f, v in r.items() if f != "library"}
                            for n, r in row.items()})
                    for k, row in rows.items()]}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
