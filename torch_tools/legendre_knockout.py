"""Knock-out timing of the CUDA Legendre kernels on one card.

Where no kernel profiler runs, a kernel's time is attributed by building it
again with one part removed and timing the rest. The shipped sources carry no
switch for that: for each variant this script copies the package found under
--root into a work directory (build/knockout/<variant>/ by default, which
.gitignore lists), rewrites the copy's csrc/ with the replacements listed in
PATCHES, and builds and times the copy in a process of its own. A replacement
whose text is not found exactly once stops the run, so the list cannot drift
from the sources unnoticed.

  no_contract    the 2 FMAs per batch entry become one add per ring-step
  no_recurrence  lamhat is a constant; no three-term recurrence, and so no
                 use of its coefficients
  no_loads       coefficients (and alm) of the first tile's first ell are
                 used for every ell: no staging, no per-ell reads
  no_rescale     a chain that outgrows 2^30 is not divided (it overflows)
  no_reduce      (adjoint) the warps still leave their sums in shared memory,
                 but no barrier, no sum across warps or blocks, no partial
                 rows
  no_rmw         (adjoint) the sums across warps and blocks stay; nothing is
                 written to the partial rows

A knocked-out kernel computes something else; only its time means anything.

    python3 torch_tools/legendre_knockout.py [--root DIR] [--work DIR] \
        [--nside 1024 --lmax 2000 --batch 3] [--variants base,no_loads] \
        [--out FILE] [--sass DIR]

Prints one JSON line per variant: ms per call of each kernel (CUDA events,
mean of --reps launches after a warm-up), with the card's name and power
limit. `--variants base` times any checkout of the package as it is. --sass
writes `cuobjdump -sass` of the unmodified build there.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys

COMMON, SYNTH, ADJOINT = ("legendre_common.cuh", "legendre_synth.cu",
                          "legendre_adjoint.cu")

_NO_CONTRACT = [
    (SYNTH, """#pragma unroll
          for (int b = 0; b < NB; ++b) {
            acc[par][b][k].x = fmaf(lam, a[b].x, acc[par][b][k].x);
            acc[par][b][k].y = fmaf(lam, a[b].y, acc[par][b][k].y);
          }
""", "          acc[par][0][k].x += lam + a[0].x;\n"),
    (ADJOINT, """#pragma unroll
        for (int b = 0; b < NB; ++b) {
          s[b].x = fmaf(lam, g[par][b][k].x, s[b].x);
          s[b].y = fmaf(lam, g[par][b][k].y, s[b].y);
        }
""", "        s[0].x += lam + g[par][0][k].x;\n"),
]
_NO_LOADS = [
    (COMMON, "const int row = h + i;", "const int row = 0;"),
    (SYNTH, "const int nx = i2 + par + 1;", "const int nx = 0;"),
    (SYNTH, """    cp_async_wait_all();
    __syncthreads();  // tile t has landed; everyone is done with tile t-1
    if (t + 1 < ntile) {
      off += (size_t)LT * nm;
      stage_tile<NB>(tile[(t + 1) & 1], A, Bc, beta, alm, off, lt + LT, nl,
                     nm);
    }
    const SynthTile<NB>& cur = tile[t & 1];
""", """    if (t == 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    const SynthTile<NB>& cur = tile[0];
"""),
    (ADJOINT, "const int nx = i + 1;", "const int nx = 0;"),
    (ADJOINT, """      cp_async_wait_all();
      __syncthreads();  // tile t has landed; everyone is done with tile t-1
      if (t + 1 < ntile) {
        off += (size_t)LT * nm;
        stage_coef(coef_buf[(t + 1) & 1], A, Bc, beta, off, lt + LT, nl, nm);
        cp_async_commit();
      }
      const float (*coef)[3][TM] = coef_buf[t & 1];
""", """      if (t == 0) {
        cp_async_wait_all();
        __syncthreads();
      }
      const float (*coef)[3][TM] = coef_buf[0];
"""),
]
_LAST_SYNC = ("  cluster.sync();  // no block leaves while its sums may "
              "still be read\n")

# variant -> [(file under csrc/, text found exactly once, its replacement)]
PATCHES = {
    "base": [],
    "no_contract": _NO_CONTRACT,
    "no_recurrence": [
        (COMMON, "return __fmul_rn(c.cur[k], c.scl[k]);", "return c.x[k];"),
        (COMMON, "  bool grow = false;\n", "  return;\n  bool grow = false;\n"),
        (COMMON, """  const int tx = threadIdx.x;
  for (int h = 0; h < LT; h += DEEP_RUN) {
""", """  return;
  const int tx = threadIdx.x;
  for (int h = 0; h < LT; h += DEEP_RUN) {
"""),
    ],
    "no_loads": _NO_LOADS,
    "no_contract_no_loads": _NO_CONTRACT + _NO_LOADS,
    "no_rescale": [
        (COMMON, "  if (grow) {\n",
         "  if (grow) c.live = 1u;\n  if (false) {\n"),
        (COMMON, "while (fabsf(c.cur[k]) > BIG) {", "while (false) {"),
    ],
    "no_reduce": [
        (ADJOINT, "        __syncthreads();\n        // level 2:",
         "        if (false) {\n        __syncthreads();\n        // level 2:"),
        (ADJOINT, "        pw ^= 1;\n", "        pw ^= 1;\n        }\n"),
        (ADJOINT, "      cluster.sync();\n",
         "      if (false) {\n      cluster.sync();\n"),
        (ADJOINT, "      pb ^= 1;\n", "      pb ^= 1;\n      }\n"),
        (ADJOINT, _LAST_SYNC, ""),
    ],
    "no_rmw": [
        (ADJOINT, "  int pw = 0, pb = 0;",
         "  float keep = 0.0f;\n  int pw = 0, pb = 0;"),
        (ADJOINT, """          float2* o = out + b * lm_stride + (size_t)l * nm + m;
          if (pass > 0) {
            const float2 old = *o;
            v = make_float2(old.x + v.x, old.y + v.y);
          }
          *o = v;
""", "          keep += v.x + v.y;\n"),
        (ADJOINT, _LAST_SYNC, _LAST_SYNC + """  if (keep == 12345.678f)
    out[(size_t)lstart * nm + m] = make_float2(keep, keep);
"""),
    ],
}


def make_variant(root: str, work: str, name: str) -> str:
    """Copy root's package into work/<name>/ and apply the variant's
    replacements to the copy's csrc/; returns the copy's root."""
    dst = os.path.join(work, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "commander_tpu_torch"),
                    os.path.join(dst, "commander_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in PATCHES[name]:
        path = os.path.join(dst, "commander_tpu_torch", "csrc", fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {fname} holds this text "
                             f"{text.count(old)} times, not once:\n{old}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def _worker(args) -> dict:
    """Build and time the package under args.root as it is."""
    sys.path.insert(0, args.root)
    import numpy as np
    import torch
    from commander_tpu_torch.sphere import cuda_sht, sht_otf

    if not torch.cuda.is_available():
        raise SystemExit("legendre_knockout: needs a CUDA card")
    dev = torch.device("cuda")
    info = cuda_sht.build()
    nl, nh = args.lmax + 1, 2 * args.nside
    rng = np.random.default_rng(0)
    c64 = lambda shape: torch.as_tensor(
        (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
        .astype(np.complex64), device=dev)
    alm = c64((args.batch, nl, nl)) * torch.tril(
        torch.ones((nl, nl), device=dev))
    Gn, Gs = c64((args.batch, nh, nl)), c64((args.batch, nh, nl))
    otf = sht_otf.legendre_otf(args.nside, args.lmax, args.mp, torch.float32,
                               device=dev)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / args.reps

    row = {
        "variant": args.one,
        "synth_ms": ms(lambda: cuda_sht.synth_legendre(otf, alm, nh)),
        "adjoint_ms": ms(lambda: cuda_sht.adjoint_legendre(otf, Gn, Gs)),
        "ptxas": [ln.strip() for ln in info.get("ptxas", [])],
    }
    if args.sass and args.one == "base":
        os.makedirs(args.sass, exist_ok=True)
        for so in glob.glob(os.path.join(args.root, "build",
                                         "commander_tpu_torch", "*.so")):
            out = subprocess.run(["cuobjdump", "-sass", so],
                                 capture_output=True, text=True)
            name = os.path.basename(so).rsplit("_", 1)[0] + ".sass"
            with open(os.path.join(args.sass, name), "w") as f:
                f.write(out.stdout or out.stderr)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--root", default=here,
                    help="directory that holds the commander_tpu_torch "
                         "package to copy (default: this checkout)")
    ap.add_argument("--work", default=None,
                    help="where the copies go (default: "
                         "<this checkout>/build/knockout)")
    ap.add_argument("--nside", type=int, default=1024)
    ap.add_argument("--lmax", type=int, default=2000)
    ap.add_argument("--mp", type=int, default=0)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", default=",".join(PATCHES))
    ap.add_argument("--out", default=None, help="also append the lines here")
    ap.add_argument("--sass", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.root = os.path.abspath(args.root)

    if args.one is not None:
        print("KO_ROW " + json.dumps(_worker(args)), flush=True)
        return 0

    work = os.path.abspath(args.work or os.path.join(here, "build",
                                                     "knockout"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    failed = 0
    for name in args.variants.split(","):
        copy = make_variant(args.root, work, name)
        cmd = [sys.executable, os.path.abspath(__file__), "--one", name,
               "--root", copy, "--nside", str(args.nside), "--lmax",
               str(args.lmax), "--mp", str(args.mp), "--batch",
               str(args.batch), "--reps", str(args.reps)]
        if args.sass:
            cmd += ["--sass", os.path.abspath(args.sass)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        rows = [ln[7:] for ln in proc.stdout.splitlines()
                if ln.startswith("KO_ROW ")]
        if proc.returncode != 0 or not rows:
            print(f"variant {name} failed:\n{proc.stdout[-2000:]}"
                  f"{proc.stderr[-4000:]}", flush=True)
            failed += 1
            continue
        row = dict(json.loads(rows[0]), card=card, root=args.root,
                   nside=args.nside, lmax=args.lmax, mp=args.mp,
                   batch=args.batch)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
