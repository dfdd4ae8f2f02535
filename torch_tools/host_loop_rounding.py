"""How far the card's float32 transforms move a float64 host-loop chain,
measured on the CPU.

    python3 torch_tools/host_loop_rounding.py [--nside 32] [--niter 2] \
        [--config te_resample|pixreg_smoothing] [--threads 4]

The card's float64 route runs the Legendre stage in the float32 kernels
(cuda_sht casts complex128 to complex64 and back). This runs the program
(param_tutorial_full.txt --synthetic --pol --pixind --COMP_LMAX_IND02=100
and the configuration's keys, chip_smoke.py's HOST_SMALL) twice on the
CPU in float64 with the same draws: once plain, once with every Legendre
synthesis and adjoint's input and output rounded to complex64, as that
route rounds them. Per sample and component it prints the largest
difference of the alms (relative to their max) and of each theta map, the
multipole where the alms differ most, and both chi^2.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CONFIGS = {
    "te_resample": ["--te-cl", "--RESAMPLE_CMB=.true.",
                    "--COMP_BETA_POLTYPE03=2"],
    "pixreg_smoothing": ["--ALMSAMP_PIXREG=.true.",
                         "--COMP_BETA_NUM_PIXREG02=12",
                         "--COMP_BETA_SMOOTHING_SCALE03=1",
                         "--NUM_SMOOTHING_SCALES=1",
                         "--SMOOTHING_SCALE_FWHM01=600",
                         "--SMOOTHING_SCALE_FWHM_POSTPROC01=300",
                         "--SMOOTHING_SCALE_NSIDE01=8",
                         "--SMOOTHING_SCALE_LMAX01=16"]}


def _rounded(fn):
    c64 = lambda x: x.to(torch.complex64).to(x.dtype)

    def f(otf, *args):
        out = fn(otf, *(c64(a) if isinstance(a, torch.Tensor) else a
                        for a in args))
        return tuple(c64(o) for o in out) if isinstance(out, tuple) \
            else c64(out)
    return f


def main(argv=None) -> int:
    from commander_tpu_torch import run
    from commander_tpu_torch.io.chain import ChainFile
    from commander_tpu_torch.sphere import cuda_sht

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nside", type=int, default=32)
    ap.add_argument("--niter", type=int, default=2)
    ap.add_argument("--config", choices=sorted(CONFIGS),
                    default="te_resample")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    argv_run = ["param_tutorial_full.txt", "--synthetic", "--pol", "--cpu",
                "--nside", str(args.nside), "--lmax", str(2 * args.nside),
                "--niter", str(args.niter), "--pixind",
                "--COMP_LMAX_IND02=100"] + CONFIGS[args.config]
    paths = {}
    plain = (cuda_sht.synth_legendre_plain, cuda_sht.adjoint_legendre_plain)
    for mode in ("plain", "rounded"):
        if mode == "rounded":
            cuda_sht.synth_legendre_plain = _rounded(plain[0])
            cuda_sht.adjoint_legendre_plain = _rounded(plain[1])
        out = os.path.join("build", f"host_loop_rounding_{mode}")
        shutil.rmtree(out, ignore_errors=True)
        try:
            (res,) = run.main(argv_run + ["--outdir", out],
                              rng_device="cpu")
        finally:
            (cuda_sht.synth_legendre_plain,
             cuda_sht.adjoint_legendre_plain) = plain
        paths[mode] = res.chain_path
    print(f"[host_loop_rounding] {' '.join(argv_run)}")
    with ChainFile(paths["plain"], "r") as ca, \
            ChainFile(paths["rounded"], "r") as cb:
        for i in range(1, args.niter + 1):
            sa, sb = ca.read_sample(i), cb.read_sample(i)
            for c, x in sa["comps"].items():
                y = sb["comps"][c]
                d = np.abs(x["alm"] - y["alm"])
                msg = [f"alm {d.max() / np.abs(x['alm']).max():.2e} (worst "
                       f"ell {int(np.argmax(d.max(axis=(0, 2))))})"]
                msg += [f"{k} {np.abs(x[k] - y[k]).max():.3e}" for k in x
                        if k.startswith("theta_map")]
                print(f"[host_loop_rounding] sample {i} {c}: "
                      + ", ".join(msg))
            print(f"[host_loop_rounding] sample {i} chi2 "
                  f"{float(sa['aux']['chisq']):.10g} plain, "
                  f"{float(sb['aux']['chisq']):.10g} rounded")
    return 0


if __name__ == "__main__":
    sys.exit(main())
