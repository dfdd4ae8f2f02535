"""How far the card's float32 transforms move a float64 host-loop chain,
measured on the CPU.

    python3 torch_tools/host_loop_rounding.py [--nside 32] [--niter 2] \
        [--config te_resample|pixreg_smoothing|tod_bp_mono_4d] [--threads 4] \
        [--mode rounded|single|moved ...] [--PARAMETER=value ...]

The card's float64 route runs the Legendre stage in the float32 kernels
(cuda_sht casts complex128 to complex64 and back). This runs the program
(param_tutorial_full.txt --synthetic --pol --pixind --COMP_LMAX_IND02=100
and the configuration's keys, chip_smoke.py's HOST_SMALL and, from TOD,
HOST_TOD_SMALL's first pair) twice on the CPU in float64 with the same
draws: once plain, then once per --mode: every Legendre synthesis and
adjoint's input and output rounded to complex64, as that route rounds
them (rounded, the default); the stage computed as the kernels compute
it, on their float32 coefficient pack in complex64 (single:
chip_smoke.kernel_arithmetic, the witness of the smoke's pair); or the
map-level data moved by 1e-12 of themselves (moved: the chain's own
spread). Further --PARAMETER=value arguments go to every run. Per sample and
component it prints the largest difference of the alms (relative to their
max) and of each theta map (also in grid steps), the multipole where the
alms differ most, and both chi^2; from TOD also each band's gains and
sigma0 (relative to their max) and the 4D maps by dataset (relative to
their max).
"""
from __future__ import annotations

import argparse
import dataclasses
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
                         "--SMOOTHING_SCALE_LMAX01=16"],
    "tod_bp_mono_4d": ["--tod", "--SYNTH_TOD_NSCAN=8",
                       "--SYNTH_TOD_NTOD=16384",
                       "--BAND_SAMP_BANDPASS001=.true.",
                       "--BAND_SAMP_BANDPASS002=.true.",
                       "--BAND_SAMP_BANDPASS003=.true.",
                       "--SAMPLE_TOD_MONOPOLE=.true.", "--tod-mono-guard",
                       "--TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER=1"]}


def _grid_steps(argv) -> dict:
    """{(component label, parameter index): grid step} under argv."""
    from commander_tpu_torch.driver import specind as hs
    from commander_tpu_torch.driver.model import (comp_to_diffuse,
                                                  diffuse_configs)
    from commander_tpu_torch.io.params import Params, lower_params

    cfg = lower_params(Params.load(argv[0], [a for a in argv
                                             if a.startswith("--")
                                             and "=" in a]))
    out = {}
    for c in diffuse_configs(cfg):
        d = comp_to_diffuse(c)
        for j, name in enumerate(c.indices):
            lo, hi, *_ = hs.index_bounds(c.indices[name], name, d.theta0[j])
            out[(c.label, j)] = (hi - lo) / (hs.NGRID - 1)
    return out


def _maps4d(d: str) -> dict:
    """{(file, detector, dataset): array} of the 4D maps in directory d."""
    from commander_tpu_torch.io import hdf5

    out = {}
    for f in sorted(os.listdir(d)):
        if f.startswith("tod_4D_"):
            with hdf5.File(os.path.join(d, f), "r") as h:
                for det, grp in h.root.members.items():
                    for name, ds in grp.members.items():
                        out[(f, det, name)] = h.read_dataset(ds)
    return out


def _rounded(fn):
    c64 = lambda x: x.to(torch.complex64).to(x.dtype)

    def f(otf, *args):
        out = fn(otf, *(c64(a) if isinstance(a, torch.Tensor) else a
                        for a in args))
        return tuple(c64(o) for o in out) if isinstance(out, tuple) \
            else c64(out)
    return f


def _moved(fn):
    """loop.build_model with the map-level data moved by 1e-12 of
    themselves (the system's own spread, as tests/test_torch_host_loop_te.py
    measures run()'s)."""
    def f(*a, **k):
        m = fn(*a, **k)
        return m._replace(sys=dataclasses.replace(
            m.sys, data=m.sys.data * (1 + 1e-12)))
    return f


def _compare(paths, mode, niter, steps, tod: bool):
    """Print how far the chain of `mode` stands from the plain chain."""
    from commander_tpu_torch.io.chain import ChainFile

    tag = f"[host_loop_rounding] {mode}:"
    with ChainFile(paths["plain"], "r") as ca, \
            ChainFile(paths[mode], "r") as cb:
        for i in range(1, niter + 1):
            sa, sb = ca.read_sample(i), cb.read_sample(i)
            for c, x in sa["comps"].items():
                y = sb["comps"][c]
                d = np.abs(x["alm"] - y["alm"])
                msg = [f"alm {d.max() / np.abs(x['alm']).max():.2e} (worst "
                       f"ell {int(np.argmax(d.max(axis=(0, 2))))})"]
                for k in x:
                    if k.startswith("theta_map"):
                        t = np.abs(x[k] - y[k]) / steps[(c, int(k[9:]))]
                        msg.append(f"{k} {t.max():.3g} grid steps (99th "
                                   f"percentile {np.percentile(t, 99):.3g})")
                print(f"{tag} sample {i} {c}: " + ", ".join(msg))
            if tod:
                ta, tb = ca.read_tod_state(i), cb.read_tod_state(i)
                for band, x in ta.items():
                    msg = [f"{k} {np.abs(x[k] - tb[band][k]).max() / np.abs(x[k]).max():.2e}"
                           for k in ("gain", "sigma0")]
                    print(f"{tag} sample {i} band {band}: "
                          + ", ".join(msg))
            print(f"{tag} sample {i} chi2 "
                  f"{float(sa['aux']['chisq']):.10g} plain, "
                  f"{float(sb['aux']['chisq']):.10g} {mode}")
    ma, mb = (_maps4d(os.path.dirname(paths[m])) for m in ("plain", mode))
    worst = {}
    for k, x in ma.items():
        e = float(np.abs(x - mb[k]).max() / np.abs(x).max())
        worst[k[2]] = max(worst.get(k[2], 0.0), e)
    for name, e in sorted(worst.items()):
        print(f"{tag} 4D maps {name}: {e:.2e} of their max")


def main(argv=None) -> int:
    import chip_smoke
    from commander_tpu_torch import run
    from commander_tpu_torch.driver import loop
    from commander_tpu_torch.sphere import cuda_sht

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nside", type=int, default=32)
    ap.add_argument("--niter", type=int, default=2)
    ap.add_argument("--config", choices=sorted(CONFIGS),
                    default="te_resample")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--mode", choices=("rounded", "single", "moved"),
                    action="append",
                    help="rounded (the default): the stage's inputs and "
                         "outputs rounded to complex64; single: the stage "
                         "computed as the kernels compute it, on their "
                         "float32 pack; moved: the data moved by 1e-12 "
                         "(repeatable)")
    args, extra = ap.parse_known_args(argv)
    torch.set_num_threads(args.threads)
    argv_run = ["param_tutorial_full.txt", "--synthetic", "--pol", "--cpu",
                "--nside", str(args.nside), "--lmax", str(2 * args.nside),
                "--niter", str(args.niter), "--pixind",
                "--COMP_LMAX_IND02=100"] + CONFIGS[args.config] + extra
    steps = _grid_steps(argv_run)
    modes = args.mode or ["rounded"]
    paths = {}
    plain = (cuda_sht.synth_legendre_plain, cuda_sht.adjoint_legendre_plain,
             loop.build_model)
    for mode in ["plain"] + modes:
        if mode == "rounded":
            cuda_sht.synth_legendre_plain = _rounded(plain[0])
            cuda_sht.adjoint_legendre_plain = _rounded(plain[1])
        elif mode == "single":
            chip_smoke.kernel_arithmetic()
        elif mode == "moved":
            loop.build_model = _moved(plain[2])
        out = os.path.join("build", f"host_loop_rounding_{mode}")
        shutil.rmtree(out, ignore_errors=True)
        try:
            (res,) = run.main(argv_run + ["--outdir", out],
                              rng_device="cpu")
        finally:
            (cuda_sht.synth_legendre_plain, cuda_sht.adjoint_legendre_plain,
             loop.build_model) = plain
        paths[mode] = res.chain_path
    print(f"[host_loop_rounding] {' '.join(argv_run)}")
    for mode in modes:
        _compare(paths, mode, args.niter, steps, "--tod" in argv_run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
