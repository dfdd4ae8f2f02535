"""The program: parameter file -> model -> Gibbs chain -> HDF5 chain file.

Counterpart of commander_tpu.run (the reference's commander.f90), invoked as
``python -m commander_tpu_torch param.txt [options]``. The work lives in
the driver package: driver/model.py (build_model), driver/loop.py (run()'s
loop, the reject rule, resume), driver/output.py (what a thinning point
writes). This module holds the entry points: main (the command line), run
(one chain of the single-resolution loop) and run_multires (the
multi-resolution loop of sampling/multires_gibbs.py with its chain file and
status file).

The card is the default device; --cpu asks for the CPU. Without a card and
without --cpu the run raises (utils/device.py). float64 is the default, as
in the JAX package's command line; --f32 gives float32.
"""
from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

from .driver.loop import RunResult, chain_seed, run  # noqa: F401
from .io.chain import ChainFile
from .io.params import Params, lower_params
from .utils.device import resolve_device
from .utils.status import StatusFile, Timer


def run_multires(cfg, niter=None, outdir=None, synthetic: bool = False,
                 dtype=torch.float64, verbose: bool = True, chain: int = 1,
                 data_dir=None, max_nside=None, tod: bool = False,
                 pol: bool = False, device=None,
                 generator: torch.Generator | None = None, draws=None,
                 a_true=None):
    """The multi-resolution chain (run.run_multires, run.py:2697-2957):
    build_multi_problem (every band at its own resolution; synthetic data,
    or with synthetic=False the bands' FITS maps, rms and masks), then
    niter iterations of multires_gibbs_step, a sample chain_mr_c<chain>.h5
    at every THINNING_FACTOR-th (the alms, the gains, the CG iterations and
    every component's index values in order, as run_multires writes them)
    and the status file. With tod (and ENABLE_TOD) every band with a TOD
    type gets run_multires' stand-in TOD (multires_gibbs.simulate_tod_bands:
    an LFI or a differential block, T only), three burn-in passes on the
    zero sky, and a TOD pass ahead of every iteration. draws: a function of
    the iteration returning multires_gibbs_step's draws (in place of the
    generator's), at 0 the burn-in's ({"tod": one dict per pass}); a_true:
    the sky's amplitudes (build_multi_problem). Returns (state, chain path,
    a_true)."""
    from .entry import build_multi_problem
    from .sampling import multires_gibbs as mg

    device = resolve_device(device)
    outdir = outdir or cfg.output_dir or "./chains"
    os.makedirs(outdir, exist_ok=True)
    status = StatusFile(os.path.join(outdir, "comm_status.txt"))
    timer = Timer(device)
    status.update("init start")
    timer.start("init")
    pb = build_multi_problem(cfg, seed=0, dtype=dtype, device=device,
                             max_nside=max_nside, pol=pol, data_dir=data_dir,
                             a_true=a_true, synthetic=synthetic)
    niter = niter or cfg.num_gibbs_iter
    if generator is None:
        generator = torch.Generator(device)
        generator.manual_seed(chain_seed(cfg.base_seed, chain))
    chain_path = os.path.join(outdir, f"chain_mr_c{chain:04d}.h5")
    state = mg.init_state(pb)
    timer.stop("init")
    status.update("init done")
    if tod and cfg.enable_tod:
        timer.start("tod_sim")
        state.bands = mg.simulate_tod_bands(pb)
        timer.stop("tod_sim")
        timer.start("tod_burnin")
        state = mg.tod_burnin(pb, state, generator, None if draws is None
                              else draws(0)["tod"])
        timer.stop("tod_burnin")
        status.update(f"tod init: {len(state.bands)} bands burned in")
    with ChainFile(chain_path) as ch:
        for it in range(1, niter + 1):
            timer.start("gibbs")
            state = mg.multires_gibbs_step(
                pb, state, generator, None if draws is None else draws(it))
            dt = timer.stop("gibbs")
            status.update(f"iter {it} cg={state.cg_iters} "
                          f"relres={state.cg_relres:.2e}")
            if verbose:
                print(f"iter {it:5d}  cg {int(state.cg_iters):3d} "
                      f"({float(state.cg_relres):.1e})  {dt:6.2f}s",
                      flush=True)
            if it % cfg.thinning == 0:
                timer.start("output")
                a = state.a.cpu().numpy().astype(np.complex128)
                ch.write_sample(
                    it, {d.name: {"alm": a[i]}
                         for i, d in enumerate(pb.diffuse)},
                    gains=state.gains.cpu().numpy(),
                    extra={"cg_iters": int(state.cg_iters),
                           "specind": _flat_thetas(pb, state.thetas)})
                timer.stop("output")
    status.update("done")
    if verbose:
        print(timer.report(), flush=True)
    return state, chain_path, pb.a_true


def _flat_thetas(pb, thetas: torch.Tensor) -> np.ndarray:
    """Every component's index values in order, the sampled ones from
    `thetas` (the slot vector), the others at their theta0 mean; [0.0] where
    there are none (run.py:2950-2953)."""
    vals = {(s.ci, s.which): v
            for s, v in zip(pb.slots, thetas.cpu().tolist())}
    out = [vals.get((ci, j), float(np.mean(t)))
           for ci, d in enumerate(pb.diffuse)
           for j, t in enumerate(d.theta0)]
    return np.asarray(out or [0.0], np.float64)


_OVERRIDE = re.compile(r"^--[A-Z][A-Z0-9_]*=")


def main(argv=None, rng_device=None):
    """The command line (run.main's flags and meanings, plus --KEY=value
    overrides of the parameter file). Returns the RunResult (or the
    multires tuple) of every chain. rng_device: the device of each chain's
    generator (default: the run's); every draw is made there and moved
    (utils/device.randn), so rng_device="cuda" with --cpu repeats the
    card's chain on the CPU."""
    ap = argparse.ArgumentParser(
        prog="commander_tpu_torch",
        description="CMB Gibbs sampler on a CUDA card (Commander-compatible)")
    ap.add_argument("paramfile")
    ap.add_argument("--nside", type=int, default=None)
    ap.add_argument("--lmax", type=int, default=None)
    ap.add_argument("--niter", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="simulate data from the prior model")
    ap.add_argument("--tod", action="store_true",
                    help="run the TOD layer (synthetic TOD per TOD band)")
    ap.add_argument("--pol", action="store_true",
                    help="polarized run (T,Q,U; requires polarized bands)")
    ap.add_argument("--pixind", action="store_true",
                    help="per-pixel spectral indices (COMP_LMAX_IND < 0)")
    ap.add_argument("--te-cl", action="store_true",
                    help="TE-coupled C_ell sampling (polarized runs)")
    ap.add_argument("--multires", action="store_true",
                    help="keep bands at their native (nside, lmax); "
                         "amplitude+Cl Gibbs over resolution groups")
    ap.add_argument("--max-nside", type=int, default=None,
                    help="cap band nside in multires mode")
    ap.add_argument("--data-dir", default=None,
                    help="directory for map/noise/mask files (DATA_DIRECTORY)")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--cg-groups", action="store_true",
                    help="the reference's CG sampling-group sweep (user "
                         "groups and one group per component, each with "
                         "its maxiter and mask) in place of the one joint "
                         "draw")
    ap.add_argument("--tod-mono-guard", action="store_true",
                    help="port-only: the TOD monopole draw leaves out the "
                         "pixels whose Stokes block is near singular "
                         "(seen at fewer than three angles)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--f32", action="store_true", help="float32")
    args, rest = ap.parse_known_args(argv)
    bad = [r for r in rest if not _OVERRIDE.match(r)]
    if bad:
        ap.error(f"unrecognized arguments: {' '.join(bad)}")
    device = "cpu" if args.cpu else resolve_device(None)
    dtype = torch.float32 if args.f32 else torch.float64
    cfg = lower_params(Params.load(args.paramfile, rest))
    out = []
    for chain in range(1, max(cfg.numchain, 1) + 1):
        gen = None
        if rng_device is not None and args.multires:
            gen = torch.Generator(rng_device)
            gen.manual_seed(chain_seed(cfg.base_seed, chain))
        if args.multires:
            out.append(run_multires(
                cfg, niter=args.niter, outdir=args.outdir,
                synthetic=args.synthetic, dtype=dtype, chain=chain,
                data_dir=args.data_dir, max_nside=args.max_nside,
                tod=args.tod, pol=args.pol, device=device, generator=gen))
        else:
            out.append(run(
                cfg, nside=args.nside, lmax=args.lmax,
                synthetic=args.synthetic, niter=args.niter,
                outdir=args.outdir, dtype=dtype, tod=args.tod, chain=chain,
                pol=args.pol, data_dir=args.data_dir, pixind=args.pixind,
                te_cl=args.te_cl, cg_groups=args.cg_groups, device=device,
                rng_device=rng_device, mono_guard=args.tod_mono_guard))
    return out
