"""Smoke run of the PyTorch / CUDA port on one card.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # small shapes, CPU, plain versions

Phases (each prints its lines; any failure raises and the exit code is not 0):
  1. the card: name and power limit (nvidia-smi), device count;
  2. build the CUDA Legendre kernels from commander_tpu_torch/csrc/; a
     register spill reported by ptxas fails the run;
  3. each kernel against its plain torch version on the card, with times,
     the least time the card could take (bound) and the adjoint's scratch:
     nside 256 / lmax 512 at mp 0, +2, -2, batch 3 and 6, and the main
     paths' shapes at nside 1024 / lmax 2000: mp 0 at batch 3, mp -2 and +2
     at batch 6, and (the index phase's amplitude maps, the six-band model
     and the pixel-mixing operator's component batch, without the float64
     comparison) mp 0 at batch 1, 5 and 6, mp -2 and +2 at batch 2 and 10
     (the plain version timed once at every shape);
     then the low-ell preconditioner's
     degraded plans (nside 2, 4,
     8, 16 at their lmax 5, 11, 23, 47) at mp 0, +2, -2 with one column chunk
     of the block (256 columns x 3 bands x 3 Stokes), and tutorial_multires'
     nside-512 group (lmax 1000: mp 0 at batch 2, mp -2 and +2 at batch 4);
     max |diff| <= 1e-5 max |ref| and adjointness to 1e-5; at mp 0 batch 3
     (nside 256 and 1024), at mp -2 and +2 batch 6 (nside 256) and at the
     nside-512 shapes also the library call beside the kernels, one
     torch.bmm against a precomputed lambda-hat table, one spin's table at
     a time (library_phase; timed, not gated); then the table SHT path
     (table_phase: get_plan(tables=True) at nside 256 / lmax 512, float32,
     batch 8, its host tables made in a thread beside the kernels,
     prebuild_tables): spin 0, spin 2 and T/E/B synthesis and adjoint held
     to the float64 table plan to 1e-5, and to the kernels within the
     kernels' own float32 error plus 1e-5, no kernel launched, ms per
     transform for tables and kernels, the tables' bytes and build time;
  4. the spin-2 transform composed from the kernels (alm2map_spin2 and its
     adjoint) against the plain two-recurrence route, at nside 256 and at
     nside 1024 / lmax 2000, to 1e-5 of the max, the adjointness of the
     T/E/B pair under the alm metric to 1e-5, and (reported, not gated) the
     float32 transform's error against the float64 plain transform;
  5. the entry problems (nside 64 / lmax 128, 3 bands), T only and
     polarized: one Gibbs step on the card against the same step in float64
     on the CPU, given the same draws, to 1e-3 (every CPU float64 step of
     this phase runs in a worker process started after phase 2, beside
     phases 3 and 4, on the card's data: phase5_start, phase5_worker);
     then entry_full, the whole iteration with its three spectral-index draws, the same way: amplitudes
     to 1e-3, every index to 0.05 of its grid step; then entry_tod, the
     iteration from TOD (the TOD pass of three bands, the maps replacing the
     data, the whole iteration), the same way, with the hit masks and the
     noise-PSD grid indices identical and the binned maps to 1e-4, once with
     each CG preconditioner: diagonal, pseudo-inverse, low-ell block (L 8);
     then entry_joint, the whole 8-component model with the joint system's
     template and source rows, at the preset's CG tol, held in its parts
     (_hold_joint: the same CG iteration count, t, the full model sky in
     data space, the index draws given the card's amplitudes); then
     entry_multires, the multi-resolution step (30/44 GHz at nside 32, 70
     GHz at nside 64, T/Q/U, five components, five slots, gains), held in
     its parts the same way (entry_multires_phase: the same CG count, each
     group's model sky, the index draws and the gains given the card's
     amplitudes);
  6. the main paths, with the kernels' launch counts set to 0 before each
     and read after it, and held to what the code implies: the tutorial
     preset (nside 1024 / lmax 2000, 3 LFI bands, 3 components, float32, T
     only) for 2 Gibbs steps, and the polarized tutorial_pol preset (T/Q/U,
     CMB binned, synch and dust on fixed gauss priors) for 2; after each,
     outside the counts, its reduced chi-square and one step whose CG runs
     10-20 iterations, nearer the depth of a solve on real maps; then the
     whole Gibbs iteration (full_gibbs_step) on a simulated sky:
     tutorial_full (tutorial_pol with index slots for synch beta, dust beta
     and T_d, beam-consistent) for 3 steps and fullgibbs (T only, 5
     components, 6 bands, 5 slots) for 2, from start values off the truth,
     with per step its seconds, CG iterations, theta and launch counts
     (asserted), and outside the counts: the index draws given the true
     amplitudes, each alone held to one grid step around the truth's grid
     point and all in slot order from the truth held to 16 steps (one
     index makes up for the grid rounding of the one before), the float32
     lnL grid against the same grid in float64, and the index
     phase's time alone; then the iteration from TOD: tutorial_tod (3 LFI
     bands x 96 scans x 4 detectors x 131072 samples of simulated TOD;
     the simulator's host time alone), a warm start (one amplitude step,
     three TOD passes; gain and sigma0 held to the simulated ones) and
     TOD_DIAG_STEPS tod_gibbs_steps, their CG cut at TOD_DIAG_MAXITER
     iterations (binned maps held to the true band sky),
     with each band's TOD pass timed alone and by part, and the TOD stage's
     device busy share, and band 030's pass with the sidelobe and zodi
     terms (tod_templates_phase: seeded beams at lmax 100 with 8 modes, a
     zodi template, both injected; ms of the f-map rebuild, the
     interpolation, the zodi template and the pass with and without the
     terms; gain and sigma0 recovered with them modelled, the chi^2 worse
     with them left out; the terms and the table path in float64 card
     against the worker's CPU at nside 64: 1e-10, gains 1e-8); then from
     the same bands and state one step with the
     pseudo-inverse preconditioner and one with the low-ell block (L 16),
     each its own path: per step CG iterations, relres, ms per iteration,
     the preconditioner's build ms, s/step, peak memory, the steps the
     reference would reject (relres > tol), the preconditioner symmetric and
     positive under the alm metric and the solution's true residual, each
     within a float32 bound derived below; then the whole 8-component model
     from TOD, tutorial_joint (joint_path_phase: simulation, warm start,
     JOINT_STEPS steps with the diffuse block's own relres, ms per operator
     application and of its template and source products); then the
     multi-resolution chain, tutorial_multires (multires_path_phase: 30/44
     GHz at nside 512 / lmax 1000 and 70 GHz at nside 1024 / lmax 2000 in
     one CG operator, MULTIRES_STEPS steps with s/step, CG iterations and
     relres, ms per operator application by group, the index phase, peak
     memory, theta against the truth, launch counts asserted); then
     run_multires' TOD branch through the program (multires_tod_phase:
     MULTIRES_TOD_ARGV, an LFI and a differential stand-in at nside 512
     beside an LFI one at 1024; per iteration s/step, CG iterations and
     relres, each band pass's ms, Q and U rows untouched, peak memory,
     launch counts asserted); then the
     program itself, python -m commander_tpu_torch (driver_phase): the
     command a user types, param_tutorial_full.txt --synthetic --pol --tod
     --f32 --niter 2, through run.main in this process (the file's whole
     8-component model from its TOD at nside 1024 / lmax 2000); per
     attempt s/step, CG iterations, relres and rejects, build / simulation
     / warm start / output seconds, peak memory; held to a finite state,
     accepted samples at relres <= tol, samples 1-2 in the chain (read back
     with the port's ChainFile), the launch counts of the build, the warm
     start and every attempt exactly as the code implies them from its CG
     iterations, under DRIVER_RUN_S (its resume, ~95 s, is held on the CPU
     only: a cut for the smoke's time); beside it, as two processes, the
     float64
     command at nside 64 / lmax 128 on the card against its twin on the CPU
     drawing from the card's generator (run.main(..., rng_device="cuda")):
     alms to 1e-3, indices to 0.05 grid step; then the same command with
     band 070 differential (driver_wmap_phase: run()'s host loop in
     float32; per differential pass its ms, mapmaker iterations and relres
     and x_im, each band's map against the noiseless band sky, launch
     counts asserted); then run()'s host loop
     (host_loop_phase): HOST_ARGV, the file at nside 1024 / lmax 2000 in
     float64 with --pixind and synch beta an alm field to l = 100 (its
     whole model with the template and source rows; its float32 CG breaks
     down, ROADMAP queue 3 item 10e), 1 iteration under HOST_RUN_S; per
     attempt s/step, CG iterations, the index phase by parameter, the MH
     acceptances; ms per operator application under F_pix and at scalar
     F, peak memory; held to a finite state, accepted samples at relres <=
     tol, theta maps inside their grids, the chain's theta_map entries, the
     launch counts of the build and each attempt exactly; the host loop's
     parts in float64 at nside 32 on the card against the CPU given the
     same data and amplitudes (the pixel-mixing operator, its sky and F_pix
     to 1e-3, the same MH acceptances, the index step's theta maps to
     THETA_STEPS grid steps, which a planted wrong draw must exceed);
     beside it, as processes, the float64
     command at nside 64 / lmax 128 for one iteration in two HOST_SMALL
     configurations (--te-cl with RESAMPLE_CMB and POLTYPE 2;
     ALMSAMP_PIXREG with a smoothing scale), card against its CPU twin:
     alms to 1e-3, the same MH acceptances, the theta maps to THETA_STEPS;
     then run()'s host loop from TOD (host_loop_tod_phase): HOST_TOD_ARGV,
     the reference tutorial's TOD setting in float64 at nside 1024 / lmax
     2000 (the whole model, synch beta an alm field to l = 100, every
     band's bandpass sampled on the TOD chi^2, the TOD monopoles; the
     depth cut --SYNTH_TOD_NSCAN=48), 1 iteration under HOST_TOD_RUN_S;
     build, TOD simulation, warm start, burn-in and output seconds; per
     attempt s/step split into the TOD stage, the bandpass moves, the CG
     and the index phase, per band the bandpass proposal and both chi^2;
     the monopoles and the hit pixels seen at fewer than three angles;
     peak memory; held to a finite state, an accepted sample, bp_delta and
     the TOD states with their monopoles in the chain, attempt 1's moves
     in the fast form, the launch counts of the build, the warm start and
     each attempt exactly; beside it, as processes started before the
     driver phase (host_tod_pairs_start), the HOST_TOD_SMALL

     float64 pairs, one iteration each (the command at nside 64 with the 4D
     maps; a map-level band beside an unpolarized TOD band; --cg-groups at
     nside 32), card against its CPU twin: TOD gains and sigma0 to
     TOD_PAIR_TOL, the same MH acceptances, alms to 1e-3, theta to
     THETA_STEPS and the 4D maps to 1e-6; for the whole model from TOD
     beside a witness, the CPU twin with the kernels' float32 Legendre
     stage: the card's alms and theta held to the witness to a tenth of
     the witness's distance from the CPU, its 4D maps to ten times it
     (_hold_tod_pair); and the TOD
     stage on the card against the CPU on the same TOD, sky and draws
     (_tod_parts_check: the bandpass moves in both forms, the binned maps,
     the TOD state and the 4D maps to 1e-6), and a differential pass in
     float64 at nside 64 card against CPU (_diff_parts_check: the same
     bits twice, its state and x_im to 1e-6, its map to 10x the CPU's own
     spread, the T mapmaker at x_im 0.2 to 1e-6); pair (b)'s unpolarized
     band is differential;
  7. a JSON line of the kernels, the card's name and power limit, and the
     result line {"ok": true, "device": {...}}.
Without a card it stops before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

TOL = 1e-5

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 bandwidth
H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12

# peak device memory allowed to a whole Gibbs iteration at nside 1024: the
# per-pixel lnL grid the full-sky sampler must never build, (B, P, 64)
# float32, alone is 9.7 GB for 3 bands
FULL_STEP_PEAK_GIB = 12.0

# how far, in grid steps, the index draws made in slot order from the truth
# may land from it (derived where the draws are made, full_path_phase)
SEQ_BOUND_STEPS = 16.0

# peak device memory allowed to a step of the iteration from TOD at nside
# 1024: the three bands' TOD (3.7 GB resident) beside the CG's 7.7 GiB or a
# band pass's temporaries (the float64 binning planes a chunk at a time)
TOD_STEP_PEAK_GIB = 20.0

# after the TOD warm start: every band's mean gain within 1% of its
# simulated 1, and its mean sigma0 within 2% of the simulated one with the
# model sky's errors added (as the sample differences see them: at 70 GHz,
# whose 13.3' beam leaves pixel-scale signal, the model sky's posterior
# spread lifts sigma0 by ~10%; at 30 and 44 GHz by ~1%)
GAIN_TOL = 0.01
SIGMA0_TOL = 0.02

# binned maps against the band sky they were simulated from, chi^2/dof at
# the solved pixels (run.py:2052-2067's statistic), per band and Stokes:
# white binned noise gives 1; the gain error, and the sky model's errors
# that the n_corr draw takes in, add to it. The CPU rehearsal (nside 32,
# ~57 samples per hit pixel) reads 0.42-4.71 over its two steps; these
# excesses scale with the signal-to-noise per pixel, sqrt(57 / 4.7) = 3.5
# times lower at the preset's ~4.7 samples per hit pixel: 1.3 at most
BINNED_CHI2_BOUND = 2.0

# the entry_tod check runs this many CG iterations on both sides: its
# TOD-binned system (a third of the pixels solved) takes hundreds to reach
# the tolerance with the diagonal preconditioner (30 before the driver
# phase took the smoke's time, 12 before the host_loop phase: depth cuts)
ENTRY_TOD_CG_ITERS = 6

# a PSD grid index may differ between the card and the CPU only where the
# uniform lies this close (relative) to a step of the CDF
PSD_CDF_MARGIN = 1e-4

# the CG preconditioners run on the iteration from TOD besides the diagonal
# one: entry_tod (phase 5) and tutorial_tod (phase 6), as GibbsConfig fields
ENTRY_TOD_PRECONDS = ({}, {"cg_precond": "pseudoinv"}, {"cg_lmax_precond": 8})
# (the pseudo-inverse does not converge on tutorial_tod in 400 iterations,
# 160 ms each, PERF.md): its path runs at 30, a depth cut for the smoke's
# time (100 before the driver phase); the low-ell block's at 100 (the
# preset's 400 before the host_loop phase, where it converged at 334);
# torch_tools/precond_sweep.py solves both to 400)
TOD_PRECONDS = {"pseudoinv": {"cg_precond": "pseudoinv", "cg_maxiter": 30},
                "lowl16": {"cg_lmax_precond": 16, "cg_maxiter": 100}}
# tutorial_tod's steps with the diagonal preconditioner, before those
TOD_DIAG_STEPS = 1
# tutorial_tod's and tutorial_joint's TOD: 48 of the presets' 96 scans per
# band, a depth cut for the smoke's time since the host_loop_tod phase (the
# simulation was 84-129 s; the driver and host_loop_tod phases run 48 too)
PRESET_TOD_NSCAN = 48
# their CG's depth (the preset's 400 before the host_loop phase: a cut for
# the smoke's time; tutorial_tod needs ~390 to converge, PERF.md)
TOD_DIAG_MAXITER = 100
# tutorial_joint's steps (the whole 8-component model from TOD; 2 before
# the driver phase ran the same model for 4 steps)
JOINT_STEPS = 1
# tutorial_multires' steps (the multi-resolution chain)
MULTIRES_STEPS = 3

# the sidelobe beams' truncation in phase 6's band pass with both terms:
# lmax 100, 8 beam modes (run.py:680-688, after comm_tod_LFI_mod.f90:442),
# and the passes it runs with the terms and without them
SL_LMAX, SL_MMAX = 100, 8
TEMPLATE_PASSES = 2

# the table path's size and batch in phase 3 (bench.py's headline SHT)
TABLE_SIZE = (256, 512)
TABLE_BATCH = 8

# the low-ell blocks whose degraded plans (amplitude.lowl_grid at lmax
# 2000: nside 2, 4, 8, 16 at lmax 5, 11, 23, 47) phase 3 runs the kernels on
LOWL_LMAX = (4, 8, 16, 32)


T_START = time.perf_counter()


def say(*a):
    print(*a, flush=True)


def done(phase):
    say(f"[{phase}] done {time.perf_counter() - T_START:.0f} s after the "
        f"start")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def relmax(got, ref) -> float:
    d = (got.to(torch.complex128) - ref.to(torch.complex128)).abs().max()
    return float(d / ref.abs().max())


def absmax(got, ref) -> float:
    return float((got.to(torch.complex128) - ref.to(torch.complex128))
                 .abs().max())


class Timer:
    """Milliseconds per call: CUDA events on the card, host clock on CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def __call__(self, fn, reps=1) -> float:
        if self.cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            torch.cuda.synchronize()
            return t0.elapsed_time(t1) / reps
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps


def legendre_bound(nside, lmax, mp, batch):
    """(ms, "operations" | "bytes"): the least time the card could take for
    one Legendre synthesis or adjoint (the two do the same work).

    Operations: every (ring, l, m) step with l >= max(m, |mp|) needs the
    recurrence, alpha = A x + B and new = alpha cur - beta prev (5 flops),
    and 2 FMAs per batch entry (re, im; the even/odd-l fold halves the 4
    products). Bytes: the coefficient pack (A, B, beta), the seeds with
    their exponents, cos(theta), the alm and both ring spectra, each moved
    once."""
    nl = nm = lmax + 1
    nh = 2 * nside
    steps = nh * sum(nl - max(m, abs(mp)) for m in range(nm))
    flops = steps * (5 + 4 * batch)
    nbytes = (3 * nl * nm * 4 + nh * nm * 8 + nh * 4 + batch * nl * nm * 8
              + 2 * batch * nh * nm * 8)
    t_ops = flops / H100_FP32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def lambda_table(otf) -> torch.Tensor:
    """(nm, nh, nl) table of the kernels' normalized lambda-hat values: the
    plain chunked recurrence on their coefficient pack (cuda_sht.pack_otf),
    zero below l = max(m, |mp|), in otf's dtype on its device."""
    from commander_tpu_torch.sphere import cuda_sht, sht_otf

    po = cuda_sht.pack_otf(otf)
    nl, nm, nh = po.lmax + 1, po.mmax + 1, po.x.shape[0]
    tab = torch.empty((nm, nh, nl), dtype=po.seed_mant.dtype,
                      device=po.x.device)
    carry = sht_otf._init_rec_carry(po)
    for l0 in range(0, nl, po.chunk):
        carry, lam = sht_otf._lam_chunk(po, carry, l0)    # (L, nh, nm)
        n = min(po.chunk, nl - l0)
        tab[:, :, l0:l0 + n] = lam[:n].permute(2, 1, 0)
    return tab


def library_phase(otf, alm, Gn, Gs, Fn, Fs, ad, timer):
    """The library call beside the kernels (no PyTorch call computes an
    on-the-fly Legendre transform; a product against a precomputed table
    computes the same function, as the JAX package's table path does): one
    torch.bmm of the (nm, nh, nl) lambda-hat table by the alms as real
    columns with their (-1)^(l+m) copies, (nm, nl, 4 batch), gives F_n and
    F_s; one bmm by the table's transpose gives the adjoint. float32 with
    TF32 off. Returns dict(synth_ms, adjoint_ms, table_bytes, build_s,
    errors against the kernels' outputs, layout_ms), or None where the
    table does not fit in the free device memory (with the reason)."""
    nl, nm, nh = otf.lmax + 1, otf.mmax + 1, otf.x.shape[0]
    B = alm.shape[0]
    nbytes = nm * nh * nl * 4
    if alm.device.type == "cuda":
        free = torch.cuda.mem_get_info()[0]
        # the table, one recurrence chunk of lambda-hat and the products
        need = nbytes + otf.chunk * nh * nm * 4 * 3 + 8 * nm * nh * 4 * B * 2
        if need > 0.9 * free:
            return dict(fits=False, table_bytes=nbytes, free_bytes=free)
    t0 = time.perf_counter()
    tab = lambda_table(otf)
    if alm.device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ll = torch.arange(nl, device=alm.device)
    mm = torch.arange(nm, device=alm.device)
    sign = (1 - 2 * ((ll[None, :] + mm[:, None]) % 2)).to(tab.dtype)

    def cols(x):                       # (B, n, nm) complex -> (nm, n, 2B)
        r = torch.view_as_real(x).permute(2, 1, 0, 3)
        return r.reshape(nm, x.shape[1], 2 * B)

    def uncols(y):                     # (nm, n, 2B) -> (B, n, nm) complex
        y = y.reshape(nm, y.shape[1], B, 2).permute(2, 1, 0, 3)
        return torch.view_as_complex(y.contiguous())

    a = cols(alm)
    X = torch.cat([a, a * sign[:, :, None]], dim=-1).contiguous()
    G = torch.cat([cols(Gn), cols(Gs)], dim=-1).contiguous()
    tabT = tab.transpose(1, 2)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        Y = torch.bmm(tab, X)                          # (nm, nh, 4B)
        Z = torch.bmm(tabT, G)                         # (nm, nl, 4B)
        syn_ms = timer(lambda: torch.bmm(tab, X), 3)
        adj_ms = timer(lambda: torch.bmm(tabT, G), 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    Fn_l, Fs_l = uncols(Y[..., :2 * B]), uncols(Y[..., 2 * B:])
    ad_l = uncols(Z[..., :2 * B] + sign[:, :, None] * Z[..., 2 * B:])
    layout_ms = timer(lambda: (torch.cat([cols(alm), cols(alm)], -1)
                               .contiguous(), uncols(Y[..., :2 * B]),
                               uncols(Y[..., 2 * B:])), 3)
    out = dict(fits=True, synth_ms=syn_ms, adjoint_ms=adj_ms,
               table_bytes=nbytes, build_s=build_s, layout_ms=layout_ms,
               synth_err_vs_kernel=max(relmax(Fn_l, Fn), relmax(Fs_l, Fs)),
               adjoint_err_vs_kernel=relmax(ad_l, ad))
    del tab, tabT, X, G, Y, Z
    return out


def kernel_phase(dev, sizes):
    """Phase 3: each kernel against its plain version at each (nside, lmax,
    mps, batch[, light[, library]]): light skips the float64 comparison,
    library times the library call at every mp of the size (it is timed at
    mp 0 batch 3 anyway); returns {(nside, mp, batch): {"synth": row,
    "adjoint": row}}."""
    from commander_tpu_torch.sphere import cuda_sht, sht_otf

    timer = Timer(dev)
    rows = {}
    for nside, lmax, mps, batch, *opt in sizes:
        light = bool(opt and opt[0])
        want_lib = bool(len(opt) > 1 and opt[1])
        for mp in mps:
            rng = np.random.default_rng(100 + nside + mp)
            nl, nh = lmax + 1, 2 * nside
            a = rng.standard_normal((batch, nl, nl)) \
                + 1j * rng.standard_normal((batch, nl, nl))
            a *= np.tril(np.ones((nl, nl)))
            a[:, : abs(mp)] = 0.0
            c64 = lambda x: torch.as_tensor(x.astype(np.complex64),
                                            device=dev)
            alm = c64(a)
            Gn = c64(rng.standard_normal((batch, nh, nl))
                     + 1j * rng.standard_normal((batch, nh, nl)))
            Gs = c64(rng.standard_normal((batch, nh, nl))
                     + 1j * rng.standard_normal((batch, nh, nl)))
            otf = sht_otf.legendre_otf(nside, lmax, mp, torch.float32,
                                       device=dev)
            Fn, Fs = cuda_sht.synth_legendre(otf, alm, nh)
            ad = cuda_sht.adjoint_legendre(otf, Gn, Gs)
            Fn_p, Fs_p = cuda_sht.synth_legendre_plain(otf, alm, nh)
            ad_p = cuda_sht.adjoint_legendre_plain(otf, Gn, Gs)
            e_syn = max(relmax(Fn, Fn_p), relmax(Fs, Fs_p))
            e_adj = relmax(ad, ad_p)
            c = lambda t: t.to(torch.complex128)
            lhs = torch.sum(c(Fn) * c(Gn).conj() + c(Fs) * c(Gs).conj())
            rhs = torch.sum(c(alm) * c(ad).conj())
            e_dot = abs(complex(lhs - rhs)) / abs(complex(lhs))
            # float64 plain on unrounded coefficients: the float32 pack's
            # own error, mostly cos(theta) of the polar rings rounded to
            # float32 (reported, not gated)
            e64_syn = e64_adj = float("nan")
            if not light:
                otf64 = sht_otf.legendre_otf(nside, lmax, mp, torch.float64,
                                             device=dev)
                e64_syn = relmax(Fn, cuda_sht.synth_legendre_plain(
                    otf64, alm, nh)[0])
                e64_adj = relmax(ad, cuda_sht.adjoint_legendre_plain(
                    otf64, Gn, Gs))
                del otf64
            # times (the comparison above was the warm-up): kernel, plain,
            # kernel; the plain version timed once at every shape (a depth
            # cut for the smoke's time since the table phase: it was timed
            # twice, before and after the kernel, at the full shapes)
            k_syn = lambda: cuda_sht.synth_legendre(otf, alm, nh)
            p_syn = lambda: cuda_sht.synth_legendre_plain(otf, alm, nh)
            k_adj = lambda: cuda_sht.adjoint_legendre(otf, Gn, Gs)
            p_adj = lambda: cuda_sht.adjoint_legendre_plain(otf, Gn, Gs)
            t = {}
            for name, k, p in (("synth", k_syn, p_syn),
                               ("adjoint", k_adj, p_adj)):
                tk1, tp, tk2 = timer(k, 3), timer(p), timer(k, 3)
                t[name] = ((tk1 + tk2) / 2, tp)
            bound_ms, bound_by = legendre_bound(nside, lmax, mp, batch)
            # the library call (a table product) where the paths' own
            # shape is timed in full (mp 0 at batch 3) and where a size asks
            # for it; one spin's table at a time, freed before the next
            lib = library_phase(otf, alm, Gn, Gs, Fn, Fs, ad, timer) \
                if want_lib or (mp == 0 and batch == 3 and not light) \
                else None
            if lib is not None:
                say(f"[3] nside {nside} lmax {lmax} mp {mp:+d} batch "
                    f"{batch}, library call (torch.bmm against the "
                    f"lambda-hat table, TF32 off): " + json.dumps(lib))
            lib_ms = {k: lib[f"{k}_ms"] if lib and lib["fits"] else None
                      for k in ("synth", "adjoint")}
            plan = cuda_sht.adjoint_plan(nh)
            scratch = cuda_sht.adjoint_scratch_bytes(otf, batch)
            say(f"[3] nside {nside} lmax {lmax} mp {mp:+d} batch {batch}: "
                f"synth err {e_syn:.2e} adjoint err {e_adj:.2e} "
                f"adjointness {e_dot:.2e} (vs float64 plain: synth "
                f"{e64_syn:.2e} adjoint {e64_adj:.2e}); ms kernel/plain "
                f"synth {t['synth'][0]:.3f}/{t['synth'][1]:.3f} adjoint "
                f"{t['adjoint'][0]:.3f}/{t['adjoint'][1]:.3f}; bound "
                f"{bound_ms:.3f} ms by {bound_by}; adjoint scratch "
                f"{scratch} bytes ({plan.nslice} slices, cluster "
                f"{plan.cluster}, {plan.npass} pass)")
            if not (e_syn <= TOL and e_adj <= TOL and e_dot <= TOL):
                raise AssertionError(
                    f"kernel disagrees with its plain version at nside "
                    f"{nside} mp {mp}: {e_syn}, {e_adj}, {e_dot}")
            common = dict(nside=nside, lmax=lmax, mp=mp, batch=batch,
                          bound_ms=bound_ms, bound_by=bound_by)
            rows[(nside, mp, batch)] = {
                "synth": dict(max_abs_err=max(absmax(Fn, Fn_p),
                                              absmax(Fs, Fs_p)),
                              max_rel_err=e_syn, ms=t["synth"][0],
                              plain_ms=t["synth"][1],
                              share_of_bound=bound_ms / t["synth"][0],
                              library_ms=lib_ms["synth"], library=lib,
                              **common),
                "adjoint": dict(max_abs_err=absmax(ad, ad_p),
                                max_rel_err=e_adj, ms=t["adjoint"][0],
                                plain_ms=t["adjoint"][1],
                                share_of_bound=bound_ms / t["adjoint"][0],
                                library_ms=lib_ms["adjoint"],
                                scratch_bytes=scratch, **common),
            }
            del Fn, Fs, ad, Fn_p, Fs_p, ad_p, alm, Gn, Gs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def _listed(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _table_calls(nside, lmax, batch, dt, dev, seed):
    """(name, args) of the public transforms on seeded inputs of `batch`
    entries in `dt` (float32 / float64) on `dev`: spin 0 (synthesis,
    adjoint, map2alm), spin 2 and T/E/B (synthesis and adjoint)."""
    rng = np.random.default_rng(seed)
    nl, npix = lmax + 1, 12 * nside * nside
    cdt = np.complex64 if dt == torch.float32 else np.complex128

    def alm(*lead):
        a = rng.standard_normal(lead + (nl, nl)) \
            + 1j * rng.standard_normal(lead + (nl, nl))
        a *= np.tril(np.ones((nl, nl)))
        a[..., 0] = a[..., 0].real
        return torch.as_tensor(a.astype(cdt), device=dev)

    mp = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                        dtype=dt, device=dev)
    return [("alm2map", (alm(batch),)),
            ("alm2map_adjoint", (mp(batch, npix),)),
            ("map2alm", (mp(batch, npix),)),
            ("alm2map_spin2", (alm(batch), alm(batch))),
            ("alm2map_spin2_adjoint", (mp(batch, npix), mp(batch, npix))),
            ("alm2map_teb", (alm(batch, 3),)),
            ("alm2map_teb_adjoint", (mp(batch, 3, npix),))]


# host arrays made ahead in prebuild_tables' thread: the degrade table of
# the sidelobe check, by (nside, ns_sl)
_PREBUILT = {}


def prebuild_tables(dev):
    """Host work of later phases, in a thread beside the kernels' phase 3:
    the table phase's spin_lambda_north at spin 0 and 2 (kept in its
    cache; a future of its seconds), then phase 6's sidelobe check's
    conviqt tables (kept in their cache) and degrade table (_PREBUILT)."""
    import concurrent.futures

    from commander_tpu_torch.sphere import wigner
    from commander_tpu_torch.tod import conviqt

    on_card = dev.type == "cuda"
    nside, lmax = TABLE_SIZE if on_card else (16, 32)
    tod_nside = 1024 if on_card else 32
    lsl, M = (SL_LMAX, SL_MMAX) if on_card else (24, 4)
    ns_sl = sl_nside(lsl, tod_nside)

    def build():
        t0 = time.perf_counter()
        for spin in (0, 2):
            wigner.spin_lambda_north(nside, lmax, spin, lmax)
        secs = time.perf_counter() - t0
        conviqt._conviqt_host(ns_sl, lsl, M)
        _PREBUILT[("degrade", tod_nside, ns_sl)] = conviqt.degrade_table(
            tod_nside, ns_sl)
        return secs

    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(build)
    ex.shutdown(wait=False)
    return fut


def table_phase(dev, prebuilt=None) -> dict:
    """Phase 3: the table SHT path (sphere/sht.get_plan(tables=True): the
    Legendre stage as one cuBLAS bmm over m against the tables, TF32 off)
    at bench.py's headline size, nside 256 / lmax 512, batch 8: spin 0
    (synthesis, adjoint, map2alm), spin 2 and T/E/B (synthesis and adjoint)
    in float32, each against the float64 table plan's transform (the
    host's float64 recurrence; tests/test_torch_sht_tables.py holds it to
    the JAX package's table plans) to TOL of the max, and against the
    kernel route's plan: the kernels' float32 recurrence is itself off the
    float64 transform by more than TOL here (ROADMAP queue 3), so the table
    path is held within that distance plus TOL of the kernels; the T/E/B
    pair's adjointness under the alm metric to TOL; no kernel launched by a
    table plan. Reported: the tables' bytes, the recurrence's host seconds
    (prebuilt: prebuild_tables' future, made beside the kernels' phase) and
    the plan's build (layout and copy to the card), ms per transform by
    CUDA events for the tables and for the kernels. The rehearsal: nside 16
    / lmax 32."""
    from commander_tpu_torch.sphere import cuda_sht, sht, wigner
    from commander_tpu_torch.sphere.alm import alm_dot

    on_card = dev.type == "cuda"
    nside, lmax = TABLE_SIZE if on_card else (16, 32)
    timer = Timer(dev)
    host_s = prebuilt.result() if prebuilt is not None else None
    t0 = time.perf_counter()
    pt = sht.get_plan(nside, lmax, spin2=True, dtype=torch.float32,
                      device=dev, tables=True)
    _sync()
    build_s = time.perf_counter() - t0
    p64 = sht.get_plan(nside, lmax, spin2=True, dtype=torch.float64,
                       device=dev, tables=True)
    wigner.spin_lambda_north.cache_clear()
    pk = sht.get_plan(nside, lmax, spin2=True, dtype=torch.float32,
                      device=dev)
    to64 = lambda x: x.to(torch.complex128 if x.is_complex()
                          else torch.float64)
    rows = {}
    for name, args in _table_calls(nside, lmax, TABLE_BATCH, torch.float32,
                                   dev, 11):
        fn = getattr(sht, name)
        exact = _listed(fn(p64, *map(to64, args)))
        ref = _listed(fn(pk, *args))
        n0 = dict(cuda_sht.LAUNCHES)
        got = _listed(fn(pt, *args))
        launched = sum(cuda_sht.LAUNCHES[k] - n0[k] for k in n0)
        err = lambda a, b: max(relmax(x, y) for x, y in zip(a, b))
        rows[name] = dict(
            err_vs_float64=err(got, exact), kernel_err_vs_float64=err(
                ref, exact), err_vs_kernel=err(got, ref),
            table_ms=timer(lambda: fn(pt, *args), 3),
            kernel_ms=timer(lambda: fn(pk, *args), 3),
            table_launches=launched)
        if name == "alm2map_teb":
            teb = args[0]
        if name == "alm2map_teb_adjoint":
            m3 = args[0]
        del exact, ref, got
    lhs = float(torch.sum(sht.alm2map_teb(pt, teb).double() * m3.double()))
    rhs = float(alm_dot(teb.to(torch.complex128),
                        sht.alm2map_teb_adjoint(pt, m3).to(
                            torch.complex128)))
    out = dict(nside=nside, lmax=lmax, batch=TABLE_BATCH,
               table_bytes=sht.table_bytes(nside, lmax, spin2=True,
                                           dtype=torch.float32),
               host_recurrence_s=host_s, plan_build_s=build_s,
               adjointness=abs(lhs - rhs) / abs(lhs), transforms=rows)
    say(f"[3] the table path (get_plan(tables=True), one bmm over m per "
        f"Legendre stage), float32, against the float64 table plan and the "
        f"kernel route: " + json.dumps(out))
    if not (all(r["err_vs_float64"] <= TOL and r["table_launches"] == 0
                and r["err_vs_kernel"] <= r["kernel_err_vs_float64"] + TOL
                for r in rows.values()) and out["adjointness"] <= TOL):
        raise AssertionError("the table path disagrees with the float64 "
                             "transform or the kernels, or launched one")
    del pt, pk, p64
    if on_card:
        torch.cuda.empty_cache()
    return out


def spin2_phase(dev, nside, lmax, batch=3, f64=True):
    """Phase 4: alm2map_spin2 / alm2map_spin2_adjoint, composed from two
    kernel calls per direction at mp -2 and +2, against the plain
    two-recurrence route alm2map_spin2_otf on the kernels' coefficient
    pack; then <Y a, m> = <a, Yt m> for the T/E/B pair."""
    from commander_tpu_torch.sphere import cuda_sht, sht, sht_otf
    from commander_tpu_torch.sphere.alm import alm_dot

    rng = np.random.default_rng(200 + nside)
    nl, npix = lmax + 1, 12 * nside * nside
    plan = sht.get_plan(nside, lmax, spin2=True, dtype=torch.float32,
                        device=dev)

    def alm(shape):
        a = rng.standard_normal(shape + (nl, nl)) \
            + 1j * rng.standard_normal(shape + (nl, nl))
        a *= np.tril(np.ones((nl, nl)))
        a[..., 0] = a[..., 0].real
        return torch.as_tensor(a.astype(np.complex64), device=dev)

    teb = alm((batch, 3))
    teb[:, 1:, :2] = 0.0
    E, B = teb[:, 1].contiguous(), teb[:, 2].contiguous()
    m = torch.as_tensor(rng.standard_normal((batch, 3, npix))
                        .astype(np.float32), device=dev)
    timer = Timer(dev)
    n0 = dict(cuda_sht.LAUNCHES)
    Q, U = sht.alm2map_spin2(plan, E, B)
    Eh, Bh = sht.alm2map_spin2_adjoint(plan, m[:, 1], m[:, 2])
    used = {k: cuda_sht.LAUNCHES[k] - n0[k] for k in n0}
    want = {"synth": 2, "adjoint": 2} if dev.type == "cuda" \
        else {"synth": 0, "adjoint": 0}
    if used != want:
        raise AssertionError(f"spin-2 transform pair launched {used}, "
                             f"expected {want}")
    plain = lambda: sht_otf.alm2map_spin2_otf(
        plan, cuda_sht.pack_otf(plan.otf_p2), cuda_sht.pack_otf(plan.otf_m2),
        E, B)
    Qp, Up = plain()
    scale = float(torch.maximum(Qp.abs().max(), Up.abs().max()))
    e_syn = max(absmax(Q, Qp), absmax(U, Up)) / scale
    # the composed adjoint is the adjoint of the plain synthesis
    lhs = float(torch.sum(Qp.double() * m[:, 1] + Up.double() * m[:, 2]))
    rhs = float(alm_dot(E.to(torch.complex128), Eh.to(torch.complex128))
                + alm_dot(B.to(torch.complex128), Bh.to(torch.complex128)))
    e_adj = abs(lhs - rhs) / abs(lhs)
    # the T/E/B pair
    lhs = float(torch.sum(sht.alm2map_teb(plan, teb).double() * m))
    rhs = float(alm_dot(teb.to(torch.complex128),
                        sht.alm2map_teb_adjoint(plan, m)
                        .to(torch.complex128)))
    e_teb = abs(lhs - rhs) / abs(lhs)
    t_k = timer(lambda: sht.alm2map_spin2(plan, E, B), 3)
    t_a = timer(lambda: sht.alm2map_spin2_adjoint(plan, m[:, 1], m[:, 2]), 3)
    t_p = timer(plain)
    # what the composition costs around its kernel calls: the Legendre stage
    # as the transforms run it (mask, stack, two calls, flip, cat; zero
    # entries and pads in the adjoint) against the bare calls on ready
    # batches of 2 x batch
    cp, cm = -(E + 1j * B), -(E - 1j * B)
    both = torch.stack([cp, cm])
    Gp, K = (torch.as_tensor(
        (rng.standard_normal((batch, plan.nring, nl)) + 1j
         * rng.standard_normal((batch, plan.nring, nl))).astype(np.complex64),
        device=dev) for _ in range(2))
    G2 = torch.stack([Gp[..., : plan.nh, :], K[..., : plan.nh, :]])
    t_stage = (
        timer(lambda: sht._legendre_synth_spin2_otf(plan, cp, cm), 3),
        timer(lambda: [sht_otf.synth_legendre_otf(o, both, plan.nh)
                       for o in (plan.otf_p2, plan.otf_m2)], 3),
        timer(lambda: sht._legendre_adjoint_spin2_otf(plan, Gp, K), 3),
        timer(lambda: [sht_otf.adjoint_legendre_otf(o, G2, G2)
                       for o in (plan.otf_p2, plan.otf_m2)], 3))
    del both, Gp, K, G2
    line = (f"[4] spin 2 at nside {nside} lmax {lmax} batch {batch}: "
            f"composed vs plain two-recurrence route {e_syn:.2e} of the max;"
            f" composed adjoint vs plain synthesis (adjointness) "
            f"{e_adj:.2e}; T/E/B adjointness {e_teb:.2e}; ms alm2map_spin2 "
            f"{t_k:.2f} (plain route {t_p:.1f}), its adjoint {t_a:.2f}; "
            f"Legendre stage as composed / its two bare kernel calls: "
            f"synthesis {t_stage[0]:.2f} / {t_stage[1]:.2f}, adjoint "
            f"{t_stage[2]:.2f} / {t_stage[3]:.2f}")
    if f64:
        # float64 plain transform on unrounded coefficients: the float32
        # recurrences' own error at mp -2 / +2 (reported, not gated)
        p64 = sht.get_plan(nside, lmax, spin2=True, dtype=torch.float64,
                           device=dev)
        Q64, U64 = sht_otf.alm2map_spin2_otf(
            p64, p64.otf_p2, p64.otf_m2, E.to(torch.complex128),
            B.to(torch.complex128))
        e64 = max(absmax(Q, Q64), absmax(U, U64)) / float(
            torch.maximum(Q64.abs().max(), U64.abs().max()))
        rms64 = float(torch.sqrt(((Q - Q64) ** 2 + (U - U64) ** 2).mean()
                                 / (Q64 ** 2 + U64 ** 2).mean()))
        line += (f"; float32 transform vs float64 plain transform: max "
                 f"{e64:.2e} of the max, rms {rms64:.2e} of the rms")
        del p64, Q64, U64
    say(line)
    if not (e_syn <= TOL and e_adj <= TOL and e_teb <= TOL):
        raise AssertionError(f"spin-2 transform at nside {nside} disagrees "
                             f"with its plain route: {e_syn}, {e_adj}, "
                             f"{e_teb}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _entry_draws(shape, C, S, lmax, nbins, nslot=0):
    """The draws of an entry step, float64 on the CPU, from a generator
    seeded 1 (eta1 over the data, eta2 over the alms, then with nslot the
    index uniforms) and the C_l gammas from numpy: made alike beside the
    card's step and in the reference worker (phase5_worker)."""
    from commander_tpu_torch.sphere.alm import random_alm_white

    gen = torch.Generator()
    gen.manual_seed(1)
    d = {"eta1": torch.randn(shape, generator=gen, dtype=torch.float64),
         "eta2": random_alm_white(gen, (C, S, lmax + 1, lmax + 1)),
         "gamma": torch.as_tensor(np.random.default_rng(2).gamma(
             50.0, size=(C, S, nbins)))}
    if nslot:
        d["u"] = torch.rand(nslot, generator=gen, dtype=torch.float64)
    return d


def _to_dev(draws, dev):
    """Draws on the card: alms complex64, the uniforms float64, the rest
    float32."""
    return {k: v.to(dev, torch.complex64 if v.is_complex() else (
        torch.float64 if k == "u" else torch.float32))
        for k, v in draws.items()}


def entry_phase(dev, p5, preset, nside, lmax):
    """Phase 5: one Gibbs step of an entry preset on `dev` (float32) against
    the same step in float64 on the CPU (the worker's, phase5_worker), with
    the same draws."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import gibbs

    kw = dict(entry.PRESETS[preset], nside=nside, lmax=lmax)
    plan, sys_d, cfg, _ = entry.build_problem(dtype=torch.float32,
                                              device=dev, **kw)
    C, S = sys_d.F.shape[1], sys_d.F.shape[2]
    to_d = _to_dev(_entry_draws(tuple(sys_d.data.shape), C, S, lmax,
                                len(cfg.cl_cfg.bin_starts)), dev)
    st_d = entry.initial_state(cfg, sys_d)
    t0 = time.perf_counter()
    new_d = gibbs.gibbs_step(cfg, sys_d, plan, st_d, draws=to_d)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    new_c = phase5_result(p5, preset)
    e_a = relmax(new_d.a.cpu(), new_c["a"])
    # bins whose modes carry no power (E, B below l = 2) are 0 on both sides
    ref = new_c["cl_bins"]
    e_cl = float(((new_d.cl_bins.cpu().double() - ref).abs()
                  / ref.abs().clamp(min=1e-30 * float(ref.abs().max())))
                 .max())
    finite = bool(torch.isfinite(torch.view_as_real(new_d.a)).all()
                  and torch.isfinite(new_d.cl_bins).all())
    say(f"[5] {preset} nside {nside} lmax {lmax} (S = {S}): {secs:.3f} s, CG "
        f"iters {new_d.cg_iters} relres {new_d.cg_relres:.2e}; vs CPU "
        f"float64 step: a {e_a:.2e} cl_bins {e_cl:.2e}")
    if not finite or not e_a <= 1e-3 or not e_cl <= 1e-3 \
            or new_d.cg_relres > cfg.cg_tol:
        raise AssertionError(f"{preset} step disagrees with the CPU "
                             f"reference")


def _p5_entry(job):
    """The worker's float64 step of entry_phase."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import gibbs

    kw = dict(entry.PRESETS[job["preset"]], nside=job["nside"],
              lmax=job["lmax"])
    plan_c, sys_c, cfg, _ = entry.build_problem(dtype=torch.float64,
                                                device="cpu", **kw)
    draws = _entry_draws(tuple(sys_c.data.shape), sys_c.F.shape[1],
                         sys_c.F.shape[2], job["lmax"],
                         len(cfg.cl_cfg.bin_starts))
    new_c = gibbs.gibbs_step(dataclasses.replace(cfg, cg_tol=1e-10,
                                                 cg_maxiter=200),
                             sys_c, plan_c, entry.initial_state(cfg, sys_c),
                             draws=draws)
    return dict(a=new_c.a, cl_bins=new_c.cl_bins)


def main_path_phase(dev, preset, steps, deep_iters, **overrides):
    """Phase 6: one main path: `steps` Gibbs steps of `preset` from a seeded
    generator, the launch counts set to 0 before them and read after them;
    returns those counts and a dict of what was measured. After the counts
    are read: the reduced chi-square of the last state, and one more step
    with a CG tolerance float32 cannot reach and at most `deep_iters`
    iterations (the solve ends earlier only when its float32 residual is
    exhausted: exactly 0, or too small for the next step): the presets'
    synthetic white data converge in a few iterations, a solve on real maps
    takes 80-100, and this step shows what an iteration costs."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import chisq, gibbs
    from commander_tpu_torch.sphere import cuda_sht

    t0 = time.perf_counter()
    plan, sys_d, cfg, _ = entry.build_preset(preset, torch.float32, dev,
                                             seed=0, **overrides)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = entry.initial_state(cfg, sys_d)
    S = sys_d.F.shape[2]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    say(f"[6] {preset} preset nside {plan.nside} lmax {plan.lmax} bands "
        f"{sys_d.F.shape[0]} comps {sys_d.F.shape[1]} Stokes {S}: set-up "
        f"{time.perf_counter() - t0:.1f} s")
    # wrapper calls per transform: spin 0 alone, or spin 0 and the two
    # spin-2 recurrences (mp -2 and +2)
    per_transform = 3 if S == 3 else 1
    for k in cuda_sht.LAUNCHES:
        cuda_sht.LAUNCHES[k] = 0
    secs_all, mem = [], None
    for step in range(steps):
        n0 = dict(cuda_sht.LAUNCHES)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = gibbs.gibbs_step(cfg, sys_d, plan, state, gen)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs_all.append(time.perf_counter() - t0)
        if dev.type == "cuda":
            mem = torch.cuda.max_memory_allocated() / 2**30
        d_syn = cuda_sht.LAUNCHES["synth"] - n0["synth"]
        d_adj = cuda_sht.LAUNCHES["adjoint"] - n0["adjoint"]
        say(f"[6] {preset} step {step + 1}: {secs_all[-1]:.2f} s, CG iters "
            f"{state.cg_iters}, relres {state.cg_relres:.2e}, peak device "
            f"memory {mem if mem is None else round(mem, 2)} GiB, launches "
            f"synth {d_syn} adjoint {d_adj}, cl_bins[cmb] "
            f"{state.cl_bins[0, :, :4].tolist()}")
        finite = bool(torch.isfinite(torch.view_as_real(state.a)).all()
                      and torch.isfinite(state.cl_bins).all())
        if not finite:
            raise AssertionError("non-finite sampler state")
        if not (state.cg_relres <= cfg.cg_tol
                or state.cg_iters == cfg.cg_maxiter):
            raise AssertionError("CG neither converged nor hit maxiter")
        # one synthesis and one adjoint transform per operator application
        # (CG's initial A(x0) plus one per iteration), one more adjoint
        # transform for the rhs
        n_apply = state.cg_iters + 1
        want = (per_transform * n_apply, per_transform * (n_apply + 1)) \
            if dev.type == "cuda" else (0, 0)
        if (d_syn, d_adj) != want:
            raise AssertionError(f"launch counts {(d_syn, d_adj)} != {want}")
    launches = dict(cuda_sht.LAUNCHES)

    chi2, _, ndof = chisq.compute_chisq(sys_d, plan, state.a)
    red = float(chi2) / int(ndof)
    say(f"[6] {preset}: reduced chi-square of the last state {red:.4f} "
        f"({int(ndof)} unmasked pixels)")
    if not np.isfinite(red):
        raise AssertionError("non-finite chi-square")

    deep = dataclasses.replace(cfg, cg_tol=1e-30, cg_maxiter=deep_iters)
    t0 = time.perf_counter()
    state = gibbs.gibbs_step(deep, sys_d, plan, state, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    per_apply = secs / (state.cg_iters + 1) * 1e3
    say(f"[6] {preset} deep step: {secs:.2f} s with {state.cg_iters} CG "
        f"iterations, relres {state.cg_relres:.2e} ({per_apply:.1f} ms per "
        f"operator application, rhs and C_l draw included)")
    if state.cg_iters < min(10, deep_iters) or not bool(
            torch.isfinite(torch.view_as_real(state.a)).all()):
        raise AssertionError("the deep step did not run its iterations")
    del sys_d, plan, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches, dict(step_s=secs_all, peak_gib=mem, chisq_red=red,
                          deep_ms_per_apply=per_apply)


def _finite_state(state) -> bool:
    return bool(torch.isfinite(torch.view_as_real(state.a)).all()
                and torch.isfinite(state.cl_bins).all())


def _grid_steps(slots):
    return [(s.cfg.grid_max - s.cfg.grid_min) / (s.cfg.ngrid - 1)
            for s in slots]


def entry_full_phase(dev, p5, nside, lmax):
    """Phase 5, the whole iteration: one full_gibbs_step of entry_full on
    `dev` (float32) against the same step in float64 on the CPU (the
    worker's), on the same data (the card's, phase5_start) with the same
    draws (eta1, eta2, gamma and the index uniforms)."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import full_gibbs

    pd = p5["keep"]["entry_full"]
    C, S = pd.sys.F.shape[1], pd.sys.F.shape[2]
    to_d = _to_dev(_entry_draws(tuple(pd.sys.data.shape), C, S, lmax,
                                len(pd.cfg.cl_cfg.bin_starts),
                                len(pd.slots)), dev)
    t0 = time.perf_counter()
    new_d, th_d, _ = full_gibbs.full_gibbs_step(
        pd.cfg, pd.comps, pd.bps, pd.slots, pd.sys, pd.plan,
        entry.initial_state(pd.cfg, pd.sys), pd.thetas0, draws=to_d,
        beam_consistent=pd.beam_consistent)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ref = phase5_result(p5, "entry_full")
    e_a = relmax(new_d.a.cpu(), ref["a"])
    e_th = [abs(float(d) - float(c)) / h for d, c, h in zip(
        th_d.cpu(), ref["th"], _grid_steps(pd.slots))]
    say(f"[5] entry_full nside {nside} lmax {lmax} (S = {S}, "
        f"{len(pd.slots)} slots): {secs:.3f} s, CG iters {new_d.cg_iters} "
        f"relres {new_d.cg_relres:.2e}; theta {th_d.tolist()}; vs CPU "
        f"float64 step: a {e_a:.2e}, theta (grid steps) "
        f"{[f'{e:.1e}' for e in e_th]}")
    if not _finite_state(new_d) or not e_a <= 1e-3 or not max(e_th) <= 0.05:
        raise AssertionError("entry_full step disagrees with the CPU "
                             "reference")


def _p5_full(job):
    """The worker's float64 step of entry_full_phase."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import full_gibbs

    pc = entry.build_preset("entry_full", torch.float64, "cpu",
                            nside=job["nside"], lmax=job["lmax"])
    sys_c = dataclasses.replace(pc.sys, data=job["data"])
    draws = _entry_draws(tuple(sys_c.data.shape), sys_c.F.shape[1],
                         sys_c.F.shape[2], job["lmax"],
                         len(pc.cfg.cl_cfg.bin_starts), len(pc.slots))
    new_c, th_c, _ = full_gibbs.full_gibbs_step(
        dataclasses.replace(pc.cfg, cg_tol=1e-10, cg_maxiter=200), pc.comps,
        pc.bps, pc.slots, sys_c, pc.plan, entry.initial_state(pc.cfg, sys_c),
        pc.thetas0, draws=draws, beam_consistent=pc.beam_consistent)
    return dict(a=new_c.a, th=th_c)


def full_path_phase(dev, preset, steps, **overrides):
    """Phase 6, the whole Gibbs iteration: `steps` full_gibbs_step calls of
    `preset` from its start values and a seeded generator, the launch
    counts set to 0 before them and read after them; returns those counts
    and a dict of what was measured. Outside the counts: the index draws
    given the true amplitudes and indices, the float32 lnL grid of the
    first slot against the same grid from float64 inputs, and the index
    phase alone under CUDA events."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import amplitude, chisq, full_gibbs
    from commander_tpu_torch.sampling import specind
    from commander_tpu_torch.sphere import cuda_sht

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    timer = Timer(dev)
    t0 = time.perf_counter()
    pb = entry.build_preset(preset, torch.float32, dev, seed=0, **overrides)
    sync()
    B, C, S = pb.sys.F.shape
    nslot = len(pb.slots)
    hs = _grid_steps(pb.slots)
    say(f"[6] {preset} preset nside {pb.plan.nside} lmax {pb.plan.lmax} "
        f"bands {B} comps {C} Stokes {S} slots {nslot} (simulated sky, "
        f"theta_true {list(pb.theta_true)}): set-up "
        f"{time.perf_counter() - t0:.1f} s")
    index_args = (pb.comps, pb.bps, pb.slots, pb.sys, pb.plan)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # the index conditionals where their answer is known: the amplitudes
    # and every other index at the truth (components rebuilt with theta0 =
    # truth, one slot free at a time, from its start value). The posterior
    # is far narrower than a grid step, so the trapezoid CDF has its mass on
    # the two intervals around the best grid point, and the draw lies
    # within one step of the truth's nearest grid point.
    truth = torch.tensor(pb.theta_true, dtype=torch.float64, device=dev)
    true_comps = [dataclasses.replace(c, theta0=tuple(
        float(t) for t in full_gibbs.theta_tuple(pb.comps, pb.slots,
                                                 pb.theta_true)[ci]))
        for ci, c in enumerate(pb.comps)]
    th_c = torch.cat([full_gibbs.sample_indices(
        true_comps, pb.bps, pb.slots[i:i + 1], pb.sys, pb.plan, pb.a_true,
        pb.thetas0[i:i + 1], gen, beam_consistent=pb.beam_consistent)
        for i in range(nslot)])
    off = []
    for s, h, t, tt in zip(pb.slots, hs, th_c.tolist(), pb.theta_true):
        nearest = s.cfg.grid_min + h * round((tt - s.cfg.grid_min) / h)
        off.append((abs(t - nearest) / h, abs(t - tt) / h))
    say(f"[6] {preset}: index draws given the true amplitudes and the "
        f"other indices at the truth {th_c.tolist()}; distance in grid "
        f"steps from the truth's grid point {[round(o[0], 3) for o in off]}"
        f", from the truth {[round(o[1], 3) for o in off]}")
    # (a CPU rehearsal's few pixels leave the posterior wider than a step)
    if not bool(torch.isfinite(th_c).all()) or (
            on_card and max(o[0] for o in off) > 1.0 + 1e-9):
        raise AssertionError(f"{preset}: an index draw given the true "
                             f"amplitudes missed the truth's grid point by "
                             f"more than one step")

    # all slots in turn from the truth, as the step draws them: each slot is
    # conditioned on the draws before it, so a draw made up to a grid step
    # off is made up for by the next one where two indices trade off. The
    # steepest trade is dust beta against T_d below 100 GHz, where the
    # spectrum hardly depends on T_d: d ln S / d beta = ln(30 / 353) = -2.5
    # against d ln S / d T_d = -0.02 / K at 30 GHz, so 1.5 steps of beta
    # (0.04) are 13 steps of T_d (0.32 K each). Bound: SEQ_BOUND_STEPS.
    th_s = full_gibbs.sample_indices(*index_args, pb.a_true, truth, gen,
                                     beam_consistent=pb.beam_consistent)
    off_s = [abs(t - tt) / h
             for h, t, tt in zip(hs, th_s.tolist(), pb.theta_true)]
    say(f"[6] {preset}: index draws in slot order from the truth, given the "
        f"true amplitudes {th_s.tolist()}; distance from the truth in grid "
        f"steps {[round(o, 3) for o in off_s]} (bound {SEQ_BOUND_STEPS})")
    if not bool(torch.isfinite(th_s).all()) or (
            on_card and max(off_s) > SEQ_BOUND_STEPS):
        raise AssertionError(f"{preset}: the index draws in slot order from "
                             f"the truth left it by more than "
                             f"{SEQ_BOUND_STEPS} grid steps")

    # the float32 lnL grid against float64 (first slot, truth conditions)
    slot = pb.slots[0]
    sys_t = full_gibbs.system_at(pb.sys, pb.comps, pb.bps, pb.slots, truth)
    res = chisq.compute_residual(sys_t, pb.plan, pb.a_true, exclude=slot.ci)
    a_c = pb.a_true[slot.ci]
    amp_pix = amplitude._synth(pb.plan, a_c)
    amp_band = amplitude._synth(pb.plan, a_c[None] * sys_t.bl[..., None])
    th_slot = full_gibbs.theta_tuple(pb.comps, pb.slots, truth)[slot.ci]
    grid_of = lambda cast: specind._grid_lnL_total(
        pb.comps[slot.ci], pb.bps, slot.cfg, cast(res), cast(amp_pix),
        cast(sys_t.inv_rms2), th_slot, slot.which, amp_band=cast(amp_band))
    l32 = grid_of(lambda x: x)
    l64 = grid_of(lambda x: x.double())
    d = (l32 - l32.max()) - (l64 - l64.max())
    near = (l64 - l64.max()) > -50.0
    ms32 = timer(lambda: grid_of(lambda x: x))
    f64_in = [x.double() for x in (res, amp_pix, sys_t.inv_rms2, amp_band)]
    ms64 = timer(lambda: specind._grid_lnL_total(
        pb.comps[slot.ci], pb.bps, slot.cfg, f64_in[0], f64_in[1], f64_in[2],
        th_slot, slot.which, amp_band=f64_in[3]))
    lnl = dict(max_abs_dlnl=float(d.abs().max()),
               max_abs_dlnl_within_50=float(d[near].abs().max()),
               points_within_50=int(near.sum()),
               lnl_range=float(l64.max() - l64.min()),
               total_at_max=float(l64.max()),
               grid_ms_float32=ms32, grid_ms_float64=ms64)
    say(f"[6] {preset} float32 lnL grid (float64 pixel sums) against the "
        f"same grid from float64 inputs, slot 0, {slot.cfg.ngrid} points, "
        f"after subtracting each maximum: " + json.dumps(lnl))
    if not np.isfinite(lnl["max_abs_dlnl"]):
        raise AssertionError("non-finite lnL grid")
    del res, amp_pix, amp_band, f64_in, l32, l64, sys_t

    # the main path
    state = entry.initial_state(pb.cfg, pb.sys)
    thetas = pb.thetas0
    per_transform = 3 if S == 3 else 1
    per_slot = per_transform * (2 + int(pb.beam_consistent))
    for k in cuda_sht.LAUNCHES:
        cuda_sht.LAUNCHES[k] = 0
    secs_all, mem, history = [], None, []
    for step in range(steps):
        n0 = dict(cuda_sht.LAUNCHES)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, thetas, sys_new = full_gibbs.full_gibbs_step(
            pb.cfg, pb.comps, pb.bps, pb.slots, pb.sys, pb.plan, state,
            thetas, gen, beam_consistent=pb.beam_consistent)
        sync()
        secs_all.append(time.perf_counter() - t0)
        if on_card:
            mem = torch.cuda.max_memory_allocated() / 2**30
        d_syn = cuda_sht.LAUNCHES["synth"] - n0["synth"]
        d_adj = cuda_sht.LAUNCHES["adjoint"] - n0["adjoint"]
        th = thetas.tolist()
        history.append(th)
        dist = [round((t - tt) / h, 2)
                for t, tt, h in zip(th, pb.theta_true, hs)]
        say(f"[6] {preset} step {step + 1}: {secs_all[-1]:.2f} s, CG iters "
            f"{state.cg_iters}, relres {state.cg_relres:.2e}, theta {th} "
            f"({dist} grid steps from the truth), peak device memory "
            f"{mem if mem is None else round(mem, 2)} GiB, launches synth "
            f"{d_syn} adjoint {d_adj}")
        if mem is not None and mem > FULL_STEP_PEAK_GIB:
            raise AssertionError(f"peak device memory {mem:.2f} GiB above "
                                 f"{FULL_STEP_PEAK_GIB} GiB")
        in_range = all(s.cfg.grid_min <= t <= s.cfg.grid_max
                       for s, t in zip(pb.slots, th))
        if not _finite_state(state) or not in_range:
            raise AssertionError("non-finite sampler state or an index "
                                 "outside its grid")
        if not (state.cg_relres <= pb.cfg.cg_tol
                or state.cg_iters == pb.cfg.cg_maxiter):
            raise AssertionError("CG neither converged nor hit maxiter")
        # the CG as in main_path_phase; per slot the residual, the
        # amplitude map and the per-band beamed maps, no adjoint
        n_apply = state.cg_iters + 1
        want = (per_transform * n_apply + nslot * per_slot,
                per_transform * (n_apply + 1)) if on_card else (0, 0)
        if (d_syn, d_adj) != want:
            raise AssertionError(f"launch counts {(d_syn, d_adj)} != {want}")
    launches = dict(cuda_sht.LAUNCHES)

    # the index phase alone
    index_ms = timer(lambda: full_gibbs.sample_indices(
        *index_args, state.a, thetas, gen,
        beam_consistent=pb.beam_consistent))
    say(f"[6] {preset}: index phase alone {index_ms:.1f} ms for {nslot} "
        f"slots ({index_ms / nslot:.1f} ms per slot, of which the lnL grid "
        f"{lnl['grid_ms_float32']:.1f} ms)")
    chi2, _, ndof = chisq.compute_chisq(sys_new, pb.plan, state.a)
    red = float(chi2) / int(ndof)
    say(f"[6] {preset}: reduced chi-square of the last state at its own "
        f"theta {red:.4f} ({int(ndof)} unmasked pixels)")
    if not np.isfinite(red):
        raise AssertionError("non-finite chi-square")
    del pb, state, sys_new
    if on_card:
        torch.cuda.empty_cache()
    return launches, dict(step_s=secs_all, peak_gib=mem, chisq_red=red,
                          theta=history,
                          theta_given_true_amplitudes=th_c.tolist(),
                          theta_in_turn_from_truth=th_s.tolist(),
                          index_ms=index_ms, lnl_float32=lnl)


def _entry_tod_draws(pb_bands_c, sys_c, cfg, nslot, lmax, gen, ts=None,
                     ps=None):
    """The draws of one tod_gibbs_step on the CPU in float64: one pass's per
    band, then the amplitude, C_ell and index draws, and the template and
    source rows' draws where the model has them."""
    from commander_tpu_torch.sphere.alm import random_alm_white
    from commander_tpu_torch.tod.process import pass_draws

    C, S = sys_c.F.shape[1], sys_c.F.shape[2]
    draws = {
        "tod": [pass_draws(b.cfg, b.block, gen) for b in pb_bands_c],
        "eta1": torch.randn(sys_c.data.shape, generator=gen,
                            dtype=torch.float64),
        "eta2": random_alm_white(gen, (C, S, lmax + 1, lmax + 1)),
        "gamma": torch.as_tensor(np.random.default_rng(2).gamma(
            50.0, size=(C, S, len(cfg.cl_cfg.bin_starts)))),
        "u": torch.rand(nslot, generator=gen, dtype=torch.float64),
    }
    if ts is not None:
        draws["eta_t"] = torch.randn(ts.ntemp, generator=gen,
                                     dtype=torch.float64)
    if ps is not None:
        draws["eta_p"] = torch.randn(ps.pix.shape[0], generator=gen,
                                     dtype=torch.float64)
    return draws


def _grid_index(values, grid):
    """The index of each value's nearest grid point."""
    return torch.argmin((values.double().cpu()[..., None]
                         - grid.double().cpu()).abs(), dim=-1)


def entry_tod_phase(dev, p5, nside, lmax, preset="entry_tod"):
    """Phase 5, the iteration from TOD: one tod_gibbs_step of entry_tod (the
    TOD pass of its three bands, the system update, the whole iteration)
    on `dev` in float32 against the same step in float64 on the CPU (the
    worker's), on the same TOD and map-level data (the card's,
    phase5_start) with the same draws, from the true amplitudes; both CGs
    run ENTRY_TOD_CG_ITERS iterations. Held: hit masks identical, binned
    maps to 1e-4 of their max at the hit pixels, PSD grid indices identical
    (or the draw within PSD_CDF_MARGIN of a CDF step), amplitudes to 1e-3,
    every index to 0.05 of its grid step. Once with each preconditioner of
    ENTRY_TOD_PRECONDS, from the same inputs.

    preset="entry_joint": the whole model with the joint system's template
    and source rows, from the true (a, t, p), once, with its diagonal
    preconditioner at the preset's own CG tol 1e-6: its pinned relquad row
    ends the relative-residual test after a few iterations (ROADMAP queue
    3), so both sides must stop at the same count, and the template and
    source amplitudes are held to 1e-3 of their max as well."""
    pd = p5["keep"][preset]
    bands_c = p5["keep"][preset + "_bands"]
    gen = torch.Generator()
    gen.manual_seed(1)
    draws = _entry_tod_draws(bands_c, pd.sys, pd.cfg, len(pd.slots), lmax,
                             gen, pd.ts, pd.ps)
    to_d = {k: v.to(dev, torch.complex64 if v.is_complex() else (
        torch.float64 if k == "u" else torch.float32))
        for k, v in draws.items() if k != "tod"}
    to_d["tod"] = draws["tod"]      # process_tod moves and casts them
    for i, setting in enumerate(_tod_settings(pd)):
        _entry_tod_step(dev, nside, lmax, p5, preset, pd, bands_c, draws,
                        to_d, setting, i)


def _tod_settings(pd):
    """entry_tod's preconditioner settings; entry_joint's one (its own)."""
    return ENTRY_TOD_PRECONDS if pd.ts is None else ({},)


def _tod_step_cfg(cfg, setting, joint):
    """The step's GibbsConfig: entry_joint's at its own tol, entry_tod's
    CG cut at ENTRY_TOD_CG_ITERS iterations."""
    return dataclasses.replace(cfg, **setting) if joint else \
        dataclasses.replace(cfg, cg_tol=1e-30,
                            cg_maxiter=ENTRY_TOD_CG_ITERS, **setting)


def _p5_tod(job):
    """The worker's float64 steps of entry_tod_phase (one per setting), on
    the card's data and TOD: the new TOD states, the system's data and
    inv_rms, the amplitudes, the CG's iterations and relres, theta."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import tod_gibbs

    pc = entry.build_preset(job["preset"], torch.float64, "cpu",
                            **dict(job["kw"], tod=None))
    sys_c = dataclasses.replace(pc.sys, data=job["data"])
    bands_c = job["bands"]
    gen = torch.Generator()
    gen.manual_seed(1)
    draws = _entry_tod_draws(bands_c, sys_c, job["cfg"], len(pc.slots),
                             job["kw"]["lmax"], gen, pc.ts, pc.ps)
    out = []
    for setting in _tod_settings(pc):
        cfg = _tod_step_cfg(job["cfg"], setting, pc.ts is not None)
        st_c = dataclasses.replace(
            entry.initial_state(pc.cfg, sys_c, ts=pc.ts, ps=pc.ps),
            a=job["a"], t=job["t"], p=job["p"])
        bc, sc, nc, thc = tod_gibbs.tod_gibbs_step(
            cfg, pc.comps, pc.bps, pc.slots, bands_c, sys_c, pc.plan, st_c,
            pc.thetas0, first=True, draws=draws, beam_consistent=True,
            ts=pc.ts, ps=pc.ps)
        out.append(dict(states=[b.state for b in bc], data=sc.data,
                        inv_rms=sc.inv_rms, a=nc.a, t=nc.t, p=nc.p,
                        cg_iters=nc.cg_iters, cg_relres=nc.cg_relres,
                        th=thc))
    return out


def _entry_tod_step(dev, nside, lmax, p5, preset, pd, bands_c, draws, to_d,
                    setting, k):
    """entry_tod_phase's step and checks with the preconditioner `setting`
    (GibbsConfig fields; the k-th of the worker's references)."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import chisq, full_gibbs, tod_gibbs
    from commander_tpu_torch.tod import model as tm
    from commander_tpu_torch.tod.process import TodConfig

    joint = pd.ts is not None
    cfg = _tod_step_cfg(pd.cfg, setting, joint)
    name = ", ".join(f"{k_}={v}" for k_, v in setting.items()) \
        or "diagonal"
    st_d = dataclasses.replace(
        entry.initial_state(pd.cfg, pd.sys, ts=pd.ts, ps=pd.ps),
        a=pd.a_true, t=pd.t_true, p=pd.p_true)
    t0 = time.perf_counter()
    bd, sd, nd, thd = tod_gibbs.tod_gibbs_step(
        cfg, pd.comps, pd.bps, pd.slots, pd.bands, pd.sys, pd.plan, st_d,
        pd.thetas0, first=True, draws=to_d, beam_consistent=True, ts=pd.ts,
        ps=pd.ps)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ref = phase5_result(p5, preset)[k]
    nc, thc = types.SimpleNamespace(**ref), ref["th"]
    bc = [tod_gibbs.TodBand(b.cfg, b.block, st, {})
          for b, st in zip(bands_c, ref["states"])]
    hit_d, hit_c = (sd.inv_rms > 0).cpu(), ref["inv_rms"] > 0
    n_hit_diff = int((hit_d != hit_c).sum())
    e_map = float((sd.data.cpu().double() - ref["data"])[hit_c].abs().max()
                  / ref["data"][hit_c].abs().max())
    grids = TodConfig(nside=nside, nu=1.0)
    ga = torch.tensor(grids.alpha_grid, dtype=torch.float64)
    gf = torch.tensor(grids.fknee_grid, dtype=torch.float64)
    pc = sky_c = None
    psd_diff, margins = 0, []
    for b, (x, y, band) in enumerate(zip(bd, bc, bands_c)):
        idx_d = _grid_index(x.state.alpha, ga) * len(gf) \
            + _grid_index(x.state.fknee, gf)
        idx_c = _grid_index(y.state.alpha, ga) * len(gf) \
            + _grid_index(y.state.fknee, gf)
        bad = idx_d != idx_c
        if not bool(bad.any()):
            continue
        psd_diff += int(bad.sum())
        if sky_c is None:
            # the CPU float64 model sky at the start (a CPU build)
            pc = pc or _p5_problem(p5, preset)
            c64 = lambda x: None if x is None else x.cpu().double()
            sys_c = dataclasses.replace(pc.sys,
                                        data=pd.sys.data.double().cpu())
            sky_c = chisq.full_sky(full_gibbs.system_at(
                sys_c, pc.comps, pc.bps, pc.slots, pc.thetas0), pc.plan,
                pd.a_true.cpu().to(torch.complex128), pc.ts, pc.ps,
                c64(pd.t_true), c64(pd.p_true))
        # the CDF margin of the CPU pass's draw at those (scan, det)
        blk = band.block
        s_ref = tm.project_sky(sky_c[b], blk.pix, blk.psi, band.cfg.pol) \
            + tm.orbital_dipole(blk.vsun, torch.as_tensor(
                tod_gibbs.pixel_vectors(nside, torch.float64, "cpu")),
                band.cfg.nu, blk.pix)
        resid = blk.tod - y.state.gain[..., None] * s_ref
        cdf = tm.psd_grid_cdf(resid, blk.mask, blk.fsamp, ga, gf,
                              y.state.sigma0)
        cdf = cdf / cdf[..., -1:]
        u = draws["tod"][b]["psd_u"][..., None]
        margin = (cdf - u).abs().min(dim=-1).values
        margins += [dict(band=b, scan=int(i), det=int(j),
                         index_card=int(idx_d[i, j]),
                         index_cpu=int(idx_c[i, j]),
                         cdf_margin=float(margin[i, j]))
                    for i, j in bad.nonzero().tolist()]
    e_a = relmax(nd.a.cpu(), nc.a)
    e_tp = [relmax(getattr(nd, k).cpu(), getattr(nc, k))
            for k in ("t", "p") if getattr(nc, k) is not None]
    e_th = [abs(float(d) - float(c)) / h for d, c, h in zip(
        thd.cpu(), thc, _grid_steps(pd.slots))]
    nsamp = sum(b.block.tod.numel() for b in pd.bands)
    iters = (f"CG to tol {cfg.cg_tol:g}: {nd.cg_iters} / {nc.cg_iters} "
             f"iterations" if joint else
             f"{ENTRY_TOD_CG_ITERS} CG iterations on both sides")
    say(f"[5] {preset} nside {nside} lmax {lmax} ({len(pd.bands)} bands, "
        f"{len(pd.comps)} components, {len(pd.slots)} slots, {nsamp} "
        f"samples, {iters}, preconditioner {name}): {secs:.3f} s on "
        f"{dev.type}, relres {nd.cg_relres:.2e} / "
        f"{nc.cg_relres:.2e}; vs CPU float64 step: t, p {e_tp}, "
        f"hit pixels differing "
        f"{n_hit_diff} of {hit_c.numel()} ({float(hit_c.double().mean()):.3f}"
        f" solved), binned maps {e_map:.2e} of the max, PSD indices "
        f"differing {psd_diff} {margins}, a {e_a:.2e}, theta (grid steps) "
        f"{[f'{e:.1e}' for e in e_th]}")
    # (the CPU rehearsal holds the pseudo-inverse's amplitudes and indices
    # on the card only: at its nside 16 that CG stands at relres 0.2 after
    # the 30 iterations, where a float32 and a float64 run part by up to
    # 3.5e-3 of the amplitudes and 1.2 grid steps of T_d, also at nside 32;
    # at the card's nside 64 the float32 run on the CPU agrees to 1.2e-4
    # and 4e-4 steps, PERF.md)
    held = dev.type == "cuda" or setting.get("cg_precond") != "pseudoinv"
    if joint:
        pc = pc or _p5_problem(p5, preset)
        sc = dataclasses.replace(pc.sys, data=ref["data"],
                                 inv_rms=ref["inv_rms"],
                                 inv_rms2=ref["inv_rms"] ** 2)
        _hold_joint(nd, nc, thd, sc, pc, draws, e_tp,
                    dict(finite=_finite_state(nd), hit_diff=n_hit_diff,
                         map=e_map, margins=margins))
        return
    if not (_finite_state(nd) and n_hit_diff == 0 and e_map <= 1e-4
            and all(m["cdf_margin"] <= PSD_CDF_MARGIN for m in margins)
            and (not held or (e_a <= 1e-3 and max(e_th) <= 0.05))):
        raise AssertionError(f"{preset} step ({name}) disagrees with the "
                             f"CPU reference")


def _hold_joint(nd, nc, thd, sc, pc, draws, e_tp, tod):
    """What phase 5 holds of the entry_joint step (card nd, thd against the
    CPU float64 step nc; sc the CPU's system after its TOD pass). The five
    diffuse components on three bands leave directions to the priors alone,
    where the float32 step's amplitudes stand 1e-3-1e-2 of their max from
    the float64 ones (ROADMAP queue 3, item 7c: a float32 step on the CPU
    stands 3.8e-3 off, PERF.md), and the index draws made from those
    amplitudes follow them. So the step is held in its parts: the TOD pass
    as entry_tod's (hit masks and PSD indices identical, maps to 1e-4), the
    same CG iteration count, the template amplitudes t to 1e-3 of their
    max, the full model sky the amplitudes make (diffuse, templates and
    sources), in data space, to 1e-3 of its max, and the index phase given
    the card's amplitudes: the CPU float64 index draws from the card's (a,
    t, p) with the same uniforms, each within 0.05 grid step of the card's.
    The diffuse and source amplitudes are reported."""
    from commander_tpu_torch.sampling import chisq, full_gibbs, joint

    sys_c = full_gibbs.system_at(sc, pc.comps, pc.bps, pc.slots, pc.thetas0)
    a_d = nd.a.cpu().to(torch.complex128)
    t_d, p_d = nd.t.cpu().double(), nd.p.cpu().double()
    sky_d = chisq.full_sky(sys_c, pc.plan, a_d, pc.ts, pc.ps, t_d, p_d)
    sky_c = chisq.full_sky(sys_c, pc.plan, nc.a, pc.ts, pc.ps, nc.t, nc.p)
    e_sky = relmax(sky_d, sky_c)
    extra = joint.extra_sky(pc.ts, pc.ps, t_d, p_d, sys_c.data.shape[-1])
    th_ref = full_gibbs.sample_indices(
        pc.comps, pc.bps, pc.slots, sys_c, pc.plan, a_d, pc.thetas0,
        u=draws["u"], beam_consistent=True, extra_sky=extra)
    e_idx = [abs(float(d) - float(c)) / h for d, c, h in zip(
        thd.cpu(), th_ref, _grid_steps(pc.slots))]
    say(f"[5] entry_joint held in parts: CG iterations {nd.cg_iters} / "
        f"{nc.cg_iters}; t {e_tp[0]:.2e} of its max (bound 1e-3); the full "
        f"model sky in data space {e_sky:.2e} of its max (bound 1e-3); index "
        f"draws given the card's amplitudes, CPU float64 against the card, "
        f"grid steps {[f'{e:.1e}' for e in e_idx]} (bound 0.05); reported: "
        f"a {relmax(nd.a.cpu(), nc.a):.2e}, p {e_tp[1]:.2e} of their max")
    if not (tod["finite"] and tod["hit_diff"] == 0 and tod["map"] <= 1e-4
            and all(m["cdf_margin"] <= PSD_CDF_MARGIN
                    for m in tod["margins"])
            and nd.cg_iters == nc.cg_iters and e_tp[0] <= 1e-3
            and e_sky <= 1e-3 and max(e_idx) <= 0.05):
        raise AssertionError("entry_joint step disagrees with the CPU "
                             "reference")


def _tod_parts_ms(timer, band, sky_b, gen):
    """ms of the parts of one band's TOD pass on its current state, each
    called as process_tod calls it: projection (sky and orbital dipole),
    gain (per-scan GLS, abscal, relcal, Wiener smoothing), PSD, n_corr,
    binning (sorted gather, float64 run sums, 3x3 solves), and the whole
    pass."""
    from commander_tpu_torch.sampling.tod_gibbs import pixel_vectors
    from commander_tpu_torch.tod import model as tm
    from commander_tpu_torch.tod.process import _grids, process_tod

    cfg, blk, st = band.cfg, band.block, band.state
    dt, dev = blk.tod.dtype, blk.tod.device
    pv = pixel_vectors(cfg.nside, dt, str(dev))
    npix = 12 * cfg.nside ** 2
    mask = blk.mask
    proj = lambda: (tm.project_sky(sky_b, blk.pix, blk.psi, cfg.pol),
                    tm.orbital_dipole(blk.vsun, pv, cfg.nu, blk.pix))
    s_sky, s_orb = proj()
    s_ref = s_sky + s_orb
    del s_sky

    def gain():
        d = blk.tod - st.n_corr
        g = tm.sample_gain_perscan(d, s_ref, mask, st.sigma0, generator=gen)
        ga = tm.sample_abscal(d - g[..., None] * (s_ref - s_orb), s_orb,
                              mask, st.sigma0, generator=gen)
        tm.sample_relcal(d - ga * s_ref, s_ref, mask, st.sigma0,
                         generator=gen)
        w = torch.sum(s_ref * s_ref * mask, -1, dtype=torch.float64)
        tm.smooth_gain_wiener(g, (1.0 / torch.sqrt(w)).to(dt) * st.sigma0,
                              generator=gen)

    resid = blk.tod - st.gain[..., None] * s_ref
    ag, fg = _grids(cfg.alpha_grid, cfg.fknee_grid, str(dev))
    calib = (blk.tod - st.n_corr) / st.gain[..., None] - s_orb
    iv = st.gain ** 2 / st.sigma0 ** 2
    runs = blk.pixel_runs(npix)
    parts = {
        "projection": timer(proj),
        "gain": timer(gain),
        "psd": timer(lambda: tm.sample_noise_psd(
            resid, mask, blk.fsamp, ag, fg, generator=gen)),
        "n_corr": timer(lambda: tm.sample_ncorr(
            resid, mask, st.sigma0, st.alpha, st.fknee, blk.fsamp,
            generator=gen)),
        "binning": timer(lambda: tm.finalize_binned_map(*tm.bin_tod(
            calib, blk.pix, blk.psi, mask, iv, npix, cfg.pol, runs=runs),
            generator=gen)),
    }
    del resid, calib, s_ref, s_orb
    parts["whole pass"] = timer(lambda: process_tod(cfg, blk, st, sky_b, pv,
                                                    gen))
    return parts


def _device_busy_ms(fn, on_card):
    """(device ms of the kernels fn launched, host ms of fn ending in a
    synchronize) under torch.profiler; (None, host ms) off the card."""
    if not on_card:
        t0 = time.perf_counter()
        fn()
        return None, (time.perf_counter() - t0) * 1e3
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    busy = sum(getattr(ev, "self_device_time_total", 0)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy, span


def tod_path_phase(dev, preset, steps, p5=None, **overrides):
    """Phase 6, the iteration from TOD: `preset` (tutorial_tod) simulated
    (its host seconds alone), the warm start from run.py's starting
    state (entry.prior_state; one amplitude step and three TOD passes,
    timed), then `steps` tod_gibbs_step calls with the launch
    counts set to 0 before them and read after them. Held: after the warm
    start every band's mean gain within GAIN_TOL of 1 and mean sigma0 within
    SIGMA0_TOL of the simulated one; per step the binned maps against the
    true band sky at solved pixels within BINNED_CHI2_BOUND (chi^2/dof per
    band and Stokes), finite state, CG converged or at maxiter, the launch
    counts, peak memory below TOD_STEP_PEAK_GIB. Outside the counts: each
    band's TOD pass under CUDA events and split by part, the TOD stage's
    device-busy share under the profiler, coverage."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import chisq, full_gibbs, tod_gibbs
    from commander_tpu_torch.sphere import cuda_sht
    from commander_tpu_torch.tod.model import project_sky
    from commander_tpu_torch.tod.process import process_tod

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    timer = Timer(dev)
    t0 = time.perf_counter()
    pb = entry.build_preset(preset, torch.float32, dev, seed=0, **overrides)
    sync()
    B, C, S = pb.sys.F.shape
    nslot = len(pb.slots)
    blk = pb.bands[0].block
    nsamp = sum(b.block.tod.numel() for b in pb.bands)
    say(f"[6] {preset} preset nside {pb.plan.nside} lmax {pb.plan.lmax} "
        f"bands {B} comps {C} Stokes {S} slots {nslot}, TOD {blk.nscan} "
        f"scans x {blk.ndet} detectors x {blk.ntod} samples per band "
        f"({nsamp} samples): set-up {time.perf_counter() - t0:.1f} s, of "
        f"which the TOD simulator {pb.sim_seconds:.1f} s of host time")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # the warm start
    sys0 = full_gibbs.system_at(pb.sys, pb.comps, pb.bps, pb.slots,
                                pb.thetas0)
    t0 = time.perf_counter()
    bands, state = tod_gibbs.tod_burnin(pb.cfg, pb.bands, sys0, pb.plan,
                                        entry.prior_state(pb.cfg, pb.sys),
                                        gen)
    sync()
    warm_s = time.perf_counter() - t0
    gains = [float(b.state.gain.double().mean()) for b in bands]
    s0_ratio = [float(b.state.sigma0.double().mean()) / b.truth["sigma0"]
                for b in bands]
    # what sigma0 should read: the simulated white noise plus the model
    # sky's own errors as the sample differences see them (the scan's
    # per-sample dither puts nearly every sample in a new pixel)
    sky_m = chisq.sky_signal(sys0, pb.plan, state.a)
    s0_expected = []
    for b, band in enumerate(bands):
        blk = band.block
        e = project_sky(sky_m[b] - pb.sky_true[b], blk.pix, blk.psi,
                        band.cfg.pol)
        m2 = blk.mask[..., 1:] * blk.mask[..., :-1]
        var_e = float(torch.sum((e[..., 1:] - e[..., :-1]) ** 2 * m2,
                                dtype=torch.float64) / torch.sum(
            m2, dtype=torch.float64) / 2.0)
        s0_expected.append(float(np.sqrt(band.truth["sigma0"] ** 2 + var_e)))
        del e, m2
    del sky_m, sys0
    s0_vs_expected = [float(b.state.sigma0.double().mean()) / x
                      for b, x in zip(bands, s0_expected)]
    psd = [(float(b.state.alpha.double().mean()),
            float(b.state.fknee.double().mean())) for b in bands]
    say(f"[6] {preset} warm start (1 amplitude step, CG iters "
        f"{state.cg_iters}, then 3 TOD passes): {warm_s:.2f} s; per band "
        f"mean gain {[round(g, 5) for g in gains]}, mean sigma0 / simulated "
        f"{[round(r, 5) for r in s0_ratio]}, / simulated with the model "
        f"sky's errors {[round(r, 5) for r in s0_vs_expected]} (expected "
        f"sigma0 {[round(x, 3) for x in s0_expected]}), mean (alpha, fknee) "
        f"{[(round(a, 3), round(f, 4)) for a, f in psd]} (simulated -1.5, "
        f"{pb.bands[0].truth['fknee']})")
    # (held on the card only, as BINNED_CHI2_BOUND: the rehearsal's nside 32
    # pixels are wider than the beams, and its gains move by up to 1.3%)
    if on_card and not (all(abs(g - 1.0) <= GAIN_TOL for g in gains)
                        and all(abs(r - 1.0) <= SIGMA0_TOL
                                for r in s0_vs_expected)):
        raise AssertionError(f"{preset}: gain or sigma0 not recovered by the "
                             f"warm start")

    # the main path: TOD_DIAG_STEPS steps with the diagonal preconditioner
    base, thetas = pb.sys, pb.thetas0
    for k in cuda_sht.LAUNCHES:
        cuda_sht.LAUNCHES[k] = 0
    launches = {"synth": 0, "adjoint": 0}
    secs_all, mem, history, chi2_all, diag = [], None, [], [], []
    cfg_diag = dataclasses.replace(pb.cfg, cg_maxiter=TOD_DIAG_MAXITER)
    for step in range(steps):
        (bands, base, state, thetas), info = _tod_step(
            pb, cfg_diag, (bands, base, state, thetas), gen, dev, step == 0,
            f"{preset} step {step + 1}")
        step_launches = info.pop("launches")
        for k in launches:
            launches[k] += step_launches[k]
        secs_all.append(info["step_s"])
        mem = info["peak_gib"]
        history.append(info["theta"])
        chi2_all.append(info.pop("binned_chi2"))
        diag.append(info)
    # outside the counts: the TOD stage alone
    sys_th = full_gibbs.system_at(base, pb.comps, pb.bps, pb.slots, thetas)
    sky = chisq.sky_signal(sys_th, pb.plan, state.a)
    del sys_th
    pass_ms = []
    for b, band in enumerate(bands):
        one = lambda: process_tod(band.cfg, band.block, band.state, sky[b],
                                  tod_gibbs.pixel_vectors(
                                      band.cfg.nside, sky.dtype, str(dev)),
                                  gen)
        one()       # the allocator's first fit after the step's CG
        pass_ms.append(timer(one))
    parts = _tod_parts_ms(timer, bands[0], sky[0], gen)
    busy, span = _device_busy_ms(
        lambda: tod_gibbs.tod_pass(bands, base, sky, False, gen), on_card)
    runs = [b.block.pixel_runs(pb.sys.data.shape[-1]) for b in bands]
    hit = [float(((r.offsets[1:] - r.offsets[:-1]) > 0).double().mean())
           for r in runs]
    solved = [float((base.inv_rms[b, 0] > 0).double().mean())
              for b in range(B)]
    tod = dict(sim_s=pb.sim_seconds, warm_start_s=warm_s,
               pass_ms_per_band=pass_ms, parts_ms_band0=parts,
               stage_device_ms=busy, stage_host_ms=span,
               stage_idle_share=None if busy is None else 1.0 - busy / span,
               coverage_hit=hit, coverage_solved=solved, gain=gains,
               sigma0_over_truth=s0_ratio,
               sigma0_over_expected=s0_vs_expected, binned_chi2=chi2_all)
    say(f"[6] {preset} TOD stage (outside the counts): " + json.dumps(tod))
    templates = tod_templates_phase(dev, pb, bands, base, state, thetas, sky,
                                    gen, p5)
    del sky

    # each further preconditioner's path: one step from the same bands and
    # state, its counts set to 0 before it and read after it
    paths = {preset: launches}
    precond = {"diagonal": dict(steps=diag, rejected=sum(
        d["relres"] > pb.cfg.cg_tol for d in diag))}
    for name, setting in TOD_PRECONDS.items():
        for k in cuda_sht.LAUNCHES:
            cuda_sht.LAUNCHES[k] = 0
        # (the step's new bands and system are dropped at once: held, they
        # would sit in the next path's peak memory)
        cfg = dataclasses.replace(pb.cfg, **setting)
        cfg = dataclasses.replace(cfg, cg_maxiter=min(cfg.cg_maxiter,
                                                      pb.cfg.cg_maxiter))
        info = _tod_step(pb, cfg, (bands, base, state, thetas), gen, dev,
                         False, f"{preset} with {name}")[1]
        paths[f"{preset}_{name}"] = info.pop("launches")
        info.pop("binned_chi2")
        precond[name] = dict(steps=[info],
                             rejected=int(info["relres"] > pb.cfg.cg_tol))
    say(f"[6] {preset} by preconditioner (steps the reference would reject: "
        f"relres > tol {pb.cfg.cg_tol}): " + json.dumps(precond))
    del pb, base, state, bands
    if on_card:
        torch.cuda.empty_cache()
    return paths, dict(step_s=secs_all, peak_gib=mem, theta=history,
                       tod=tod, precond=precond, templates=templates)


def sl_nside(lmax_sl: int, nside: int) -> int:
    """run._setup_tod_aux's sidelobe resolution: 16, doubled while twice it
    is below lmax_sl, at most the band's nside (run.py:683-687)."""
    ns = 16
    while 2 * ns < lmax_sl:
        ns *= 2
    return min(ns, nside)


def sl_beams(ndet: int, lmax: int, mmax: int, seed: int,
             amp: float = 0.02) -> np.ndarray:
    """Smooth per-detector sidelobe beams b_{l m'} (ndet, lmax+1, mmax+1)
    complex128 from a seed, normalized to amp at their largest (the shape
    of tests/test_tod_driver_physics.py's beams, decaying as e^{-5 l/lmax})."""
    rng = np.random.default_rng(seed)
    nl = lmax + 1
    out = np.zeros((ndet, nl, mmax + 1), np.complex128)
    for d in range(ndet):
        for m in range(mmax + 1):
            v = rng.normal(size=nl) + (1j * rng.normal(size=nl) if m else 0.0)
            v[:m] = 0.0
            out[d, :, m] = v * np.exp(-5.0 * np.arange(nl) / lmax)
        out[d] *= amp / np.abs(out[d]).max()
    return out


def _templates_check_inputs(on_card) -> dict:
    """The card-against-CPU check's inputs, made on the host alike in both
    processes: a T/Q/U sky (50 uK rms) and an LFI block simulated from it
    (nside 64, 8 scans x 2 detectors x 8192 samples; the rehearsal nside 16
    x 2048), float64 on the CPU; sidelobe beams at lmax 32 with 4 modes
    (sidelobe nside 16; the rehearsal lmax 16), a band temperature alm, a
    made-up satpos, the TodConfig (30 GHz, T/Q/U) and one pass's draws from
    a CPU generator seeded 2."""
    from commander_tpu_torch.tod import sim
    from commander_tpu_torch.tod.process import TodConfig, pass_draws

    ns, nt, lsl = (64, 8192, 32) if on_card else (16, 2048, 16)
    rng = np.random.default_rng(3)
    sky = torch.as_tensor(rng.standard_normal((3, 12 * ns * ns)) * 50.0)
    blk, _ = sim.simulate_tod(ns, sky, nscan=8, ndet=2, ntod=nt, pol=True,
                              seed=4, device="cpu")
    nl = lsl + 1
    a = rng.standard_normal((nl, nl)) + 1j * rng.standard_normal((nl, nl))
    a *= np.tril(np.ones((nl, nl))) * 30.0
    a[:, 0] = a[:, 0].real
    cfg = TodConfig(nside=ns, nu=30e9, pol=True)
    return dict(sky=sky, blk=blk, alm=torch.as_tensor(a), lsl=lsl, M=4,
                table_size=(64, 128) if on_card else (16, 32),
                blm=torch.as_tensor(sl_beams(2, lsl, 4, 5)),
                satpos=np.stack([np.linspace(0.0, 300.0, 8),
                                 np.linspace(-1.0, 1.0, 8)], axis=-1),
                cfg=cfg, draws=pass_draws(cfg, blk,
                                          torch.Generator().manual_seed(2)))


def _templates_pass(inp: dict, dev) -> dict:
    """From _templates_check_inputs, in float64 on dev: the f-maps, the
    sidelobe signal at the degraded pixels, the zodi template (uK_CMB), one
    process_tod with both terms, and the table path's transforms at nside
    64 / lmax 128 (the rehearsal 16 / 32) on seeded inputs. CPU tensors."""
    from commander_tpu_torch.sampling.tod_gibbs import pixel_vectors
    from commander_tpu_torch.sphere import sht
    from commander_tpu_torch.tod import conviqt, zodi
    from commander_tpu_torch.tod.process import init_tod_state, process_tod

    f64 = torch.float64
    cfg, lsl, M = inp["cfg"], inp["lsl"], inp["M"]
    ns_sl = sl_nside(lsl, cfg.nside)
    blk = inp["blk"].to(dev)
    blk.pixel_runs(12 * cfg.nside ** 2)
    plan = sht.get_plan(ns_sl, lsl, dtype=f64, device=dev)
    tables = conviqt.conviqt_tables(ns_sl, lsl, M, f64, dev)
    fm = conviqt.build_sl_fmaps(plan, tables, inp["alm"].to(dev),
                                inp["blm"].to(dev))
    sl_pix = torch.as_tensor(conviqt.degrade_table(cfg.nside, ns_sl)).to(
        dev)[blk.pix.long()].to(torch.int32)
    s_sl = conviqt.conviqt_interp_dets(fm, sl_pix, blk.psi)
    s_z = zodi.zodi_tod_template(cfg.nside, blk.pix, inp["satpos"],
                                 cfg.nu) * zodi.mjysr_to_uk_cmb(cfg.nu)
    draws = {k: tuple(x.to(dev) for x in v) if isinstance(v, tuple)
             else v.to(dev) for k, v in inp["draws"].items()}
    st, prod = process_tod(cfg, blk, init_tod_state(blk),
                           inp["sky"].to(dev), pixel_vectors(
                               cfg.nside, f64, str(dev)), sl_fmaps=fm,
                           s_extra=s_z, sl_pix=sl_pix, draws=draws)
    tn, tl = inp["table_size"]
    pt = sht.get_plan(tn, tl, spin2=True, dtype=f64, device=dev,
                      tables=True)
    tabs = {name: [x.cpu() for x in _listed(getattr(sht, name)(pt, *args))]
            for name, args in _table_calls(tn, tl, 2, f64, dev, 13)}
    return dict(fm=fm.cpu(), s_sl=s_sl.cpu(), zodi=s_z.cpu(),
                gain=st.gain.cpu(), sigma0=st.sigma0.cpu(),
                chi2=prod["chi2"].cpu(), tables=tabs)


def _p5_templates(job):
    """The worker's float64 side of _templates_parts_check."""
    t0 = time.perf_counter()
    out = _templates_pass(_templates_check_inputs(job["on_card"]), "cpu")
    out["seconds"] = time.perf_counter() - t0
    return out


def _templates_parts_check(dev, p5) -> dict:
    """The sidelobe and zodi terms and the table path in float64, the card
    against the worker's CPU on the same inputs (_templates_pass): f-maps,
    the sidelobe signal, the zodi template and the table path's transforms
    to 1e-10 of their max, the pass's gains to 1e-8; sigma0 and the
    per-scan chi^2 reported."""
    ref = phase5_result(p5, "templates")
    t0 = time.perf_counter()
    got = _templates_pass(_templates_check_inputs(dev.type == "cuda"), dev)
    secs = time.perf_counter() - t0
    err = {k: relmax(got[k], ref[k]) for k in ("fm", "s_sl", "zodi", "gain",
                                               "sigma0", "chi2")}
    err["tables"] = max(relmax(g, r) for name in ref["tables"]
                        for g, r in zip(got["tables"][name],
                                        ref["tables"][name]))
    out = dict(err=err, card_s=secs, cpu_s=ref["seconds"],
               shape=list(got["s_sl"].shape))
    say("[6] the sidelobe and zodi terms and the table path in float64, "
        "card against the CPU on a shared nside-64 block: "
        + json.dumps(out))
    if not (max(err[k] for k in ("fm", "s_sl", "zodi", "tables")) <= 1e-10
            and err["gain"] <= 1e-8):
        raise AssertionError("the sidelobe / zodi terms or the table path "
                             "disagree between the card and the CPU")
    return out


def tod_templates_phase(dev, pb, bands, base, state, thetas, sky, gen,
                        p5) -> dict:
    """Phase 6, within tutorial_tod: band 030's pass at full width with the
    sidelobe and zodi terms. Sidelobe beams from a seed at the reference's
    truncation (SL_LMAX, SL_MMAX; sidelobe nside sl_nside), their conviqt
    tables and plan, the samples' pixels degraded (sl_pix; the host parts
    made ahead by prebuild_tables), a zodi template
    from a made-up satpos; the band's TOD with both signals injected (the
    sidelobe of the true sky, unit gain). Timed by CUDA events: the f-map
    rebuild from the state's amplitudes (tod_gibbs.band_sl_fmaps),
    conviqt_interp over the block, the zodi template, a pass with the terms
    and without them; peak memory of the passes with the terms. From the
    band's state after the step and the same model sky (scan rejection
    off): TEMPLATE_PASSES passes with the terms modelled, their mean gain
    held within GAIN_TOL of 1 and mean sigma0 within SIGMA0_TOL of as many
    passes' on the clean TOD (sigma0 reads the model sky's errors too, so
    the clean passes run on the same sky); as many with the terms in the
    TOD and not modelled, and the TOD chi^2
    under the modelled state with the terms left out must read above the
    one with them. Then _templates_parts_check (card against CPU)."""
    from commander_tpu_torch.sampling import full_gibbs, tod_gibbs
    from commander_tpu_torch.sphere import sht
    from commander_tpu_torch.tod import conviqt, zodi
    from commander_tpu_torch.tod.model import TodBlock
    from commander_tpu_torch.tod.process import tod_chisq

    on_card = dev.type == "cuda"
    timer = Timer(dev)
    band = bands[0]
    blk, cfg = band.block, band.cfg
    npix = 12 * cfg.nside ** 2
    lsl, M = (SL_LMAX, SL_MMAX) if on_card else (24, 4)
    ns_sl = sl_nside(lsl, cfg.nside)
    t0 = time.perf_counter()
    tables = conviqt.conviqt_tables(ns_sl, lsl, M, blk.tod.dtype, dev)
    plan_sl = sht.get_plan(ns_sl, lsl, dtype=blk.tod.dtype, device=dev)
    tab = _PREBUILT.pop(("degrade", cfg.nside, ns_sl), None)
    if tab is None:
        tab = conviqt.degrade_table(cfg.nside, ns_sl)
    sl_pix = torch.as_tensor(tab).to(dev)[blk.pix.long()].to(torch.int32)
    _sync()
    setup_s = time.perf_counter() - t0
    cdt = torch.complex64 if blk.tod.dtype == torch.float32 \
        else torch.complex128
    blm = torch.as_tensor(sl_beams(blk.ndet, lsl, M, 9)).to(dev, cdt)
    Ns = blk.nscan
    satpos = np.stack([np.linspace(0.0, 359.0, Ns),
                       1.5 * np.sin(np.linspace(0.0, 2 * np.pi, Ns))],
                      axis=-1)
    box = {}
    zodi_ms = timer(lambda: box.update(z=zodi.zodi_tod_template(
        cfg.nside, blk.pix, satpos, cfg.nu)))
    s_z = (box.pop("z") * zodi.mjysr_to_uk_cmb(cfg.nu)).to(blk.tod.dtype)
    band_t = band._replace(sl_blm=blm, sl_plan=plan_sl, sl_tables=tables,
                           sl_pix=sl_pix, zodi=s_z)
    # the sidelobe of the true sky, injected with the zodi signal
    sys_true = full_gibbs.system_at(pb.sys, pb.comps, pb.bps, pb.slots,
                                    torch.tensor(pb.theta_true,
                                                 dtype=torch.float64,
                                                 device=dev))
    fm_true = tod_gibbs.band_sl_fmaps([band_t], sys_true, pb.a_true)[0]
    del sys_true
    interp_ms = timer(lambda: box.update(s=conviqt.conviqt_interp_dets(
        fm_true, sl_pix, blk.psi)))
    s_sl = box.pop("s")
    blk_i = TodBlock(tod=blk.tod + s_sl + s_z, pix=blk.pix, psi=blk.psi,
                     mask=blk.mask, vsun=blk.vsun, fsamp=blk.fsamp,
                     satpos=torch.as_tensor(satpos, device=dev))
    blk_i.pixel_runs(npix)
    term_rms = [float(x.double().pow(2).mean().sqrt()) for x in (s_sl, s_z)]
    del s_sl
    band_t = band_t._replace(block=blk_i)
    band_u = band._replace(block=blk_i)     # the terms in the TOD only
    sys_th = full_gibbs.system_at(base, pb.comps, pb.bps, pb.slots, thetas)
    rebuild_ms = timer(lambda: box.update(fm=tod_gibbs.band_sl_fmaps(
        [band_t], sys_th, state.a)[0]))
    fm = box.pop("fm")
    del sys_th

    def passes(b, fmaps):
        ms = []
        for _ in range(TEMPLATE_PASSES):
            ms.append(timer(lambda: box.update(out=tod_gibbs._band_pass(
                b, sky[0], True, gen, None, fmaps))))
            b, prod = box.pop("out")
        return b, prod, ms

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    bt, prod_t, ms_t = passes(band_t, fm)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    bu, prod_u, ms_u = passes(band_u, None)
    bc, _, ms_c = passes(band, None)        # the clean TOD, the same sky
    pv = tod_gibbs.pixel_vectors(cfg.nside, blk.tod.dtype, str(dev))
    terms = dict(sl_fmaps=fm, s_extra=s_z, sl_pix=sl_pix)
    chi2_mod = float(tod_chisq(cfg, blk_i, bt.state, sky[0], pv, **terms))
    chi2_left = float(tod_chisq(cfg, blk_i, bt.state, sky[0], pv))
    mean = lambda x: float(x.double().mean())
    s0_clean = mean(bc.state.sigma0)
    out = dict(
        sl_lmax=lsl, sl_mmax=M, sl_nside=ns_sl, setup_s=setup_s,
        sidelobe_rms_uK=term_rms[0], zodi_rms_uK=term_rms[1],
        fmap_rebuild_ms=rebuild_ms, conviqt_interp_ms=interp_ms,
        zodi_template_ms=zodi_ms, pass_ms_with_terms=ms_t,
        pass_ms_terms_not_modelled=ms_u, pass_ms_clean=ms_c,
        gain_clean=mean(bc.state.gain),
        peak_gib_with_terms=peak,
        gain_modelled=mean(bt.state.gain), gain_not_modelled=mean(
            bu.state.gain),
        sigma0_modelled_over_clean=mean(bt.state.sigma0) / s0_clean,
        sigma0_not_modelled_over_clean=mean(bu.state.sigma0) / s0_clean,
        chi2_per_dof_pass_modelled=float(prod_t["chi2"].double().sum()
                                         / prod_t["ndof"].double().sum()),
        chi2_per_dof_pass_not_modelled=float(
            prod_u["chi2"].double().sum() / prod_u["ndof"].double().sum()),
        tod_chi2_modelled=chi2_mod, tod_chi2_terms_left_out=chi2_left,
        shape=list(blk.tod.shape))
    say("[6] tutorial_tod band 030 with sidelobes and zodi (outside the "
        "counts): " + json.dumps(out))
    del bt, bu, bc, band_t, band_u, blk_i, fm, fm_true, s_z, prod_t, prod_u
    if on_card:
        torch.cuda.empty_cache()
    if not (abs(out["gain_modelled"] - 1.0) <= GAIN_TOL
            and abs(out["sigma0_modelled_over_clean"] - 1.0) <= SIGMA0_TOL
            and chi2_left > chi2_mod):
        raise AssertionError("the pass with the sidelobe and zodi terms does "
                             "not recover the gain and sigma0, or leaving "
                             "the terms out does not read worse")
    out["parts"] = _templates_parts_check(dev, p5)
    return out


def _timed(fn, on_card):
    """(fn(), its ms): CUDA events on the card, the host clock off it."""
    if not on_card:
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


@contextlib.contextmanager
def watch_solves(on_card):
    """Inside it, each amplitude solve records, in the dict it yields, its
    preconditioner's build ms and its CG's ms (CUDA events on the card),
    and the operator, right-hand side, preconditioner and result of the
    last solve: amplitude.build_precond and amplitude.pcg are wrapped,
    called with their own arguments, their results returned unchanged."""
    from commander_tpu_torch.sampling import amplitude

    rec = {}
    build0, pcg0 = amplitude.build_precond, amplitude.pcg
    timed = lambda fn: _timed(fn, on_card)

    def build(*a, **k):
        rec["M"], rec["build_ms"] = timed(lambda: build0(*a, **k))
        return rec["M"]

    def pcg(A, b, **k):
        res, rec["cg_ms"] = timed(lambda: pcg0(A, b, **k))
        rec.update(A=A, b=b, res=res)
        return res

    amplitude.build_precond, amplitude.pcg = build, pcg
    try:
        yield rec
    finally:
        amplitude.build_precond, amplitude.pcg = build0, pcg0


# float32 unit roundoff
EPS32 = 2.0 ** -24


def solve_checks(rec, seed=0) -> dict:
    """What phase 6 holds of a recorded solve (watch_solves), in float64
    sums of the float32 vectors.

    Symmetry and positivity of the preconditioner M under the alm metric,
    on two random alms r1, r2 (white, triangle, real at m = 0). The exact M
    is symmetric positive, so <r1, M r2> - <M r1, r2> is the rounding of
    the two applications: |<r1, d2>| + |<d1, r2>| <= |r1| |d2| + |d1| |r2|,
    d_i the rounding error of M r_i. Its size is read off the run itself:
    M(k r)/k - M(r) holds two independent roundings of the same exact
    vector, so |d_i| is about e_i = max over k = 3, 7 of |M(k r_i)/k -
    M(r_i)|, taken twice; one more float32 rounding of each output (EPS32
    |r1| |M r2| and the same for the other) covers a case where the two
    happen to round alike. Bound:
    2 (|r1| e_2 + e_1 |r2|) + EPS32 (|r1| |M r2| + |M r1| |r2|); positivity:
    <r1, M r1> above 2 |r1| e_1 + EPS32 |r1| |M r1|.

    The true residual |b - A x| / |b| of the returned x against the CG's
    recursive relres: each iteration adds to their gap the rounding of
    alpha A p and of x + alpha p, and |alpha p| = |x_{k+1} - x_k| <= 2 |x|
    (the CG iterates grow in norm from x0 = 0), so the gap is at most
    (iters + 1) times twice the rounding of A on a vector of norm |x|,
    whose size e_A (max over k = 3, 7 of |A(k x)/k - A(x)|) is read off
    the run as above, taken twice again: relres + 4 (iters + 1) e_A / |b|
    + 2 EPS32 (|b| + |A x|) / |b| (the last term: b - A x itself in
    float32)."""
    from commander_tpu_torch.sampling.amplitude import real_m0
    from commander_tpu_torch.sphere.alm import alm_dot, random_alm_white

    A, b, M, res = rec["A"], rec["b"], rec["M"], rec["res"]
    c128 = lambda t: t.to(torch.complex128)
    dot = lambda x, y: float(alm_dot(c128(x), c128(y)))
    norm = lambda x: math.sqrt(max(dot(x, x), 0.0))
    g = torch.Generator(device=b.device)
    g.manual_seed(seed)
    tri = torch.tril(torch.ones(tuple(b.shape[-2:]), dtype=b.real.dtype,
                                device=b.device))
    r1, r2 = (real_m0(random_alm_white(g, tuple(b.shape), b.real.dtype)
                      * tri) for _ in range(2))
    rounding = lambda f, v, fv: max(norm(f(k * v) / k - fv)
                                    for k in (3.0, 7.0))
    Mr1, Mr2 = M(r1), M(r2)
    e1, e2 = rounding(M, r1, Mr1), rounding(M, r2, Mr2)
    n1, n2, nm1, nm2 = norm(r1), norm(r2), norm(Mr1), norm(Mr2)
    asym = abs(dot(r1, Mr2) - dot(Mr1, r2))
    sym_bound = 2.0 * (n1 * e2 + e1 * n2) + EPS32 * (n1 * nm2 + nm1 * n2)
    quad = dot(r1, Mr1)
    pos_bound = 2.0 * n1 * e1 + EPS32 * n1 * nm1
    del r1, r2, Mr1, Mr2
    x = res.x
    Ax = A(x)
    eA = rounding(A, x, Ax)
    nb = norm(b)
    true_rel = norm(b - Ax) / nb
    res_bound = res.rel_res + 4.0 * (res.iters + 1) * eA / nb \
        + 2.0 * EPS32 * (nb + norm(Ax)) / nb
    return dict(asymmetry=asym, asymmetry_bound=sym_bound,
                quad_r1=quad, positivity_bound=pos_bound,
                true_relres=true_rel, true_relres_bound=res_bound,
                ok=bool(asym <= sym_bound and quad > pos_bound
                        and true_rel <= res_bound))


def _tod_step(pb, cfg, st, gen, dev, first, label):
    """One tod_gibbs_step of tod_path_phase from st = (bands, base system,
    state, thetas) with GibbsConfig cfg, and what phase 6 holds of it: the
    launch counts (those the code implies for cfg's preconditioner), peak
    memory, finite state, binned maps' chi^2, CG converged or at maxiter,
    and, outside the counts, solve_checks. Returns (the new st, a dict of
    what was measured with the step's launch counts under "launches")."""
    from commander_tpu_torch.sampling import amplitude, chisq, full_gibbs
    from commander_tpu_torch.sampling import tod_gibbs
    from commander_tpu_torch.sphere import cuda_sht

    on_card = dev.type == "cuda"
    B, C, S = pb.sys.F.shape
    n0 = dict(cuda_sht.LAUNCHES)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bands, base, state, thetas = st
    with watch_solves(on_card) as rec:
        bands, base, state, thetas = tod_gibbs.tod_gibbs_step(
            cfg, pb.comps, pb.bps, pb.slots, bands, base, pb.plan, state,
            thetas, first=first, generator=gen,
            beam_consistent=pb.beam_consistent)
        if on_card:
            torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    d = {k: cuda_sht.LAUNCHES[k] - n0[k] for k in n0}
    th = thetas.tolist()
    chi2, solved = tod_gibbs.binned_map_chisq(base, pb.sky_true)
    sys_th = full_gibbs.system_at(base, pb.comps, pb.bps, pb.slots, thetas)
    c2, _, ndof = chisq.compute_chisq(sys_th, pb.plan, state.a)
    red = float(c2) / int(ndof)
    del sys_th
    checks = solve_checks(rec)
    lowl_inv = None
    if cfg.cg_lmax_precond >= 0:
        # for the record: the block inverted in float32 (the JAX package's
        # way) against the float64 inverse the port applies
        blk = amplitude.lowl_block(rec["A"].args[0], cfg.cg_lmax_precond)
        inv32 = torch.linalg.inv_ex(blk).inverse.double()
        inv64 = torch.linalg.inv_ex(blk.double()).inverse
        lowl_inv = dict(n=int(blk.shape[0]), float32_inverse_err=float(
            (inv32 - inv64).abs().max() / inv64.abs().max()))
        del blk, inv32, inv64
    iters = state.cg_iters
    info = dict(step_s=secs, iters=iters, relres=state.cg_relres,
                converged=state.cg_relres <= cfg.cg_tol,
                build_ms=rec["build_ms"], cg_ms=rec["cg_ms"],
                ms_per_iter=rec["cg_ms"] / max(iters, 1), peak_gib=mem,
                theta=th, chisq_red=red, checks=checks, lowl_block=lowl_inv,
                launches=d, binned_chi2=chi2.tolist())
    del rec
    say(f"[6] {label}: {secs:.2f} s, CG iters {iters}, relres "
        f"{state.cg_relres:.2e} ({'converged' if info['converged'] else 'at maxiter'}), "
        f"{info['ms_per_iter']:.1f} ms per iteration, preconditioner built "
        f"in {info['build_ms']:.1f} ms, theta {th}, peak device memory "
        f"{mem if mem is None else round(mem, 2)} GiB, launches synth "
        f"{d['synth']} adjoint {d['adjoint']}; binned maps vs the true band "
        f"sky chi2/dof per band and Stokes "
        f"{[[round(x, 4) for x in r] for r in chi2.tolist()]} at the solved "
        f"pixels {[round(x, 4) for x in solved[:, 0].tolist()]}; reduced "
        f"chi-square of the model against the maps {red:.4f}; "
        f"preconditioner and solution checks {json.dumps(checks)}"
        + (f"; low-ell block {json.dumps(lowl_inv)}" if lowl_inv else ""))
    if mem is not None and mem > TOD_STEP_PEAK_GIB:
        raise AssertionError(f"peak device memory {mem:.2f} GiB above "
                             f"{TOD_STEP_PEAK_GIB} GiB")
    in_range = all(s.cfg.grid_min <= t <= s.cfg.grid_max
                   for s, t in zip(pb.slots, th))
    if not (_finite_state(state) and in_range and np.isfinite(red)
            and all(torch.isfinite(b.state.n_corr).all() for b in bands)):
        raise AssertionError("non-finite sampler state or an index "
                             "outside its grid")
    if not (state.cg_relres <= cfg.cg_tol or iters == cfg.cg_maxiter):
        raise AssertionError("CG neither converged nor hit maxiter")
    if on_card and float(chi2.max()) > BINNED_CHI2_BOUND:
        raise AssertionError(f"binned maps' chi2/dof {chi2.tolist()} "
                             f"above {BINNED_CHI2_BOUND}")
    if not checks["ok"]:
        raise AssertionError(f"{label}: the preconditioner or the solution "
                             f"fails its float32 bound: {checks}")
    # full_path_phase's counts plus the model sky of the TOD pass (one
    # synthesis of the B bands); the pseudo-inverse adds one synthesis and
    # one adjoint per application (iters + 1), the low-ell block one
    # operator application of the degraded system per column chunk
    pt = 3 if S == 3 else 1
    n_apply = iters + 1
    extra = 0
    if cfg.cg_lmax_precond >= 0:
        n = C * S * (cfg.cg_lmax_precond + 1) ** 2
        extra = pt * -(-n // amplitude.LOWL_CHUNK)
    elif cfg.cg_precond == "pseudoinv":
        extra = pt * (iters + 1)
    want = (pt * (n_apply + 1) + len(pb.slots) * pt
            * (2 + int(pb.beam_consistent)) + extra,
            pt * (n_apply + 1) + extra) if on_card else (0, 0)
    if (d["synth"], d["adjoint"]) != want:
        raise AssertionError(f"{label}: launch counts "
                             f"{(d['synth'], d['adjoint'])} != {want}")
    return (bands, base, state, thetas), info


@contextlib.contextmanager
def watch_joint(on_card):
    """watch_solves for the joint system: joint.pcg wrapped, each solve
    recording its CG's ms, operator, right-hand side and result."""
    from commander_tpu_torch.sampling import joint

    rec = {}
    pcg0 = joint.pcg

    def pcg(A, b, **k):
        res, rec["cg_ms"] = _timed(lambda: pcg0(A, b, **k), on_card)
        rec.update(A=A, b=b, res=res)
        return res

    joint.pcg = pcg
    try:
        yield rec
    finally:
        joint.pcg = pcg0


def joint_path_phase(dev, preset, steps, **overrides):
    """Phase 6, the whole model from TOD: `preset` (tutorial_joint: 8
    components, the joint system's md, relquad and source rows) simulated
    (its host seconds alone), the warm start from run.py's starting state,
    then `steps` tod_gibbs_step calls with the launch counts set to 0 before
    them and read after them. Held per step: the launch counts (as
    _tod_step's diagonal ones: the joint rows add no transform), finite
    state, indices on their grids, relquad at its pinned 1, CG converged or
    at maxiter, peak memory below TOD_STEP_PEAK_GIB; the binned maps'
    chi^2 is reported, not held (the model sky the TOD pass fits comes from
    a CG that fact (a) stops early, and sources on unsolved pixels have
    flat priors). Outside the counts, per step: the
    diffuse block's own relative residual |r_a| / |b_a| at the solution
    (the pinned row's 1e12 in |b| ends the joint test early; ROADMAP queue
    3), ms per operator application and the part of it in the template and
    source products (CUDA events), t and p against the simulated
    amplitudes."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import full_gibbs, joint, tod_gibbs
    from commander_tpu_torch.sphere import cuda_sht
    from commander_tpu_torch.sphere.alm import alm_dot

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    timer = Timer(dev)
    t0 = time.perf_counter()
    pb = entry.build_preset(preset, torch.float32, dev, seed=0, **overrides)
    sync()
    B, C, S = pb.sys.F.shape
    nslot = len(pb.slots)
    ts, ps = pb.ts, pb.ps
    npix = pb.sys.data.shape[-1]
    blk = pb.bands[0].block
    nsamp = sum(b.block.tod.numel() for b in pb.bands)
    say(f"[6] {preset} preset nside {pb.plan.nside} lmax {pb.plan.lmax} "
        f"bands {B} comps {C} ({[c.name for c in pb.comps]}) Stokes {S} "
        f"slots {nslot}, {ts.ntemp} template rows on "
        f"{ts.planes.shape[0]} planes ({ts.planes.numel() * 4} bytes), "
        f"{ps.pix.shape[0]} sources x {ps.pix.shape[1]} pixels, TOD "
        f"{blk.nscan} scans x {blk.ndet} detectors x {blk.ntod} samples per "
        f"band ({nsamp} samples): set-up {time.perf_counter() - t0:.1f} s, "
        f"of which the TOD simulator {pb.sim_seconds:.1f} s of host time")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    sys0 = full_gibbs.system_at(pb.sys, pb.comps, pb.bps, pb.slots,
                                pb.thetas0)
    t0 = time.perf_counter()
    bands, state = tod_gibbs.tod_burnin(
        pb.cfg, pb.bands, sys0, pb.plan,
        entry.prior_state(pb.cfg, pb.sys, ts, ps), gen, ts=ts, ps=ps)
    sync()
    warm_s = time.perf_counter() - t0
    del sys0
    gains = [float(b.state.gain.double().mean()) for b in bands]
    say(f"[6] {preset} warm start (1 joint amplitude step, CG iters "
        f"{state.cg_iters} relres {state.cg_relres:.2e}, then 3 TOD passes "
        f"on the full model sky): {warm_s:.2f} s; per band mean gain "
        f"{[round(g, 5) for g in gains]}; relquad {float(state.t[-1]):.6f}")

    base, thetas = pb.sys, pb.thetas0
    for k in cuda_sht.LAUNCHES:
        cuda_sht.LAUNCHES[k] = 0
    launches = {"synth": 0, "adjoint": 0}
    pt = 3 if S == 3 else 1
    hist = []
    for step in range(steps):
        n0 = dict(cuda_sht.LAUNCHES)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with watch_joint(on_card) as rec:
            bands, base, state, thetas = tod_gibbs.tod_gibbs_step(
                pb.cfg, pb.comps, pb.bps, pb.slots, bands, base, pb.plan,
                state, thetas, first=step == 0, generator=gen,
                beam_consistent=pb.beam_consistent, ts=ts, ps=ps)
            sync()
        secs = time.perf_counter() - t0
        mem = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
        d = {k: cuda_sht.LAUNCHES[k] - n0[k] for k in n0}
        for k in launches:
            launches[k] += d[k]
        iters = state.cg_iters
        n_apply = iters + 1
        want = (pt * (n_apply + 1) + nslot * pt
                * (2 + int(pb.beam_consistent)),
                pt * (n_apply + 1)) if on_card else (0, 0)
        if (d["synth"], d["adjoint"]) != want:
            raise AssertionError(f"{preset} step {step + 1}: launch counts "
                                 f"{(d['synth'], d['adjoint'])} != {want}")
        # outside the counts: the solve's blocks, an operator application
        # and its template and source products
        A, b, x = rec["A"], rec["b"], rec["res"].x
        r = b - A(x)
        nrm = lambda v: math.sqrt(float(alm_dot(v.a, v.a)))
        b_a_norm = nrm(b)
        rel_a = nrm(r) / b_a_norm
        b_norm = math.sqrt(float(joint.joint_dot(b, b)))
        cg_ms = rec["cg_ms"]
        apply_ms = timer(lambda: A(x), 3)
        m = base.data

        def products():
            m2 = m + joint._templates_fwd(ts, x.t) \
                + joint._ptsrc_fwd(ps, x.p, npix)
            return joint._templates_adj(ts, m2), joint._ptsrc_adj(ps, m2)

        products_ms = timer(products, 3)
        del r, A, b, x, rec
        chi2, _ = tod_gibbs.binned_map_chisq(base, pb.sky_true)
        th = thetas.tolist()
        t_md = state.t[:-1].tolist()
        p_ratio = (state.p / pb.p_true).tolist()
        info = dict(step_s=secs, iters=iters, relres=state.cg_relres,
                    diffuse_relres=rel_a, b_norm=b_norm,
                    b_diffuse_norm=b_a_norm, cg_ms=cg_ms,
                    apply_ms=apply_ms, products_ms=products_ms,
                    peak_gib=mem, theta=th, md=t_md,
                    relquad=float(state.t[-1]), p=state.p.tolist(),
                    p_true=pb.p_true.tolist(), p_over_true=p_ratio,
                    binned_chi2=chi2.tolist(), launches=d)
        hist.append(info)
        say(f"[6] {preset} step {step + 1}: " + json.dumps(info))
        in_range = all(s_.cfg.grid_min <= t <= s_.cfg.grid_max
                       for s_, t in zip(pb.slots, th))
        if not (_finite_state(state) and in_range
                and bool(torch.isfinite(state.t).all())
                and bool(torch.isfinite(state.p).all())):
            raise AssertionError(f"{preset}: non-finite state or an index "
                                 f"outside its grid")
        if abs(float(state.t[-1]) - 1.0) > 1e-3:
            raise AssertionError(f"{preset}: relquad left its pin")
        if not (state.cg_relres <= pb.cfg.cg_tol
                or iters == pb.cfg.cg_maxiter):
            raise AssertionError("CG neither converged nor hit maxiter")
        if mem is not None and mem > TOD_STEP_PEAK_GIB:
            raise AssertionError(f"peak device memory {mem:.2f} GiB above "
                                 f"{TOD_STEP_PEAK_GIB} GiB")
    sim_s = pb.sim_seconds
    del pb, base, state, bands
    if on_card:
        torch.cuda.empty_cache()
    return launches, dict(sim_s=sim_s, warm_start_s=warm_s, steps=hist)


def _multires_draws(pb, gen):
    """The draws of one multires_gibbs_step on the CPU in float64: eta1 per
    group, eta2, the C_l gammas, the index uniforms and the gains' normal
    draws."""
    from commander_tpu_torch.sphere.alm import random_alm_white

    C, S, nl = pb.ms.cl.shape
    return {
        "eta1": [torch.randn(tuple(g.data.shape), generator=gen,
                             dtype=torch.float64) for g in pb.ms.groups],
        "eta2": random_alm_white(gen, (C, S, nl, nl)),
        "gamma": torch.as_tensor(np.random.default_rng(2).gamma(
            50.0, size=(C, S, len(pb.cl_cfg.bin_starts)))),
        "u": torch.rand(len(pb.slots), generator=gen, dtype=torch.float64),
        "eps_gain": torch.randn(len(pb.cfg.bands), generator=gen,
                                dtype=torch.float64),
    }


def _draws_to(draws, dev):
    """The draws on `dev`: alms complex64, maps and gammas float32, the
    uniforms and the gains' draws float64."""
    def one(k, v):
        if v.is_complex():
            return v.to(dev, torch.complex64)
        return v.to(dev, torch.float64 if k in ("u", "eps_gain")
                    else torch.float32)
    return {k: [one(k, x) for x in v] if isinstance(v, list) else one(k, v)
            for k, v in draws.items()}


def entry_multires_phase(dev, p5, **size):
    """Phase 5, the multi-resolution iteration: one multires_gibbs_step of
    entry_multires (30/44 GHz at nside 32, 70 GHz at nside 64, T/Q/U, five
    components, five slots, every band's gain) on `dev` in float32 against
    the same step in float64 on the CPU (the worker's), on the same data
    (the card's, phase5_start) with the same draws. Held in its parts, as
    _hold_joint holds entry_joint's and for the same reason (five
    components on three bands leave directions to the priors, where
    float32 moves the amplitudes by ~1e-3-1e-2 of their max): the same CG
    iteration count; every group's model sky in data space to 1e-3 of its
    max; the index draws given the card's amplitudes (the CPU float64
    draws from them, with the same uniforms) to 0.05 grid steps; the gains
    given the card's amplitudes and indices to 1e-4. The amplitudes are
    reported."""
    from commander_tpu_torch.sampling import multires_gibbs as mg

    pd = p5["keep"]["entry_multires"]
    say(f"[5] entry_multires: host s of pixel_window (nside/lmax) "
        f"{p5['keep']['pixel_window_s']}")
    gen = torch.Generator()
    gen.manual_seed(1)
    draws = _multires_draws(pd, gen)
    t0 = time.perf_counter()
    nd = mg.multires_gibbs_step(pd, mg.init_state(pd), draws=_draws_to(
        draws, dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nc = types.SimpleNamespace(**phase5_result(p5, "entry_multires"))
    pc = _p5_problem(p5, "entry_multires")
    ms_c = pc.ms
    a_d = nd.a.cpu().to(torch.complex128)
    e_sky = [relmax(mg.group_sky(g, p, a_d), mg.group_sky(g, p, nc.a))
             for g, p in zip(pc.ms.groups, pc.plans)]
    th_ref, ms_ref = mg.multires_indices(pc, pc.ms, a_d, pc.thetas0,
                                         u=draws["u"])
    e_idx = [abs(float(d) - float(c)) / h for d, c, h in zip(
        nd.thetas.cpu(), th_ref, _grid_steps(pc.slots))]
    g_ref = mg.multires_gains(pc, mg.groups_at(pc, ms_c, nd.thetas.cpu()),
                              a_d, torch.ones(len(pc.cfg.bands),
                                              dtype=torch.float64), 1,
                              eps=draws["eps_gain"])
    e_gain = float((nd.gains.cpu() - g_ref).abs().max())
    say(f"[5] entry_multires groups {pd.groups} (S = "
        f"{pd.ms.cl.shape[1]}, {len(pd.slots)} slots, gains on): "
        f"{secs:.3f} s, CG iterations {nd.cg_iters} / {nc.cg_iters} (card "
        f"/ CPU float64), relres {nd.cg_relres:.2e}; held in parts: model "
        f"sky per group in data space {[f'{e:.2e}' for e in e_sky]} of its "
        f"max (bound 1e-3); index draws given the card's amplitudes, grid "
        f"steps {[f'{e:.1e}' for e in e_idx]} (bound 0.05); gains given the "
        f"card's amplitudes and indices {e_gain:.2e} (bound 1e-4), card "
        f"{nd.gains.tolist()}; reported: a {relmax(a_d, nc.a):.2e} of its "
        f"max, theta card {nd.thetas.tolist()}, CPU {nc.thetas.tolist()}, "
        f"gains CPU {nc.gains.tolist()}")
    if not (_finite_state(nd) and nd.cg_iters == nc.cg_iters
            and max(e_sky) <= 1e-3 and max(e_idx) <= 0.05
            and e_gain <= 1e-4):
        raise AssertionError("entry_multires step disagrees with the CPU "
                             "reference")


def _p5_multires(job):
    """The worker's float64 step of entry_multires_phase."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import multires_gibbs as mg

    pc = entry.build_preset("entry_multires", torch.float64, "cpu",
                            **job["size"])
    pc = pc._replace(ms=dataclasses.replace(pc.ms, groups=tuple(
        dataclasses.replace(gc, data=d)
        for gc, d in zip(pc.ms.groups, job["data"]))))
    gen = torch.Generator()
    gen.manual_seed(1)
    nc = mg.multires_gibbs_step(pc, mg.init_state(pc),
                                draws=_multires_draws(pc, gen))
    return dict(a=nc.a, cg_iters=nc.cg_iters, thetas=nc.thetas,
                gains=nc.gains)


# command (c) of the differential slice: run_multires' TOD branch through
# the program, at tutorial_multires' resolutions: 030 (LFI) and 044
# (differential) at nside 512 / lmax 1000, 070 (LFI) at nside 1024
MULTIRES_TOD_ARGV = ["param_tutorial_full.txt", "--synthetic", "--pol",
                     "--multires", "--tod", "--BAND_NSIDE001=512",
                     "--BAND_LMAX001=1000", "--BAND_NSIDE002=512",
                     "--BAND_LMAX002=1000", "--BAND_TOD_TYPE002=WMAP",
                     "--niter", "2", "--outdir", "build/multires_tod_out"]


def _hold_multires_tod_launches(parts, launches, pb, st):
    """Command (c)'s launch counts as the code implies them: the build one
    synthesis per group (pt wrapper calls: 3 on T/Q/U); the burn-in, per
    pass, one synthesis per group holding a TOD band (its band skies);
    per iteration the TOD pass's as many, the CG (the rhs one adjoint per
    group, k = n + 1 applications, one more where it broke down: one
    synthesis and one adjoint per group each), two syntheses per slot and
    group (the index lnL); nothing else."""
    from commander_tpu_torch.sampling import multires_gibbs as mg

    pt = 3 if pb.ms.cl.shape[1] == 3 else 1
    G, nslot = len(pb.groups), len(pb.slots)
    g_tod = len({pb.band_slot[i][0] for i in st.bands})
    want = {"build": {"synth": G * pt, "adjoint": 0},
            "burnin": {"synth": mg.TOD_BURNIN_PASSES * g_tod * pt,
                       "adjoint": 0}}
    ks = [n + 1 + int(rr > pb.cfg.cg_tol and n < pb.cfg.cg_maxiter)
          for n, rr in parts["cg"]]
    want["steps"] = [{"synth": g_tod * pt + G * pt * k + 2 * nslot * G * pt,
                      "adjoint": G * pt * (k + 1)} for k in ks]
    got = {k: parts[k] for k in ("build", "burnin", "steps")}
    total = {k: want["build"][k] + want["burnin"][k]
             + sum(x[k] for x in want["steps"]) for k in launches}
    if got != want or launches != total:
        raise AssertionError(f"multires_tod: launches {got} (total "
                             f"{launches}) != {want} (total {total})")
    say(f"[6] multires_tod: launch counts as the code implies {want}")


def multires_tod_phase(dev):
    """Phase 6, command (c): MULTIRES_TOD_ARGV through run.main in this
    process: the multi-resolution build, run_multires' stand-in TOD (LFI 8
    scans x 2 detectors x 4096 samples, the differential band 4 x 2 x 2048,
    T only), 3 burn-in passes on the zero sky, 2 iterations each with a TOD
    pass ahead. Per iteration s/step, CG iterations and relres, the TOD
    pass's seconds; each band pass's ms (the differential one's mapmaker
    iterations and x_im); what the first pass changed in each TOD band's
    rows (the T pixels changed and the share the stand-in hits, its
    inv_rms against the map-level one; Q and U untouched: ROADMAP queue 3
    item 18); peak memory. Held: the
    chain's samples 1-2, Q and U untouched, the LFI stand-ins' TOD states
    finite, the launch counts of the build, the burn-in and each iteration
    exactly, and a finite state with the CG converged or at maxiter --
    unless the differential stand-in's imbalance ran away (|x_im| >= 1e10:
    its zero-sky burn-in calibrates on the orbital dipole difference alone,
    which its data lack, ROADMAP queue 3 item 16; run_multires then goes
    NaN too), which is reported. Returns (launches, iterations,
    measured)."""
    import shutil

    from commander_tpu_torch import entry
    from commander_tpu_torch import run as trun
    from commander_tpu_torch.io.chain import ChainFile
    from commander_tpu_torch.sampling import multires_gibbs as mg
    from commander_tpu_torch.sampling import tod_gibbs
    from commander_tpu_torch.sphere import cuda_sht

    on_card = dev.type == "cuda"
    argv = list(MULTIRES_TOD_ARGV)
    if not on_card:
        # the rehearsal: nside 8 / lmax 16 and the 1024 band capped at 16
        argv = [a.replace("=512", "=8").replace("=1000", "=16")
                for a in argv] + ["--cpu", "--max-nside", "16"]
    out = argv[argv.index("--outdir") + 1]
    shutil.rmtree(out, ignore_errors=True)
    parts = {"build": None, "burnin": None, "steps": [], "passes": [],
             "rows": None, "step_s": [], "cg": []}
    real = dict(build=entry.build_multi_problem, burnin=mg.tod_burnin,
                step=mg.multires_gibbs_step, tod=mg.tod_pass,
                band=tod_gibbs._band_pass)
    box = {}

    def counted(fn, put):
        def f(*a, **k):
            n0 = dict(cuda_sht.LAUNCHES)
            r = fn(*a, **k)
            put({k_: cuda_sht.LAUNCHES[k_] - n0[k_] for k_ in n0})
            return r
        return f

    def build(*a, **k):
        box["pb"] = real["build"](*a, **k)
        return box["pb"]

    def step(*a, **k):
        _sync()
        t = time.perf_counter()
        r = real["step"](*a, **k)
        _sync()
        parts["step_s"].append(time.perf_counter() - t)
        parts["cg"].append((int(r.cg_iters), float(r.cg_relres)))
        return r

    def tod(pb, ms, bands, a, *x, **k):
        r = real["tod"](pb, ms, bands, a, *x, **k)
        if parts["rows"] is None and k.get("update", True):
            rows = {}
            for i in bands:
                g, j = pb.band_slot[i]
                old, new = ms.groups[g], r[1].groups[g]
                ch = new.inv_rms[j] != old.inv_rms[j]
                hit = new.inv_rms[j, 0] > 0
                rows[pb.cfg.bands[i].label] = dict(
                    kind=bands[i].kind,
                    t_replaced=float(ch[0].double().mean()),
                    t_hit=float(hit.double().mean()),
                    qu_changed=int(ch[1:].sum()) + int(
                        (new.data[j, 1:] != old.data[j, 1:]).sum()),
                    t_inv_rms_median=float(new.inv_rms[j, 0][hit]
                                           .double().median()),
                    map_inv_rms_median=float(old.inv_rms[j, 0]
                                             .double().median()))
            parts["rows"] = rows
        return r

    def band(b, *a, **k):
        _sync()
        t = time.perf_counter()
        r = real["band"](b, *a, **k)
        _sync()
        p = r[1]
        parts["passes"].append(dict(
            kind=b.kind, ms=(time.perf_counter() - t) * 1e3,
            cg_iters=p.get("cg_iters"),
            x_im=float(p["x_im"].double().mean()) if "x_im" in p else None))
        return r

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for k in cuda_sht.LAUNCHES:
        cuda_sht.LAUNCHES[k] = 0
    entry.build_multi_problem = counted(build,
                                        lambda d: parts.update(build=d))
    mg.tod_burnin = counted(real["burnin"], lambda d: parts.update(burnin=d))
    mg.multires_gibbs_step = counted(step, parts["steps"].append)
    mg.tod_pass, tod_gibbs._band_pass = tod, band
    t0 = time.perf_counter()
    try:
        ((st, path, _),) = trun.main(argv)
    finally:
        entry.build_multi_problem = real["build"]
        mg.tod_burnin, mg.multires_gibbs_step = real["burnin"], real["step"]
        mg.tod_pass, tod_gibbs._band_pass = real["tod"], real["band"]
    secs = time.perf_counter() - t0
    launches = dict(cuda_sht.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if on_card else float("nan")
    pb = box["pb"]
    say(f"[6] multires_tod: {' '.join(argv)}")
    say(f"[6] multires_tod: groups {pb.groups}, TOD bands "
        f"{[(pb.cfg.bands[i].label, b.kind, tuple(b.block.tod.shape))
            for i, b in st.bands.items()]}; "
        f"run {secs:.1f} s, peak device memory "
        f"{peak:.2f} GiB; launches build {parts['build']}, burn-in "
        f"{parts['burnin']}")
    nb = len(st.bands)
    for i, (d, t) in enumerate(zip(parts["steps"], parts["step_s"])):
        ps = parts["passes"][(3 + i) * nb:(4 + i) * nb]
        say(f"[6] multires_tod iteration {i + 1}: {t:.2f} s/step, CG "
            f"iters {parts['cg'][i][0]}, relres {parts['cg'][i][1]:.2e}, "
            f"its TOD "
            f"pass {sum(p['ms'] for p in ps):.1f} ms (by band "
            f"{[(p['kind'], round(p['ms'], 1), p['cg_iters'], p['x_im'])
                for p in ps]}); "
            f"launches {d}")
    with ChainFile(path, "r") as ch:
        names = sorted(k for k in ch.f.root.members if k.isdigit())
        last = ch.read_sample(ch.last_sample())
    say(f"[6] multires_tod: CG iters {st.cg_iters} relres "
        f"{st.cg_relres:.2e} (last iteration); the first TOD pass's rows "
        f"{parts['rows']}; the chain holds {names}")
    fin = _finite_state(st) and all(np.isfinite(v["alm"]).all()
                                    for v in last["comps"].values())
    lfi_fin = all(bool(torch.isfinite(getattr(b.state, f)).all())
                  for b in st.bands.values() if b.kind == "lfi"
                  for f in ("gain", "sigma0", "n_corr"))
    # the reference's fault (ROADMAP queue 3 item 16): the zero-sky burn-in
    # calibrates the differential stand-in on the dipole difference alone,
    # which its data lack; its imbalance then runs away and the chain with
    # it (run_multires goes NaN the same way)
    blown = [p["x_im"] for p in parts["passes"] if p["kind"] == "diff"
             and not (p["x_im"] is not None and abs(p["x_im"]) < 1e10)]
    cg_ok = st.cg_relres <= pb.cfg.cg_tol \
        or st.cg_iters == pb.cfg.cg_maxiter
    say(f"[6] multires_tod: state finite {fin}, the LFI stand-ins' TOD "
        f"states finite {lfi_fin}; differential passes whose x_im ran "
        f"away (|x_im| >= 1e10 or not finite, the reference's fault): "
        f"{len(blown)} of {sum(p['kind'] == 'diff' for p in parts['passes'])}"
        f" {blown[:4]}")
    if not (names == ["000001", "000002"] and lfi_fin
            and ((fin and cg_ok) or blown)
            and all(v["qu_changed"] == 0 for v in parts["rows"].values())):
        raise AssertionError("multires_tod: the run does not hold")
    if on_card or any(launches.values()):
        _hold_multires_tod_launches(parts, launches, pb, st)
    measured = dict(run_s=secs, peak_gib=peak, step_s=parts["step_s"],
                    cg=parts["cg"], finite=fin, x_im_ran_away=len(blown),
                    passes=parts["passes"], rows=parts["rows"],
                    launches_by_part={"attempts": parts["steps"],
                                      "build": parts["build"],
                                      "burnin": parts["burnin"]})
    del st, pb
    box.clear()
    if on_card:
        torch.cuda.empty_cache()
    return launches, len(parts["steps"]), measured


# phase 5's CPU float64 references, one worker process started after the
# build (phase5_start), beside phases 3 and 4: its torch threads (the card's
# process, mostly waiting on the card then, keeps one core)
PHASE5_THREADS = 7
PHASE5_DIR = "build/phase5"
PHASE5_WAIT_S = 900.0


def phase5_start(dev) -> dict:
    """Start the worker process that computes phase 5's CPU float64
    references (phase5_worker), so that its CPU steps run beside the card's
    phases 3 and 4: first the jobs that need nothing of the card (entry,
    entry_pol, check (d)'s pass); meanwhile build phase 5's problems on the
    card (entry_full, entry_tod, entry_joint, entry_multires: their data
    and TOD made there) and save what their references need (the card's
    data and TOD in float64, the true amplitudes, the configurations) as
    the worker's second batch. Returns {"keep": the card's problems,
    "proc": the worker, "log": its log}."""
    import os
    import shutil

    on_card = dev.type == "cuda"
    ns, lm = (64, 128) if on_card else (16, 32)
    tod = {} if on_card else dict(nscan=8, ntod=2048)
    msize = {} if on_card else dict(nsides=(8, 8, 16), lmaxs=(16, 16, 32))
    shutil.rmtree(PHASE5_DIR, ignore_errors=True)
    os.makedirs(PHASE5_DIR)
    jobs = {p: dict(fn="_p5_entry", preset=p, nside=ns, lmax=lm)
            for p in ("entry", "entry_pol")}
    # check (d), run in phase 6: its CPU pass needs nothing of the card
    jobs["diff_pass"] = dict(fn="_p5_diff", on_card=on_card)
    _p5_save(jobs, "jobs_cpu.pt")
    # phase 6's sidelobe / zodi / table check needs nothing of the card
    # either; it runs last, after the card's batch
    _p5_save({"templates": dict(fn="_p5_templates", on_card=on_card)},
             "jobs_late.pt")
    env = dict(os.environ, OMP_NUM_THREADS=str(PHASE5_THREADS),
               CUDA_VISIBLE_DEVICES="")
    log = open(os.path.join(PHASE5_DIR, "log.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.phase5_worker())"],
        stdout=log, stderr=subprocess.STDOUT, env=env)
    p5 = dict(proc=proc, log=log, cache={})
    try:
        p5.update(keep=_p5_card_inputs(dev, ns, lm, tod, msize),
                  t0=time.perf_counter())
    except BaseException:
        phase5_stop(p5)
        raise
    return p5


def _p5_card_inputs(dev, ns, lm, tod, msize) -> dict:
    """phase5_start's problems on the card, and the worker's second batch
    of jobs (their references' inputs) saved. Returns the problems."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.instrument import beam

    keep, jobs = {}, {}
    pd = keep["entry_full"] = entry.build_preset(
        "entry_full", torch.float32, dev, nside=ns, lmax=lm)
    jobs["entry_full"] = dict(fn="_p5_full", nside=ns, lmax=lm,
                              data=pd.sys.data.double().cpu())
    c64 = lambda x: None if x is None else x.cpu().double()
    for preset in ("entry_tod", "entry_joint"):
        kw = dict(nside=ns, lmax=lm)
        if tod:
            kw["tod"] = dict(entry.PRESETS[preset]["tod"], **tod)
        pd = keep[preset] = entry.build_preset(preset, torch.float32, dev,
                                               **kw)
        keep[preset + "_bands"] = [
            b._replace(block=b.block.to("cpu", torch.float64),
                       state=b.state.to("cpu", torch.float64))
            for b in pd.bands]
        keep[preset + "_kw"] = kw
        jobs[preset] = dict(fn="_p5_tod", preset=preset, kw=kw, cfg=pd.cfg,
                            data=pd.sys.data.double().cpu(),
                            bands=keep[preset + "_bands"],
                            a=pd.a_true.cpu().to(torch.complex128),
                            t=c64(pd.t_true), p=c64(pd.p_true))
    # the exact pixel windows the multires builds need, on the host
    # (disk-cached after the first computation, whose time this is where
    # none is cached; the worker reads the cache)
    pw_s = {}
    for n, m in zip(msize.get("nsides", (32, 32, 64)),
                    msize.get("lmaxs", (64, 64, 128))):
        t0 = time.perf_counter()
        beam.pixel_window(n, m)
        pw_s.setdefault(f"{n}/{m}", time.perf_counter() - t0)
    keep["pixel_window_s"] = pw_s
    keep["multires_size"] = msize
    pd = keep["entry_multires"] = entry.build_preset(
        "entry_multires", torch.float32, dev, **msize)
    jobs["entry_multires"] = dict(
        fn="_p5_multires", size=msize,
        data=[g.data.double().cpu() for g in pd.ms.groups])
    _p5_save(jobs, "jobs_card.pt")
    return keep


def _p5_save(obj, name: str):
    """torch.save into PHASE5_DIR, made visible whole (a rename)."""
    import os

    tmp = os.path.join(PHASE5_DIR, name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, os.path.join(PHASE5_DIR, name))


def _diff_check_inputs(on_card):
    """The differential pass check's inputs, made on the host alike in both
    processes: a random T/Q/U sky (50 uK rms), a differential block
    simulated from it (nside 64, 8 scans x 2 detectors x 16384 samples; the
    rehearsal nside 16, 4096), its TodConfig and a pass's draws from a CPU
    generator seeded 1. Returns (sky, block on the CPU in float64, cfg,
    draws)."""
    from commander_tpu_torch.tod import differential as td
    from commander_tpu_torch.tod.process import TodConfig

    ns, nt = (64, 16384) if on_card else (16, 4096)
    sky = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (3, 12 * ns * ns)) * 50.0)
    blk, _ = td.simulate_tod_diff(ns, sky, nscan=8, ndet=2, ntod=nt,
                                  pol=True, seed=3, device="cpu")
    cfg = TodConfig(nside=ns, nu=70e9, pol=True)
    return sky, blk, cfg, td.diff_pass_draws(
        cfg, blk, torch.Generator().manual_seed(1))


def _diff_solve(blk, cfg):
    """The mapmaker alone on T at x_im 0.2 (where it converges), unit
    weights."""
    from commander_tpu_torch.tod import differential as td

    npix = 12 * cfg.nside ** 2
    inv_var = torch.ones(blk.tod.shape[:2], dtype=blk.tod.dtype,
                         device=blk.tod.device)
    return td.solve_diff_map(blk.tod, blk.pixA, blk.psiA, blk.pixB,
                             blk.psiB, 0.2, blk.mask, inv_var, npix, False,
                             horns=blk.horns(npix))


def _p5_diff(job):
    """The worker's float64 differential pass (and the pass on the sky
    moved by 1e-14, and the T mapmaker at x_im 0.2) for _diff_parts_check."""
    from commander_tpu_torch.sampling.tod_gibbs import pixel_vectors
    from commander_tpu_torch.tod import differential as td
    from commander_tpu_torch.tod.process import init_tod_state

    sky, blk, cfg, draws = _diff_check_inputs(job["on_card"])
    pv = pixel_vectors(cfg.nside, torch.float64, "cpu")
    t0 = time.perf_counter()
    st, prod = td.process_tod_diff(cfg, blk, init_tod_state(blk), sky, pv,
                                   draws=draws)
    secs = time.perf_counter() - t0
    _, moved = td.process_tod_diff(cfg, blk, init_tod_state(blk),
                                   sky * (1.0 + 1e-14), pv, draws=draws)
    m, res, _ = _diff_solve(blk, cfg)
    return dict(state=st, prod=prod, moved_map=moved["map"], pass_s=secs,
                solve_map=m, solve_iters=res.iters, solve_relres=res.rel_res)


def _diff_parts_check(dev, p5) -> dict:
    """Check (d): a differential pass in float64 on a shared sky, the card
    against the worker's CPU pass (_p5_diff) on the same block and draws:
    the card's pass twice gives the same bits; gains, sigma0, n_corr and
    x_im within 1e-6 of their max, the same mapmaker iteration count; the
    map within max(1e-6, 10x the CPU map's own move under a 1e-14 move of
    the sky) (the pass's imbalance comes out near 0.01, where the mapmaker
    stops at maxiter 150 and rounding moves the map: ROADMAP queue 3 item
    16); the mapmaker alone on T at x_im 0.2, where it converges, within
    1e-6 and at the same iteration. Reported: each side's pass time and the
    T map's departure from the sky at the hit pixels (the horns' orbital
    dipole difference, which the simulation lacks and the pass removes)."""
    from commander_tpu_torch.sampling.tod_gibbs import pixel_vectors
    from commander_tpu_torch.tod import differential as td
    from commander_tpu_torch.tod.process import init_tod_state

    on_card = dev.type == "cuda"
    sky, blk, cfg, draws = _diff_check_inputs(on_card)
    ref = phase5_result(p5, "diff_pass")
    blk_d = blk.to(dev)
    sky_d = sky.to(dev)
    pv = pixel_vectors(cfg.nside, torch.float64, str(dev))
    runs = []
    for _ in range(2):
        _sync()
        t0 = time.perf_counter()
        runs.append(td.process_tod_diff(cfg, blk_d, init_tod_state(blk_d),
                                        sky_d, pv, draws=draws))
        _sync()
        runs[-1] = runs[-1] + (time.perf_counter() - t0,)
    (s0, p0, t_d), (s1, p1, _) = runs
    same = all(torch.equal(p0[k], p1[k]) for k in ("map", "rms", "x_im")) \
        and all(torch.equal(getattr(s0, f), getattr(s1, f))
                for f in ("gain", "sigma0", "n_corr"))
    err = {f: relmax(getattr(s0, f).cpu(), getattr(ref["state"], f))
           for f in ("gain", "sigma0", "n_corr")}
    err["x_im"] = relmax(p0["x_im"].cpu(), ref["prod"]["x_im"])
    spread = relmax(ref["moved_map"], ref["prod"]["map"])
    err["map"] = relmax(p0["map"].cpu(), ref["prod"]["map"])
    m_d, res_d, _ = _diff_solve(blk_d, cfg)
    err["solve_map"] = relmax(m_d.cpu(), ref["solve_map"])
    hit = ref["prod"]["hits"]
    dep = {side: float((m[0].cpu() - sky[0])[hit].abs().max())
           for side, m in (("card", p0["map"]), ("cpu", ref["prod"]["map"]))}
    out = dict(same_bits=same, err=err, map_spread_cpu=spread,
               cg_iters=[p0["cg_iters"], ref["prod"]["cg_iters"]],
               cg_relres=[p0["cg_relres"], ref["prod"]["cg_relres"]],
               x_im_mean=float(p0["x_im"].double().mean()),
               solve_iters=[res_d.iters, ref["solve_iters"]],
               pass_s=[t_d, ref["pass_s"]], map_minus_sky_max_uK=dep,
               shape=list(blk.tod.shape), nside=cfg.nside)
    say(f"[6] differential pass, card against the CPU in float64 on a "
        f"shared sky (nside {cfg.nside}, T/Q/U, {list(blk.tod.shape)} per "
        f"horn): {json.dumps(out)}")
    if not (same and max(err[f] for f in ("gain", "sigma0", "n_corr",
                                           "x_im")) <= 1e-6
            and p0["cg_iters"] == ref["prod"]["cg_iters"]
            and err["map"] <= max(1e-6, 10 * spread)
            and res_d.iters == ref["solve_iters"] < td.MAPMAKER_MAXITER
            and err["solve_map"] <= 1e-6):
        raise AssertionError("the differential pass on the card disagrees "
                             "with the CPU")
    return out


def phase5_worker() -> int:
    """The reference worker's process: each job of phase5_start's three
    batches in order (the second once the card's process has saved it),
    its result saved to PHASE5_DIR/<job>.pt when done. CPU only."""
    import os

    torch.set_num_threads(PHASE5_THREADS)
    t_start = time.perf_counter()
    for batch in ("jobs_cpu.pt", "jobs_card.pt", "jobs_late.pt"):
        path = os.path.join(PHASE5_DIR, batch)
        while not os.path.exists(path):
            if time.perf_counter() - t_start > PHASE5_WAIT_S:
                raise RuntimeError(f"no {batch} after {PHASE5_WAIT_S} s")
            time.sleep(0.2)
        for name, job in torch.load(path, weights_only=False).items():
            t0 = time.perf_counter()
            _p5_save(globals()[job["fn"]](job), f"{name}.pt")
            print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def phase5_result(p5, name):
    """The worker's result for job `name`, waiting for it; a worker that
    ended without it (or a wait past PHASE5_WAIT_S) raises with its log."""
    import os

    if name in p5["cache"]:
        return p5["cache"][name]
    path = os.path.join(PHASE5_DIR, f"{name}.pt")
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if p5["proc"].poll() is not None and not os.path.exists(path):
            raise AssertionError(f"the phase-5 reference worker ended "
                                 f"({p5['proc'].returncode}) without "
                                 f"{name}: {_p5_log()[-3000:]}")
        if time.perf_counter() - t0 > PHASE5_WAIT_S:
            raise AssertionError(f"no phase-5 reference {name} after "
                                 f"{PHASE5_WAIT_S:.0f} s")
        time.sleep(0.5)
    p5["cache"][name] = torch.load(path, weights_only=False)
    return p5["cache"][name]


def _p5_log() -> str:
    import os

    with open(os.path.join(PHASE5_DIR, "log.txt")) as f:
        return f.read()


def phase5_stop(p5):
    """Stop the worker where it still runs (a failure before its last job
    was read)."""
    if p5["proc"].poll() is None:
        p5["proc"].kill()
        p5["proc"].wait()
    p5["log"].close()


def _p5_problem(p5, preset):
    """The CPU float64 build of a phase-5 preset, made here once (the
    holds that take the card's amplitudes use it)."""
    from commander_tpu_torch import entry

    key = "cpu_" + preset
    if key not in p5["cache"]:
        keep = p5["keep"]
        if preset == "entry_multires":
            pc = entry.build_preset(preset, torch.float64, "cpu",
                                    **keep["multires_size"])
            pd = keep[preset]
            pc = pc._replace(ms=dataclasses.replace(pc.ms, groups=tuple(
                dataclasses.replace(gc, data=gd.data.double().cpu())
                for gc, gd in zip(pc.ms.groups, pd.ms.groups))))
        else:
            pc = entry.build_preset(preset, torch.float64, "cpu",
                                    **dict(keep[preset + "_kw"], tod=None))
        p5["cache"][key] = pc
    return p5["cache"][key]


def multires_path_phase(dev, preset, steps, **overrides):
    """Phase 6, the multi-resolution chain: `preset` (tutorial_multires:
    30/44 GHz at nside 512 / lmax 1000, 70 GHz at nside 1024 / lmax 2000,
    T/Q/U, five components, five slots) built (timed), then `steps`
    multires_gibbs_step calls from run_multires' start and a seeded
    generator, the launch counts set to 0 before them and read after them.
    Per step: s/step, CG iterations and relres, peak memory, theta against
    the truth (the sky was made at theta0); outside the counts: ms per
    operator application in all and per group, and the index phase alone
    (CUDA events). Held: finite state, indices on their grids, CG
    converged or at maxiter, the launch counts the code implies: per group
    and application one synthesis and one adjoint, the rhs one adjoint per
    group, each index slot two syntheses per group (residual and amplitude
    through the beams), pt wrapper calls per transform (3 for T/Q/U)."""
    from commander_tpu_torch import entry
    from commander_tpu_torch.sampling import amplitude as amp
    from commander_tpu_torch.sampling import multires as tmr
    from commander_tpu_torch.sampling import multires_gibbs as mg
    from commander_tpu_torch.sphere import cuda_sht

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    timer = Timer(dev)
    t0 = time.perf_counter()
    pb = entry.build_preset(preset, torch.float32, dev, seed=0, **overrides)
    sync()
    build_s = time.perf_counter() - t0
    C, S, nl = pb.ms.cl.shape
    G, nslot = len(pb.ms.groups), len(pb.slots)
    say(f"[6] {preset} groups {pb.groups} (bands per group "
        f"{[g.data.shape[0] for g in pb.ms.groups]}), comps "
        f"{[d.name for d in pb.diffuse]}, Stokes {S}, slots {nslot}: built "
        f"in {build_s:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st = mg.init_state(pb)
    pt = 3 if S == 3 else 1
    for k in cuda_sht.LAUNCHES:
        cuda_sht.LAUNCHES[k] = 0
    launches = {"synth": 0, "adjoint": 0}
    hist = []
    truth = pb.thetas0.tolist()
    for step in range(steps):
        n0 = dict(cuda_sht.LAUNCHES)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st = mg.multires_gibbs_step(pb, st, gen)
        sync()
        secs = time.perf_counter() - t0
        mem = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
        d = {k: cuda_sht.LAUNCHES[k] - n0[k] for k in n0}
        for k in launches:
            launches[k] += d[k]
        n = st.cg_iters
        want = (G * pt * (n + 1) + 2 * nslot * G * pt,
                G * pt * (n + 2)) if on_card else (0, 0)
        if (d["synth"], d["adjoint"]) != want:
            raise AssertionError(f"{preset} step {step + 1}: launch counts "
                                 f"{(d['synth'], d['adjoint'])} != {want}")
        # outside the counts: an operator application, in all and by group,
        # and the index phase alone (fixed uniforms: the chain's generator
        # is left as it is)
        x = st.a
        apply_ms = timer(lambda: tmr.apply_A_multi(st.ms, pb.plans, x), 3)

        def group_term(g):
            sys_g, plan_g = st.ms.groups[g], pb.plans[g]
            a_g = tmr._truncate(x, plan_g.lmax + 1)
            m = amp._synth(plan_g, amp._project_bands(sys_g, plan_g, a_g))
            r_b = amp._synth_T(plan_g, amp.apply_invN(sys_g, m))
            return tmr._pad_back(amp._project_bands_T(sys_g, plan_g, r_b),
                                 nl)

        group_ms = [timer(lambda g=g: group_term(g), 3) for g in range(G)]
        u_half = torch.full((nslot,), 0.5, dtype=torch.float64, device=dev)
        index_ms = timer(lambda: mg.multires_indices(
            pb, st.ms, st.a, st.thetas, u=u_half))
        th = st.thetas.tolist()
        info = dict(step_s=secs, iters=n, relres=st.cg_relres,
                    apply_ms=apply_ms,
                    apply_ms_by_group={str(k): v for k, v in zip(
                        pb.groups, group_ms)},
                    index_phase_ms=index_ms, peak_gib=mem, theta=th,
                    theta_true=truth,
                    theta_minus_truth_steps=[
                        (t - t0_) / h for t, t0_, h in zip(
                            th, truth, _grid_steps(pb.slots))],
                    launches=d)
        hist.append(info)
        say(f"[6] {preset} step {step + 1}: " + json.dumps(info))
        in_range = all(s_.cfg.grid_min <= t <= s_.cfg.grid_max
                       for s_, t in zip(pb.slots, th))
        if not (_finite_state(st) and in_range
                and bool(torch.isfinite(st.thetas).all())):
            raise AssertionError(f"{preset}: non-finite state or an index "
                                 f"outside its grid")
        if not (st.cg_relres <= pb.cfg.cg_tol
                or n == pb.cfg.cg_maxiter):
            raise AssertionError("CG neither converged nor hit maxiter")
    del pb, st
    if on_card:
        torch.cuda.empty_cache()
    return launches, dict(build_s=build_s, steps=hist)


# the program's own entry point at full width (driver_phase): the command
# a user types and the float64 run at a small size; its TOD
# at half the file's 96 scans per band (a depth cut since the host_loop
# phase: the simulation and the TOD passes take half the time)
DRIVER_ARGV = ["param_tutorial_full.txt", "--synthetic", "--pol", "--tod",
               "--f32", "--niter", "2", "--SYNTH_TOD_NSCAN=48", "--outdir",
               "build/driver_out"]
DRIVER_SMALL = ["param_tutorial_full.txt", "--synthetic", "--pol",
                "--nside", "64", "--lmax", "128", "--niter", "2"]
# a chain that spins on rejects fails the phase: each run of the full-width
# command (simulation, warm start, its steps and their output) must end in
# this many seconds (the 25 rejects an iteration may take before it accepts
# would need ~250 s more)
DRIVER_RUN_S = 240.0


# command (a) of the differential slice: the program's float32 command with
# band 070 differential (BAND_TOD_TYPE WMAP); run() never defers a
# differential band (its _accel_tod_ok asks every band to be LFI), so this
# is run()'s host loop in float32 at nside 1024, the band a differential
# block of 24 scans x 4 detectors x 65536 samples
DRIVER_WMAP_ARGV = DRIVER_ARGV[:-2] + ["--BAND_TOD_TYPE003=WMAP", "--outdir",
                                       "build/driver_wmap_out"]


@contextlib.contextmanager
def _diff_probe():
    """tod_gibbs._band_pass and loop.host_tod_phase wrapped for the length
    of a run: per differential pass (the card synchronized around it) its
    ms, mapmaker iterations and relres, x_im and hit share; after each TOD
    stage every band's map against the noiseless band sky (the model's
    meta["sky_true"]): chi^2/dof and hit share per Stokes row
    (tod_gibbs.binned_map_chisq) and the largest departure in uK. Yields
    {"passes": [...], "chi2": [...]}."""
    from commander_tpu_torch.driver import loop
    from commander_tpu_torch.sampling import tod_gibbs

    rec = {"passes": [], "chi2": []}
    real_pass, real_stage = tod_gibbs._band_pass, loop.host_tod_phase

    def band_pass(band, *a, **k):
        if band.kind != "diff":
            return real_pass(band, *a, **k)
        _sync()
        t = time.perf_counter()
        out = real_pass(band, *a, **k)
        _sync()
        p = out[1]
        x = p["x_im"].double()
        rec["passes"].append(dict(
            ms=(time.perf_counter() - t) * 1e3, cg_iters=p["cg_iters"],
            cg_relres=p["cg_relres"], x_im_mean=float(x.mean()),
            x_im_min=float(x.min()), x_im_max=float(x.max()),
            hit=float(p["hits"].double().mean())))
        return out

    def stage(cfg, model, *a, **k):
        bands, sys = real_stage(cfg, model, *a, **k)
        sky = model.meta.get("sky_true")
        if sky is not None:
            sky = sky.to(sys.data)
            c2, hit = tod_gibbs.binned_map_chisq(sys, sky)
            out = {}
            for b, band in enumerate(bands):
                if band is None:
                    continue
                h = sys.inv_rms[b] > 0
                dep = torch.where(h, (sys.data[b] - sky[b]).abs(), 0.0)
                out[cfg.bands[b].label] = dict(
                    kind=band.kind, chi2_dof=c2[b].tolist(),
                    hit=hit[b].tolist(),
                    max_abs_uK=dep.amax(dim=-1).tolist())
            rec["chi2"].append(out)
        return bands, sys

    tod_gibbs._band_pass, loop.host_tod_phase = band_pass, stage
    try:
        yield rec
    finally:
        tod_gibbs._band_pass, loop.host_tod_phase = real_pass, real_stage


def driver_wmap_phase(dev):
    """Phase 6, command (a) of the differential slice: DRIVER_WMAP_ARGV
    through run.main in this process (run()'s host loop in float32 at
    nside 1024: bands 030 and 044 LFI, 070 a differential block), under
    DRIVER_RUN_S. Per attempt s/step split into the TOD stage, the CG and
    the index phase, CG iterations, relres, chi^2; per differential pass
    its mapmaker iterations and relres (tol 1e-8 in float32: maxiter), ms
    and x_im; after each TOD stage every band's map against the noiseless
    band sky; build / simulation / warm start / output seconds; peak
    memory. Held: a finite state, accepted samples at relres <= tol, the
    chain's samples 1-2 with every band's TOD state, the launch counts of
    the build, the warm start and each attempt exactly
    (_hold_host_tod_launches at scalar theta; a differential pass launches
    no kernel: it reads the stage's model sky). Returns (launches,
    attempts, measured)."""
    import shutil

    from commander_tpu_torch import run as trun
    from commander_tpu_torch.io.chain import ChainFile
    from commander_tpu_torch.io.params import Params, lower_params
    from commander_tpu_torch.sphere import cuda_sht

    on_card = dev.type == "cuda"
    argv = list(DRIVER_WMAP_ARGV)
    if not on_card:
        # (at nside 32 this little TOD leaves band 044's gain to run away
        # in float32 on the CPU)
        argv += ["--cpu", "--nside", "16", "--lmax", "32",
                 "--SYNTH_TOD_NSCAN=6", "--SYNTH_TOD_NTOD=2048"]
    out = argv[argv.index("--outdir") + 1]
    shutil.rmtree(out, ignore_errors=True)
    cfg = lower_params(Params.load(argv[0], [a for a in argv
                                             if a.startswith("--")
                                             and "=" in a]))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for k in cuda_sht.LAUNCHES:
        cuda_sht.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with _host_tod_probe(DRIVER_RUN_S, "driver_wmap") as parts, \
            _diff_probe() as diff:
        (res,) = trun.main(argv)
    secs = time.perf_counter() - t0
    launches = dict(cuda_sht.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if on_card else float("nan")
    tm, w = res.timer.acc, res.warm
    say(f"[6] driver_wmap: {' '.join(argv)}")
    say(f"[6] driver_wmap: build {tm.get('init', 0):.1f} s, TOD simulation "
        f"{tm.get('tod_sim', 0):.1f} s, warm start {parts['cg_s'][0]:.1f} s "
        f"(CG iters {w['cg_iters']}, relres {w['cg_relres']:.2e}), burn-in "
        f"{tm.get('tod_burnin', 0) - parts['cg_s'][0]:.1f} s "
        f"({w['npasses']} passes), output {tm.get('output', 0):.1f} s; "
        f"launches: build {parts['build']}, warm start {parts['warm']}")
    steps = []
    for i, (r, d) in enumerate(zip(res.records, parts["attempts"])):
        cg_s = parts["cg_s"][i + 1]
        idx_s = sum(v["seconds"] for v in r["specind"].values())
        steps.append(dict(it=r["it"], attempt=r["attempt"], ok=r["ok"],
                          seconds=r["seconds"], tod_s=r["tod_seconds"],
                          cg_s=cg_s, index_s=idx_s, cg_iters=r["cg_iters"],
                          cg_relres=r["cg_relres"], chisq=r["chisq"]))
        say(f"[6] driver_wmap iteration {r['it']} attempt {r['attempt']}: "
            f"{'accepted' if r['ok'] else 'REJECTED'}"
            f"{' (forced after 25)' if r.get('forced') else ''}, "
            f"{r['seconds']:.2f} s/step: TOD stage {r['tod_seconds']:.2f} "
            f"s, CG (gibbs_step) {cg_s:.2f} s, index phase {idx_s:.2f} s; CG "
            f"iters {r['cg_iters']}, relres {r['cg_relres']:.2e}, chi2 "
            f"{r['chisq']:.6g}; launches {d}")
    for i, p in enumerate(diff["passes"]):
        say(f"[6] driver_wmap differential pass {i + 1} "
            f"({'warm start' if i < w['npasses'] else 'attempt'}): "
            f"{p['ms']:.1f} ms, mapmaker {p['cg_iters']} iterations, relres "
            f"{p['cg_relres']:.3e}, x_im mean {p['x_im_mean']:.5f} "
            f"(min {p['x_im_min']:.5f}, max {p['x_im_max']:.5f}), hit "
            f"{p['hit']:.4f}")
    for i, c in enumerate(diff["chi2"]):
        say(f"[6] driver_wmap TOD stage {i + 1}: maps against the noiseless "
            f"band sky: " + "; ".join(
                f"{lab} ({v['kind']}) chi2/dof "
                f"{[f'{x:.4g}' for x in v['chi2_dof']]}, hit "
                f"{[f'{x:.3f}' for x in v['hit']]}, max |map - sky| "
                f"{[f'{x:.4g}' for x in v['max_abs_uK']]} uK"
                for lab, v in c.items()))
    say(f"[6] driver_wmap: run {secs:.1f} s; peak device memory {peak:.2f} "
        f"GiB; launches {launches}")
    rej = _hold_driver(res, cfg.cg_tol, "wmap")
    with ChainFile(res.chain_path, "r") as ch:
        names = sorted(k for k in ch.f.root.members if k.isdigit())
        tod = ch.read_tod_state(ch.last_sample())
    kinds = [b.kind for b in res.bands]
    say(f"[6] driver_wmap: bands {kinds}; the chain holds {names}, TOD "
        f"state of {sorted(tod)}")
    if names != ["000001", "000002"] or len(tod) != 3 \
            or kinds != ["lfi", "lfi", "diff"] or not diff["passes"]:
        raise AssertionError("driver_wmap: the chain is not samples 1-2 "
                             "with three TOD states, or no differential "
                             "pass ran")
    if on_card or any(launches.values()):
        _hold_host_tod_launches(res, launches, parts, 3, cfg, pixind=False,
                                tag="driver_wmap")
    measured = dict(run_s=secs, peak_gib=peak, rejects=rej, steps=steps,
                    timers=dict(tm), warm=w, diff_passes=diff["passes"],
                    band_chi2=diff["chi2"], launches_by_part={
                        k: parts[k] for k in ("build", "warm", "tod",
                                              "attempts")})
    del res
    if on_card:
        torch.cuda.empty_cache()
    return launches, len(steps), measured


@contextlib.contextmanager
def _driver_probe(limit_s):
    """Wrap the loop's parts for the length of a run: an attempt started
    after limit_s seconds raises (a rejecting chain must not eat the smoke's
    time limit), and the kernels' launches are counted apart in the model's
    build, the warm start and each attempt (its TOD pass and sky phase).
    Yields the dict of those counts."""
    from commander_tpu_torch.driver import loop
    from commander_tpu_torch.sampling import tod_gibbs
    from commander_tpu_torch.sphere import cuda_sht

    t0 = time.perf_counter()
    parts = {"build": None, "warm": None, "attempts": []}
    real = {"sky_phase": loop.sky_phase, "tod_phase": loop.tod_phase,
            "build_model": loop.build_model}
    real_burnin = tod_gibbs.tod_burnin

    def counted(fn, put):
        def f(*a, **k):
            n0 = dict(cuda_sht.LAUNCHES)
            out = fn(*a, **k)
            put({k_: cuda_sht.LAUNCHES[k_] - n0[k_] for k_ in n0})
            return out
        return f

    def new_attempt(d):
        parts["attempts"].append(dict(d))

    def add_sky(d):
        for k in d:
            parts["attempts"][-1][k] += d[k]

    def guarded(*a, **k):
        if time.perf_counter() - t0 > limit_s:
            raise AssertionError(f"driver: the run passed {limit_s:.0f} s: "
                                 f"a chain spinning on rejects?")
        return real["sky_phase"](*a, **k)

    loop.build_model = counted(real["build_model"],
                               lambda d: parts.update(build=d))
    tod_gibbs.tod_burnin = counted(real_burnin,
                                   lambda d: parts.update(warm=d))
    loop.tod_phase = counted(real["tod_phase"], new_attempt)
    loop.sky_phase = counted(guarded, add_sky)
    try:
        yield parts
    finally:
        for k, v in real.items():
            setattr(loop, k, v)
        tod_gibbs.tod_burnin = real_burnin


def _driver_run(dev, argv, tag):
    """One run.main(argv) in this process with the kernels' counts reset
    before it: (RunResult, launches, seconds, peak GiB, launches by part)."""
    from commander_tpu_torch import run as trun
    from commander_tpu_torch.sphere import cuda_sht

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for k in cuda_sht.LAUNCHES:
        cuda_sht.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with _driver_probe(DRIVER_RUN_S) as parts:
        (res,) = trun.main(argv)
    secs = time.perf_counter() - t0
    launches = dict(cuda_sht.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev.type == "cuda" else float("nan")
    tm = res.timer.acc
    say(f"[6] driver {tag}: {' '.join(argv)}")
    w = res.warm
    say(f"[6] driver {tag} warm start: {w['npasses']} TOD passes, CG iters "
        f"{w['cg_iters']}, relres {w['cg_relres']:.2e}, launches "
        f"{parts['warm']}; the model's build: launches {parts['build']}")
    for r, d in zip(res.records, parts["attempts"]):
        say(f"[6] driver {tag} iteration {r['it']} attempt {r['attempt']}: "
            f"{'accepted' if r['ok'] else 'REJECTED'}"
            f"{' (forced after 25)' if r.get('forced') else ''}, "
            f"{r['seconds']:.2f} s/step (TOD pass {r['tod_seconds']:.2f} s), "
            f"CG iters {r['cg_iters']}, relres {r['cg_relres']:.2e}, chi2 "
            f"{r['chisq']:.6g}, launches {d}")
    say(f"[6] driver {tag}: run {secs:.1f} s; build {tm.get('init', 0):.1f} "
        f"s, TOD simulation {tm.get('tod_sim', 0):.1f} s, warm start "
        f"{tm.get('tod_burnin', 0):.1f} s, output {tm.get('output', 0):.1f} "
        f"s; peak device memory {peak:.2f} GiB; launches {launches}")
    return res, launches, secs, peak, parts


def _hold_launches(res, launches, parts, pt, nslot, beam_con, cfg, tag):
    """The launch counts the code implies, exactly: the build one synthesis
    of the noiseless sky (pt); the warm start gibbs_step's CG (the rhs and
    n + 1 operator applications, n its iterations, one more where it broke
    down: relres above tol before maxiter, ops/cg.py) and the model sky of
    its TOD passes; each attempt its TOD pass's model sky, full_gibbs_step's
    CG, per index slot the residual, the amplitude map and (beam-consistent)
    the beamed maps, and the chi^2's model sky; nothing else."""
    def cg(n, relres):
        k = n + 1 + int(relres > cfg.cg_tol and n < cfg.cg_maxiter)
        return pt * k, pt * (k + 1)
    syn, adj = cg(res.warm["cg_iters"], res.warm["cg_relres"])
    want = {"build": {"synth": pt, "adjoint": 0},
            "warm": {"synth": syn + pt, "adjoint": adj}, "attempts": []}
    for r in res.records:
        syn, adj = cg(r["cg_iters"], r["cg_relres"])
        want["attempts"].append({"synth": syn + 2 * pt + nslot * pt
                                 * (2 + int(beam_con)), "adjoint": adj})
    total = {k: want["build"][k] + want["warm"][k]
             + sum(a[k] for a in want["attempts"]) for k in launches}
    got = {k: parts[k] for k in ("build", "warm", "attempts")}
    if got != want or launches != total:
        raise AssertionError(f"driver {tag}: launches {got} (total "
                             f"{launches}) != {want} (total {total})")
    say(f"[6] driver {tag}: launch counts as the code implies, build "
        f"{want['build']}, warm start {want['warm']}, attempts "
        f"{want['attempts']}")


def _hold_driver(res, tol, tag):
    """Finite state; every accepted sample at relres <= tol unless forced
    after 25 rejects; the rejects counted. (The card's float32 run takes the
    fast path, its thetas a tensor; on the CPU, in the rehearsal, run()'s
    route is the host loop, its thetas per-component lists.)"""
    st = res.state
    th = res.thetas if isinstance(res.thetas, torch.Tensor) else [
        torch.as_tensor(t) for row in res.thetas for t in row]
    fin = bool(torch.isfinite(torch.view_as_real(st.a)).all()
               and all(torch.isfinite(t).all() for t in (
                   th if isinstance(th, list) else [th]))
               and (st.t is None or torch.isfinite(st.t).all())
               and (st.p is None or torch.isfinite(st.p).all()))
    bad = [r for r in res.records if r["ok"] and not r.get("forced")
           and not r["cg_relres"] <= tol]
    rejects = sum(not r["ok"] for r in res.records)
    say(f"[6] driver {tag}: state finite {fin}; rejects {rejects} of "
        f"{len(res.records)} attempts")
    if not fin or bad:
        raise AssertionError(f"driver {tag}: state finite {fin}, accepted "
                             f"above tol {bad}")
    return rejects


def kernel_arithmetic():
    """Make the CPU's plain Legendre stage compute as the card's float64
    route does: on the kernels' float32 coefficient pack
    (cuda_sht.pack_otf: the kernels' recurrence, the same lamhat bits) in
    complex64, its output back in the input's dtype. For a witness process
    on the CPU (_small_start's witness, torch_tools/host_loop_rounding.py
    --mode single); never in the program."""
    import dataclasses

    from commander_tpu_torch.sphere import cuda_sht

    otfs = {}

    def single(fn):
        def f(otf, *args):
            if id(otf) not in otfs:
                otfs[id(otf)] = (otf, dataclasses.replace(otf, **{
                    fl.name: getattr(otf, fl.name).to(torch.float32)
                    for fl in dataclasses.fields(otf)
                    if isinstance(getattr(otf, fl.name), torch.Tensor)
                    and getattr(otf, fl.name).dtype == torch.float64}))
            dt = args[0].dtype
            out = fn(otfs[id(otf)][1], *(
                a.to(torch.complex64) if isinstance(a, torch.Tensor) else a
                for a in args))
            return tuple(o.to(dt) for o in out) if isinstance(out, tuple) \
                else out.to(dt)
        return f

    cuda_sht.synth_legendre_plain = single(cuda_sht.synth_legendre_plain)
    cuda_sht.adjoint_legendre_plain = single(
        cuda_sht.adjoint_legendre_plain)


def _small_start(argv, on_card, out, threads=2, witness=False):
    """Start the small float64 command as a user types it (on the card when
    there is one) and its twin on the CPU, run.main(argv + ["--cpu"],
    rng_device="cuda"): the same chain, its draws made by a generator on the
    card; as two processes (the CPU one on `threads` threads, beside the
    full-width run, whose TOD simulation is host work). witness: a third
    process, the CPU twin with the Legendre stage in the kernels' float32
    arithmetic (kernel_arithmetic): how far that stage alone moves the
    chain. Returns [(process, its output directory)]."""
    import os

    rng = f"rng_device={'cuda' if on_card else 'cpu'!r}"
    twin = f"import sys; from commander_tpu_torch import run; " \
           f"run.main(sys.argv[1:], {rng})"
    runs = [(["-m", "commander_tpu_torch"]
             + argv + ([] if on_card else ["--cpu"]), "card"),
            (["-c", twin] + argv + ["--cpu"], "cpu")]
    if witness:
        runs.append((["-c", "import sys, chip_smoke; "
                      "chip_smoke.kernel_arithmetic(); "
                      "from commander_tpu_torch import run; "
                      f"run.main(sys.argv[1:], {rng})"] + argv + ["--cpu"],
                     "cpu_witness"))
    procs = []
    for cmd, sub in runs:
        d = os.path.join(out, sub)
        env = dict(os.environ)
        if sub != "card":
            env["OMP_NUM_THREADS"] = str(threads)
        procs.append((subprocess.Popen(
            [sys.executable] + cmd + ["--outdir", d], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env), d))
    return procs


def _small_wait(procs, tag="driver small"):
    """Wait for the small pair (killing every process of it on a failure
    here); returns the chain files' paths in order. Each run's output goes
    to log.txt in its directory."""
    import os

    paths = []
    try:
        for p, d in procs:
            log, _ = p.communicate(timeout=900)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "log.txt"), "w") as f:
                f.write(log)
            for ln in log.strip().splitlines()[-6:]:
                say(f"[6] {tag} ({os.path.basename(d)}): {ln}")
            if p.returncode != 0:
                raise AssertionError(f"{tag} run failed "
                                     f"({p.returncode}): {log[-2000:]}")
            paths.append(os.path.join(d, "chain_c0001.h5"))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return paths


def driver_phase(dev):
    """Phase 6, the program: python -m commander_tpu_torch as a user runs
    it, through run.main(argv) in this process: param_tutorial_full.txt's
    whole 8-component model from its TOD at nside 1024 / lmax 2000, float32,
    2 iterations (its resume is held on the CPU,
    tests/test_torch_driver*.py: the smoke cut it for time); per attempt
    s/step, CG iterations, relres and the rejects, build / simulation /
    warm start / output seconds and peak memory; held to a finite state,
    accepted samples at relres <= tol, 2 samples in the chain read back
    with the port's ChainFile with every band's TOD state, both kernels'
    launch counts of the build, the warm start and every attempt as the
    code implies them (_hold_launches). Then the float64 command at nside
    64
    / lmax 128 on the card against its twin on the CPU with the card's
    generator (_small_start): alms to 1e-3 of their max, indices to 0.05
    grid step. Returns (launches of the first run, its attempts,
    measured)."""
    import os
    import shutil

    from commander_tpu_torch.driver.model import (comp_to_diffuse,
                                                  diffuse_configs)
    from commander_tpu_torch.io.chain import ChainFile
    from commander_tpu_torch.io.params import Params, lower_params
    from commander_tpu_torch.sampling.full_gibbs import make_index_slots

    on_card = dev.type == "cuda"
    argv = list(DRIVER_ARGV)
    small = list(DRIVER_SMALL)
    if not on_card:
        argv += ["--cpu", "--nside", "32", "--lmax", "64",
                 "--SYNTH_TOD_NSCAN=6", "--SYNTH_TOD_NTOD=2048"]
        small = [a if a not in ("64", "128") else str(int(a) // 4)
                 for a in small]
    out = argv[argv.index("--outdir") + 1]
    shutil.rmtree(out, ignore_errors=True)
    cfg = lower_params(Params.load(argv[0]))
    # float64, small: the card against its CPU twin with the same draws,
    # two processes started now and read after the full-width runs
    small_out = "build/driver_small"
    shutil.rmtree(small_out, ignore_errors=True)
    t_small = time.perf_counter()
    small_procs = _small_start(small, on_card, small_out, threads=4)
    pc = diffuse_configs(cfg)
    slots = make_index_slots([comp_to_diffuse(c) for c in pc], pc)
    try:
        res, launches, secs, peak, parts = _driver_run(dev, argv, "run")
        rej = _hold_driver(res, cfg.cg_tol, "run")
        n_att = len(res.records)
        # b_l carries the pixel window, never 1: the index lnL is
        # beam-consistent (loop.run's beam_con)
        beam_con = True
        if on_card:
            _hold_launches(res, launches, parts, 3, len(slots), beam_con,
                           cfg, "run")
    finally:
        p_card, p_cpu = _small_wait(small_procs)
    secs_small = time.perf_counter() - t_small
    with ChainFile(res.chain_path, "r") as ch:
        names = sorted(k for k in ch.f.root.members if k.isdigit())
        last = ch.read_sample(ch.last_sample())
        tod = ch.read_tod_state(ch.last_sample())
    say(f"[6] driver: the chain holds {len(names)} samples "
        f"{names}; the last has {sorted(last['comps'])}, aux "
        f"{sorted(last['aux'])}, TOD state of {sorted(tod)}")
    if names != ["000001", "000002"] or [
            r["it"] for r in res.records if r["ok"] or r.get("forced")] \
            != [1, 2] or len(tod) != len(cfg.bands):
        raise AssertionError("driver: the chain is not samples 1-2")

    steps = dict(zip([(s.ci, s.which) for s in slots], _grid_steps(slots)))
    e_a, e_th = 0.0, 0.0
    with ChainFile(p_card, "r") as cd, ChainFile(p_cpu, "r") as cc:
        for i in (1, 2):
            sd, sc = cd.read_sample(i), cc.read_sample(i)
            for ci, c in enumerate(pc):
                a, b = sd["comps"][c.label], sc["comps"][c.label]
                e_a = max(e_a, float(np.abs(a["alm"] - b["alm"]).max()
                                     / np.abs(b["alm"]).max()))
                for j, (x, y) in enumerate(zip(a["specind"],
                                               b["specind"])):
                    e_th = max(e_th, abs(x - y) / steps[(ci, j)])
    say(f"[6] driver small float64 ({' '.join(small)}): card and CPU in "
        f"{secs_small:.1f} s (two processes, beside the full-width runs); "
        f"alms {e_a:.2e} of their max (bound 1e-3), indices {e_th:.2e} grid "
        f"steps (bound 0.05)")
    if not e_a <= 1e-3 or not e_th <= 0.05:
        raise AssertionError("driver: the float64 run on the card "
                             "disagrees with --cpu")
    measured = dict(
        run_s=secs, peak_gib=peak,
        rejects=[rej], small_s=secs_small, small_err=[e_a, e_th],
        steps=[dict((k, r[k]) for k in ("it", "attempt", "ok", "seconds",
                                       "tod_seconds", "cg_iters",
                                       "cg_relres"))
               for r in res.records],
        timers=[res.timer.acc], warm=[res.warm],
        launches_by_part=[parts])
    del res
    if on_card:
        torch.cuda.empty_cache()
    return launches, n_att, measured


# the full-width host-loop command: the file's whole 8-component model with
# its template and source rows, in float64 (the Legendre stage in the
# float32 kernels through their cast route). In float32 its joint CG breaks
# down (172 iterations, relres 9.5e-3) and every attempt is rejected: five
# components on three bands leave directions to the priors alone, and at
# this nside the data fix the others ~1e8 times harder, past what float32
# vectors hold; the JAX package's float32 CG stalls the same way
# (tests/test_torch_host_loop.py, ROADMAP queue 3 item 10e)
HOST_ARGV = ["param_tutorial_full.txt", "--synthetic", "--pol", "--pixind",
             "--COMP_LMAX_IND02=100", "--niter", "1",
             "--outdir", "build/host_out"]
# the index step's theta maps, card against the CPU, in grid steps in the
# worst pixel: sound runs read 0.054-0.062 at nside 64 (the card's float32
# transforms; NVIDIA H100, PERF.md), a planted wrong draw (_host_parts_check)
# reads far above
THETA_STEPS = 0.1
# the float64 pairs of the host loop (card against its CPU twin), one
# iteration each: the pixel-mixing CG of a second attempt amplifies the
# card's float32 transforms (its float64 route casts them) by ~1e6 in ~20
# iterations, so that two iterations part by 4e-2-0.2 of the alms
# (torch_tools/host_loop_rounding.py, ROADMAP queue 3 item 10d);
# host_loop_phase holds that operator and the index step's MH on the card
# against the CPU directly (_host_parts_check)
_SMALL = ["param_tutorial_full.txt", "--synthetic", "--pol", "--nside", "64",
          "--lmax", "128", "--niter", "1", "--pixind",
          "--COMP_LMAX_IND02=100"]
HOST_SMALL = {
    "te_resample": _SMALL + ["--te-cl", "--RESAMPLE_CMB=.true.",
                             "--COMP_BETA_POLTYPE03=2"],
    "pixreg_smoothing": _SMALL + [
        "--ALMSAMP_PIXREG=.true.", "--COMP_BETA_NUM_PIXREG02=12",
        "--COMP_BETA_SMOOTHING_SCALE03=1", "--NUM_SMOOTHING_SCALES=1",
        "--SMOOTHING_SCALE_FWHM01=600",
        "--SMOOTHING_SCALE_FWHM_POSTPROC01=300",
        "--SMOOTHING_SCALE_NSIDE01=16", "--SMOOTHING_SCALE_LMAX01=32"]}
# the full-width host-loop run must end in this many seconds (a chain that
# rejects fails the phase instead of spinning)
HOST_RUN_S = 240.0


@contextlib.contextmanager
def _host_probe(limit_s):
    """loop.build_model and loop.host_phase wrapped for the length of a run:
    the kernels' launches counted apart in the build and in each attempt,
    and an attempt started after limit_s seconds raises. Yields the
    counts."""
    from commander_tpu_torch.driver import loop
    from commander_tpu_torch.sphere import cuda_sht

    t0 = time.perf_counter()
    parts = {"build": None, "attempts": []}
    real = {"build_model": loop.build_model, "host_phase": loop.host_phase}

    def counted(fn, put, limit=None):
        def f(*a, **k):
            if limit is not None and time.perf_counter() - t0 > limit:
                raise AssertionError(f"host_loop: the run passed {limit:.0f}"
                                     f" s: a chain spinning on rejects?")
            n0 = dict(cuda_sht.LAUNCHES)
            out = fn(*a, **k)
            put({k_: cuda_sht.LAUNCHES[k_] - n0[k_] for k_ in n0})
            return out
        return f

    loop.build_model = counted(real["build_model"],
                               lambda d: parts.update(build=d))
    loop.host_phase = counted(real["host_phase"], parts["attempts"].append,
                              limit_s)
    try:
        yield parts
    finally:
        for k, v in real.items():
            setattr(loop, k, v)


def _host_attempt_want(r, fp, pt, beam_con, cfg, fp_after=True) -> dict:
    """One host-loop attempt's launches after its TOD stage (host_phase),
    at scalar F or under F_pix (fp), from its record r (_hold_host_launches
    says what each term is); fp_after: the chi^2's model sky under F_pix
    (the index step made theta maps), else at scalar F (one synthesis)."""
    k = r["cg_iters"] + 1 + int(r["cg_relres"] > cfg.cg_tol
                                and r["cg_iters"] < cfg.cg_maxiter)
    syn, adj = (3 * pt * k + pt, 3 * pt * k + 2 * pt) if fp \
        else (pt * k, pt * (k + 1))
    for rec in r["specind"].values():
        syn += (2 * pt if fp else pt) + pt * (1 + int(beam_con))
        adj += pt if fp else 0
        if rec["branch"] == "alm":
            syn += 5
    if not fp_after:
        return {"synth": syn + pt, "adjoint": adj}
    return {"synth": syn + 2 * pt, "adjoint": adj + pt}


def _hold_host_launches(res, launches, parts, pt, beam_con, cfg):
    """The launch counts the code implies, exactly: the build one synthesis
    (pt wrapper calls: spin 0 and spin 2 at mp -2, +2); per attempt
    gibbs_step's CG (k = n + 1 operator applications, one more where it
    broke down) -- at scalar F a synthesis and an adjoint each, the rhs one
    adjoint; under F_pix (from the second attempt on) three of each, the
    rhs two adjoints and a synthesis (_forward_pixmix_T) -- then per index
    parameter the residual (one synthesis; under F_pix two and an adjoint),
    the amplitude map and, beam-consistent, the beamed maps, and for the
    alm field its 3 + 2 spin-0 maps (the start, 3 proposals, the result);
    the chi^2's model sky under the new F_pix (two syntheses, an adjoint)."""
    want = {"build": {"synth": pt, "adjoint": 0},
            "attempts": [_host_attempt_want(r, i > 0, pt, beam_con, cfg)
                         for i, r in enumerate(res.records)]}
    total = {k: want["build"][k] + sum(a[k] for a in want["attempts"])
             for k in launches}
    got = {k: parts[k] for k in ("build", "attempts")}
    if got != want or launches != total:
        raise AssertionError(f"host_loop: launches {got} (total {launches})"
                             f" != {want} (total {total})")
    say(f"[6] host_loop: launch counts as the code implies, build "
        f"{want['build']}, attempts {want['attempts']}")


def _host_indices(argv):
    """{(component label, parameter index): (grid lo, hi, step)} of the
    host loop's index parameters under argv's configuration."""
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
            out[(c.label, j)] = (lo, hi, (hi - lo) / (hs.NGRID - 1))
    return cfg, out


def _mh_lines(log: str) -> list:
    """The MH acceptances a run printed (loop._host_lines), in order."""
    return re.findall(r"index (\S+) alm\S* [0-9.]+s acc (\d+)/\d|"
                      r"resample acc (\[.*\])", log)


def _host_smalls(on_card) -> dict:
    """HOST_SMALL's commands, at a quarter of their nside in the CPU
    rehearsal."""
    smalls = {k: list(v) for k, v in HOST_SMALL.items()}
    if not on_card:
        for k, v in smalls.items():
            smalls[k] = [{"64": "8", "128": "16", "16": "4",
                          "32": "8"}.get(a, a) for a in v]
    return smalls


def _theta_steps(got, ref, labels, grids) -> tuple:
    """(worst pixel, median pixel) of |got - ref| in grid steps, the larger
    over the index parameters; got, ref: per component a list of thetas."""
    f64 = lambda t: torch.as_tensor(t, dtype=torch.float64).reshape(-1) \
        .cpu()
    worst = med = 0.0
    for ci, (tc, tr) in enumerate(zip(got, ref)):
        for j, (x, y) in enumerate(zip(tc, tr)):
            d = torch.abs(f64(x) - f64(y)) / grids[(labels[ci], j)][2]
            worst, med = max(worst, float(d.max())), max(med,
                                                         float(d.median()))
    return worst, med


def _host_parts_check(dev) -> dict:
    """The host loop's parts on the card against the CPU, in float64 at
    nside 32 / lmax 64 on HOST_SMALL's te_resample configuration (the
    rehearsal: nside 8), both sides on the card's data and the same
    amplitudes (the truth alms, the sources' true amplitudes): the
    pixel-mixing operator (joint.apply_A_joint under F_pix from synch and
    dust beta maps, one vector) and its model sky (chisq.sky_signal), each
    to 1e-3 of its max, the bound of the smoke's other card-against-CPU
    holds (the card's transforms are the float32 kernels, held alone to
    1e-5 in phase 3; the sky composes three of them with the beams, which
    shrink the output against the inputs); then one specind_step, each side
    drawing from a generator on the card seeded alike: the MH acceptances
    identical, F_pix to 1e-3, the theta maps to THETA_STEPS grid steps in
    every pixel. A planted wrong draw (the CPU's step given the Q and U
    amplitudes swapped, as a Stokes-layout fault would give them) must read
    above THETA_STEPS, or the hold is blind. nside 32 and not the pairs' 64:
    the operator and the step run the same code and kernels at either, the
    nside-64 pairs hold the theta maps too, and the CPU's share here is
    ~4x smaller. Returns the errors."""
    from commander_tpu_torch.driver import specind as hs
    from commander_tpu_torch.driver.model import build_model, diffuse_configs
    from commander_tpu_torch.io.params import Params, lower_params
    from commander_tpu_torch.sampling import chisq, joint
    from commander_tpu_torch.sampling.gibbs import GibbsState

    on_card = dev.type == "cuda"
    ns, lm = (32, 64) if on_card else (8, 16)
    argv = _host_smalls(on_card)["te_resample"]
    cfg = lower_params(Params.load(argv[0], [a for a in argv
                                             if a.startswith("--")
                                             and "=" in a]))
    _, grids = _host_indices(argv)
    labels = [c.label for c in diffuse_configs(cfg)]
    rng = np.random.default_rng(5)
    P, nl = 12 * ns * ns, lm + 1
    maps = {(1, 0): -3.1 + 0.3 * np.tanh(rng.standard_normal(P)),
            (2, 0): 1.6 + 0.2 * np.tanh(rng.standard_normal(P))}
    a = (rng.standard_normal((5, 3, nl, nl))
         + 1j * rng.standard_normal((5, 3, nl, nl))) * np.tril(
             np.ones((nl, nl)))
    a[..., 0] = a[..., 0].real

    def step(m, d, amps):
        gen = torch.Generator(dev)
        gen.manual_seed(17)
        st = GibbsState(a=amps, cl_bins=None, t=m.ts.prior_mean,
                        p=torch.as_tensor(m.meta["ptsrc_true"], device=d))
        thetas = [list(c.theta0) for c in m.diffuse]
        sys_i, recs = hs.specind_step(
            cfg, m.pcfgs, m.diffuse, m.bps, m.sys, m.plan, st, thetas,
            hs.HostState(), pixind=True, pol=True, synthetic=True, ts=m.ts,
            ps=m.ps, generator=gen)
        return sys_i, thetas, {k: v.get("accepted") for k, v in recs.items()}

    got, data = {}, None
    for d in (dev, torch.device("cpu")):
        m = build_model(cfg, nside=ns, lmax=lm, synthetic=True,
                        dtype=torch.float64, pol=True, device=d)
        if data is None:
            data = m.sys.data
        m = m._replace(sys=dataclasses.replace(m.sys, data=data.to(d)))
        th = [[torch.as_tensor(maps[(ci, j)], device=d) if (ci, j) in maps
               else t for j, t in enumerate(c.theta0)]
              for ci, c in enumerate(m.diffuse)]
        sys_ = hs.rebuild_mixing(m.diffuse, m.bps, th, m.sys)
        x = joint.JointState(
            a=torch.as_tensor(a, device=d),
            t=torch.ones(m.ts.ntemp, dtype=torch.float64, device=d),
            p=torch.ones(m.ps.pix.shape[0], dtype=torch.float64, device=d))
        y = joint.apply_A_joint(sys_, m.plan, m.ts, m.ps, x)
        r = {"A.a": y.a.cpu(), "A.t": y.t.cpu(), "A.p": y.p.cpu(),
             "sky": chisq.sky_signal(sys_, m.plan, x.a).cpu()}
        # the index step given the same amplitudes
        sys_i, thetas, r["mh"] = step(m, d, m.truth)
        r["F_pix"] = sys_i.F_pix.cpu()
        r["thetas"] = thetas
        if d.type == "cpu":
            _, r["planted"], _ = step(m, d, m.truth[:, [0, 2, 1]])
        got[d.type] = r
    ref, card = got["cpu"], got[dev.type]
    err = {k: relmax(card[k], ref[k])
           for k in ("A.a", "A.t", "A.p", "sky", "F_pix")}
    err["theta_steps"], err["theta_steps_median"] = _theta_steps(
        card["thetas"], ref["thetas"], labels, grids)
    err["theta_steps_planted"], _ = _theta_steps(
        ref["planted"], ref["thetas"], labels, grids)
    err["mh_same"] = card["mh"] == ref["mh"]
    say(f"[6] host_loop: the host loop's parts in float64 at nside {ns}, "
        f"card against the CPU on the same data and amplitudes: operator, "
        f"model sky, F_pix (max |diff| / max, bound 1e-3), the index step's "
        f"theta maps in grid steps (worst pixel, bound {THETA_STEPS}; a "
        f"planted wrong draw reads {err['theta_steps_planted']:.3g}), MH "
        f"acceptances {card['mh']} (the same: {err['mh_same']}): {err}")
    if not (all(err[k] <= 1e-3 for k in ("A.a", "A.t", "A.p", "sky",
                                          "F_pix")) and err["mh_same"]
            and err["theta_steps"] <= THETA_STEPS):
        raise AssertionError("host_loop: the host loop's parts on the card "
                             "disagree with the CPU")
    if not err["theta_steps_planted"] > THETA_STEPS:
        raise AssertionError("host_loop: the theta hold does not see a "
                             "planted wrong draw")
    return err


def host_loop_phase(dev):
    """Phase 6, run()'s host loop through the program: HOST_ARGV (the file
    at nside 1024 / lmax 2000, float64, its whole model: cmb, synch, dust,
    ff and ame with the md, radio and relquad rows, synch beta an alm field
    to l = 100, the four other index parameters per pixel) through
    run.main in this process, under HOST_RUN_S; per attempt s/step, CG
    iterations and relres, the index phase by parameter, the MH
    acceptances; ms per operator application at scalar F and under F_pix;
    peak memory; held to a finite state, accepted samples at relres <= tol,
    theta maps inside their grids, the chain read back with theta_map
    entries, the launch counts of the build and each attempt exactly
    (_hold_host_launches). Beside it the float64 command at nside 64 / lmax
    128 on the card against its CPU twin with the card's generator, for
    each HOST_SMALL configuration: alms to 1e-3 of their max, the same MH
    acceptances, the theta maps to THETA_STEPS grid steps in every pixel;
    and the host loop's parts in float64 at nside 32 on the card against
    the CPU given the same data and amplitudes (_host_parts_check: the
    pixel-mixing operator and sky, F_pix, the MH acceptances, the index
    step's theta maps). Returns (launches, attempts, measured)."""
    import os
    import shutil

    from commander_tpu_torch import run as trun
    from commander_tpu_torch.driver.model import diffuse_configs
    from commander_tpu_torch.io.chain import ChainFile
    from commander_tpu_torch.sampling import joint
    from commander_tpu_torch.sphere import cuda_sht

    on_card = dev.type == "cuda"
    argv = list(HOST_ARGV)
    smalls = _host_smalls(on_card)
    if not on_card:
        argv += ["--cpu", "--nside", "16", "--lmax", "32"]
    out = argv[argv.index("--outdir") + 1]
    shutil.rmtree(out, ignore_errors=True)
    cfg, grids = _host_indices(argv)
    labels = [c.label for c in diffuse_configs(cfg)]
    names = [[f"{c.label}.{n}" for n in c.indices]
             for c in diffuse_configs(cfg)]
    t_small = time.perf_counter()
    procs = {}
    for k, a in smalls.items():
        d = f"build/host_small_{k}"
        shutil.rmtree(d, ignore_errors=True)
        procs[k] = _small_start(a, on_card, d)
    try:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for k in cuda_sht.LAUNCHES:
            cuda_sht.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        with _host_probe(HOST_RUN_S) as parts:
            (res,) = trun.main(argv)
        secs = time.perf_counter() - t0
        launches = dict(cuda_sht.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if on_card else float("nan")
        tm = res.timer.acc
        say(f"[6] host_loop: {' '.join(argv)}")
        for r, d in zip(res.records, parts["attempts"]):
            idx = "; ".join(
                f"{names[ci][j]} {v['branch']} {v['seconds']:.3f} s"
                + (f" acc {v['accepted']}/3" if "accepted" in v else "")
                for (ci, j), v in r["specind"].items())
            say(f"[6] host_loop iteration {r['it']} attempt {r['attempt']}: "
                f"{'accepted' if r['ok'] else 'REJECTED'}, "
                f"{r['seconds']:.2f} s/step, CG iters {r['cg_iters']}, "
                f"relres {r['cg_relres']:.2e}, chi2 {r['chisq']:.6g}; index "
                f"phase {sum(v['seconds'] for v in r['specind'].values()):.2f}"
                f" s: {idx}; launches {d}")
        say(f"[6] host_loop: run {secs:.1f} s; build {tm.get('init', 0):.1f}"
            f" s, output {tm.get('output', 0):.1f} s; peak device memory "
            f"{peak:.2f} GiB; launches {launches}")
        # the state and the chain
        st = res.state
        fin = bool(torch.isfinite(torch.view_as_real(st.a)).all()
                   and torch.isfinite(st.t).all()
                   and torch.isfinite(st.p).all())
        maps_in = {}
        for ci, th in enumerate(res.thetas):
            for j, t in enumerate(th):
                lo, hi, _ = grids[(labels[ci], j)]
                t = torch.as_tensor(t)
                maps_in[names[ci][j]] = bool(
                    torch.isfinite(t).all() and t.min() >= lo - 1e-9
                    and t.max() <= hi + 1e-9)
        bad = [r for r in res.records if r["ok"] and not r.get("forced")
               and not r["cg_relres"] <= cfg.cg_tol]
        accepted = [r["it"] for r in res.records if r["ok"]]
        with ChainFile(res.chain_path, "r") as ch:
            last = ch.read_sample(ch.last_sample())
            nsamp = ch.last_sample()
        tmaps = sorted(f"{c}.{k}" for c, f in last["comps"].items()
                       for k in f if k.startswith("theta_map"))
        say(f"[6] host_loop: state finite {fin}; theta inside the grids "
            f"{maps_in}; accepted iterations {accepted}; the chain's sample "
            f"{nsamp} has theta maps {tmaps}")
        nmaps_want = sum(len(c.indices) for c in diffuse_configs(cfg))
        niter = int(argv[argv.index("--niter") + 1])
        if not fin or bad or not all(maps_in.values()) \
                or accepted != list(range(1, niter + 1)) or nsamp != niter \
                or len(tmaps) != nmaps_want:
            raise AssertionError("host_loop: the full-width run does not "
                                 "hold")
        if on_card:
            _hold_host_launches(res, launches, parts, 3, True, cfg)
        # ms per operator application, scalar F and F_pix (outside counts)
        timer = Timer(dev)
        m = res.model
        x = joint.JointState(a=st.a, t=st.t, p=st.p)
        ms = {}
        for name, sys_ in (("F_pix", res.sys),
                           ("scalar_F", dataclasses.replace(res.sys,
                                                            F_pix=None))):
            f = lambda: joint.apply_A_joint(sys_, m.plan, m.ts, m.ps, x)
            f()
            ms[name] = timer(f, 3)
        say(f"[6] host_loop: ms per operator application {ms}")
        op_err = _host_parts_check(dev)
    finally:
        small_paths = {}
        try:
            for k, p in procs.items():
                small_paths[k] = _small_wait(p, f"host_loop small {k}")
        finally:
            for p, _ in (x for v in procs.values() for x in v):
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    secs_small = time.perf_counter() - t_small
    errs = {}
    for k, (p_card, p_cpu) in small_paths.items():
        _, g = _host_indices(smalls[k])
        e_a = e_th = 0.0
        with ChainFile(p_card, "r") as cd, ChainFile(p_cpu, "r") as cc:
            for i in (1,):
                sd, sc = cd.read_sample(i), cc.read_sample(i)
                for c, a in sc["comps"].items():
                    b = sd["comps"][c]
                    e_a = max(e_a, float(np.abs(b["alm"] - a["alm"]).max()
                                         / np.abs(a["alm"]).max()))
                    for j in range(len(a["specind"])):
                        key = f"theta_map{j}"
                        x, y = (b[key], a[key]) if key in a else (
                            b["specind"][j], a["specind"][j])
                        e_th = max(e_th, float(np.max(np.abs(x - y)))
                                   / g[(c, j)][2])
        logs = [open(os.path.join(os.path.dirname(p), "log.txt")).read()
                for p in (p_card, p_cpu)]
        mh = [_mh_lines(x) for x in logs]
        errs[k] = dict(alm=e_a, theta_steps=e_th, mh_same=mh[0] == mh[1],
                       mh=mh[0])
        say(f"[6] host_loop small float64 {k} ({' '.join(smalls[k])}): card"
            f" and CPU: alms {e_a:.2e} of their max (bound 1e-3), theta "
            f"maps {e_th:.2e} grid steps at most (bound {THETA_STEPS}), MH "
            f"acceptances {mh[0]} "
            f"on the card, the same on the CPU {mh[0] == mh[1]}")
        if not e_a <= 1e-3 or not e_th <= THETA_STEPS or mh[0] != mh[1]:
            raise AssertionError(f"host_loop: the float64 run {k} on the "
                                 f"card disagrees with --cpu")
    measured = dict(
        run_s=secs, peak_gib=peak, small_s=secs_small, small=errs,
        ms_per_apply=ms, parts_card_vs_cpu=op_err,
        steps=[dict((k, r[k]) for k in ("it", "attempt", "ok", "seconds",
                                       "cg_iters", "cg_relres"))
               | {"index_s": {f"{ci}.{j}": v["seconds"]
                              for (ci, j), v in r["specind"].items()},
                  "mh": {f"{ci}.{j}": v.get("accepted")
                         for (ci, j), v in r["specind"].items()}}
               for r in res.records],
        timers=res.timer.acc, launches_by_part=parts)
    del res
    if on_card:
        torch.cuda.empty_cache()
    return launches, len(measured["steps"]), measured


# the reference tutorial's TOD setting as a user types it (synch beta an alm
# field to l = 100, every band's bandpass and the TOD monopoles sampled), in
# float64, which takes run()'s host loop; --SYNTH_TOD_NSCAN=48 is the
# smoke's depth cut of the file's 96 scans, as the driver phase's
HOST_TOD_ARGV = ["param_tutorial_full.txt", "--synthetic", "--pol", "--tod",
                 "--pixind", "--COMP_LMAX_IND02=100",
                 "--BAND_SAMP_BANDPASS001=.true.",
                 "--BAND_SAMP_BANDPASS002=.true.",
                 "--BAND_SAMP_BANDPASS003=.true.",
                 "--SAMPLE_TOD_MONOPOLE=.true.", "--niter", "1",
                 "--SYNTH_TOD_NSCAN=48", "--outdir", "build/host_tod_out"]
# the full-width run must end in this many seconds
HOST_TOD_RUN_S = 360.0
# the float64 pairs (card against its CPU twin; _hold_tod_pair), one
# iteration each, from TOD at nside 64 with the TOD cut to 8 scans x 16384
# samples so that the CPU twin keeps pace: (a) the command above with the
# 4D maps and the port-only monopole guard (the reference's unguarded
# Stokes solve is rounding noise on the pixels seen at fewer than three
# angles, which parts the card from the CPU: ROADMAP queue 3 item 4a),
# beside a witness (WITNESS_PAIRS: the whole model's CG on TOD maps
# amplifies the float32 Legendre stage's rounding, item 10d); (b)
# one map-level band (BAND_TOD_TYPE none) beside an unpolarized TOD band
# (the run is then T only); and (c) --cg-groups with a user group written
# on the command line, at map level and nside 32 (nine CG solves a step on
# the CPU); (b)'s unpolarized band is differential (BAND_TOD_TYPE WMAP).
# The bandpass move's general form (under F_pix, from a second
# iteration) is held in _tod_parts_check on the same inputs instead, with
# the 4D maps
_TOD_SMALL = ["param_tutorial_full.txt", "--synthetic", "--pol", "--nside",
              "64", "--lmax", "128", "--tod", "--SYNTH_TOD_NSCAN=8",
              "--SYNTH_TOD_NTOD=16384"]
HOST_TOD_SMALL = {
    "a_bp_mono_4d": _TOD_SMALL + HOST_TOD_ARGV[4:10] + [
        "--niter", "1", "--tod-mono-guard",
        "--TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER=1"],
    "b_mixed": _TOD_SMALL + ["--niter", "1", "--BAND_TOD_TYPE003=none",
                             "--BAND_POLARIZATION002=.false.",
                             "--BAND_TOD_TYPE002=WMAP",
                             "--BAND_SAMP_BANDPASS001=.true."],
    "c_cg_groups": ["param_tutorial_full.txt", "--synthetic", "--pol",
                    "--nside", "32", "--lmax", "64", "--niter", "1",
                    "--cg-groups", "--NUM_CG_SAMPLING_GROUPS=1",
                    "--CG_SAMPLING_GROUP01=md,cmb",
                    "--CG_SAMPLING_GROUP_MAXITER01=100"]}
# the pairs' TOD gains and sigma0, relative to their max
TOD_PAIR_TOL = 1e-3
# the pairs run beside a witness (_small_start), whose distance from the
# CPU twin sets the card's bounds (_hold_tod_pair)
WITNESS_PAIRS = ("a_bp_mono_4d",)
WITNESS_FACTOR = 10.0


@contextlib.contextmanager
def _host_tod_probe(limit_s, tag="host_loop_tod"):
    """loop.build_model, the warm start, the TOD stage and host_phase
    wrapped for the length of a run: the kernels' launches counted apart in
    the build, the warm start and each attempt (its TOD stage and the rest),
    every gibbs_step timed on the host clock with the card synchronized, an
    attempt started after limit_s seconds raises. Yields the counts."""
    from commander_tpu_torch.driver import loop
    from commander_tpu_torch.sampling import gibbs as gibbs_mod
    from commander_tpu_torch.sampling import tod_gibbs
    from commander_tpu_torch.sphere import cuda_sht

    t0 = time.perf_counter()
    parts = {"build": None, "warm": None, "tod": [], "attempts": [],
             "cg_s": []}
    real = {k: getattr(loop, k) for k in ("build_model", "host_tod_phase",
                                          "host_phase")}
    real_step, real_burnin = gibbs_mod.gibbs_step, tod_gibbs.tod_burnin

    def counted(fn, put, limit=None):
        def f(*a, **k):
            if limit is not None and time.perf_counter() - t0 > limit:
                raise AssertionError(f"{tag}: the run passed "
                                     f"{limit:.0f} s: a chain spinning on "
                                     f"rejects?")
            n0 = dict(cuda_sht.LAUNCHES)
            out = fn(*a, **k)
            put({k_: cuda_sht.LAUNCHES[k_] - n0[k_] for k_ in n0})
            return out
        return f

    def timed(*a, **k):
        _sync()
        t = time.perf_counter()
        out = real_step(*a, **k)
        _sync()
        parts["cg_s"].append(time.perf_counter() - t)
        return out

    def add(d):
        parts["attempts"].append({k: parts["tod"][-1][k] + d[k] for k in d})

    loop.build_model = counted(real["build_model"],
                               lambda d: parts.update(build=d))
    tod_gibbs.tod_burnin = counted(real_burnin,
                                   lambda d: parts.update(warm=d))
    loop.host_tod_phase = counted(real["host_tod_phase"],
                                  parts["tod"].append, limit_s)
    loop.host_phase = counted(real["host_phase"], add)
    gibbs_mod.gibbs_step = timed
    try:
        yield parts
    finally:
        for k, v in real.items():
            setattr(loop, k, v)
        gibbs_mod.gibbs_step = real_step
        tod_gibbs.tod_burnin = real_burnin


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _hold_host_tod_launches(res, launches, parts, pt, cfg, pixind=True,
                            tag="host_loop_tod"):
    """The launch counts the code implies, exactly: the build one synthesis
    (pt); the warm start gibbs_step's joint CG (k = n + 1 applications, one
    more where it broke down: k synthesis, k + 1 adjoint groups) and the
    burn-in's model sky; per attempt the TOD stage -- the model sky (one
    synthesis at scalar F; under F_pix two and an adjoint) and per band's
    bandpass move in the fast form its unit component maps (one synthesis),
    in the general form the proposal's sky (two and an adjoint) -- then
    host_phase (_host_attempt_want; without pixind every attempt at
    scalar F); nothing else."""
    w = res.warm
    k = w["cg_iters"] + 1 + int(w["cg_relres"] > cfg.cg_tol
                                and w["cg_iters"] < cfg.cg_maxiter)
    want = {"build": {"synth": pt, "adjoint": 0},
            "warm": {"synth": pt * k + pt, "adjoint": pt * (k + 1)},
            "tod": [], "attempts": []}
    for i, r in enumerate(res.records):
        fp = pixind and i > 0
        fast = [b["form"] == "fast" for b in r["bp"].values()]
        tod = {"synth": (2 * pt if fp else pt) + sum(
                   pt if f else 2 * pt for f in fast),
               "adjoint": (pt if fp else 0) + sum(0 if f else pt
                                                  for f in fast)}
        host = _host_attempt_want(r, fp, pt, True, cfg, fp_after=pixind)
        want["tod"].append(tod)
        want["attempts"].append({k_: tod[k_] + host[k_] for k_ in tod})
    total = {k_: want["build"][k_] + want["warm"][k_]
             + sum(a[k_] for a in want["attempts"]) for k_ in launches}
    got = {k_: parts[k_] for k_ in ("build", "warm", "tod", "attempts")}
    if got != want or launches != total:
        raise AssertionError(f"{tag}: launches {got} (total "
                             f"{launches}) != {want} (total {total})")
    say(f"[6] {tag}: launch counts as the code implies, build "
        f"{want['build']}, warm start {want['warm']}, attempts (TOD stage "
        f"and all) {want['attempts']}")


def _psi_coverage(band) -> dict:
    """Of a band's hit pixels, how many are seen at fewer than three
    distinct polarization angles (their Stokes block is singular), on the
    card."""
    blk = band.block
    m = blk.mask > 0
    pix = blk.pix[m].to(torch.int64)
    psi = blk.psi[m].to(torch.float64)
    o = torch.argsort(psi, stable=True)
    pix, psi = pix[o], psi[o]
    o = torch.argsort(pix, stable=True)
    pix, psi = pix[o], psi[o]
    new = torch.ones_like(pix, dtype=torch.bool)
    new[1:] = (pix[1:] != pix[:-1]) | (psi[1:] != psi[:-1])
    nd = torch.bincount(pix[new], minlength=12 * band.cfg.nside ** 2)
    hit = int(torch.count_nonzero(nd))
    few = int(torch.count_nonzero((nd > 0) & (nd < 3)))
    return dict(hit=hit, fewer_than_3_psi=few,
                share=few / max(hit, 1))


def _log_lines(log: str, word: str) -> list:
    """The lines of a run's log with `word`, in order, each with the
    iteration it follows (loop._host_lines prints them after it)."""
    out, it = [], 0
    for ln in log.splitlines():
        mt = re.match(r"iter\s+(\d+)", ln)
        if mt:
            it = int(mt.group(1))
        elif word in ln and not re.match(r"^\s+\S+\s+[0-9.]+ s$", ln):
            out.append((it, re.sub(r"[0-9.]+s acc", "acc",
                                   re.sub(r"delta.*Hz|chi2.*  ", "",
                                          ln.strip()))))
    return out


def _pair_err(p_got, p_ref, grids) -> dict:
    """How far chain p_got's sample 1 stands from p_ref's: the alms
    relative to their max (the larger over the components), theta in grid
    steps (the worst pixel and the 99th percentile, the larger over the
    parameters), each band's TOD gains and sigma0 relative to their max,
    the noise-PSD cells that differ, and the 4D maps of iteration 1
    relative to their max (n4d datasets)."""
    import os

    from commander_tpu_torch.io import hdf5
    from commander_tpu_torch.io.chain import ChainFile

    e = dict(alm=0.0, theta_steps=0.0, theta_p99=0.0, gain=0.0, sigma0=0.0,
             psd_cells_differing=0, maps4d=0.0, n4d=0)
    with ChainFile(p_got, "r") as cd, ChainFile(p_ref, "r") as cc:
        sd, sc = cd.read_sample(1), cc.read_sample(1)
        td, tc = cd.read_tod_state(1), cc.read_tod_state(1)
    for c, a in sc["comps"].items():
        b = sd["comps"][c]
        e["alm"] = max(e["alm"], float(np.abs(b["alm"] - a["alm"]).max()
                                       / np.abs(a["alm"]).max()))
        for j in range(len(a["specind"])):
            key = f"theta_map{j}"
            x, y = (b[key], a[key]) if key in a else (
                b["specind"][j], a["specind"][j])
            t = np.abs(np.asarray(x) - np.asarray(y)) / grids[(c, j)][2]
            e["theta_steps"] = max(e["theta_steps"], float(np.max(t)))
            e["theta_p99"] = max(e["theta_p99"],
                                 float(np.percentile(t, 99)))
    for band, st in tc.items():
        e["gain"] = max(e["gain"], relmax(torch.as_tensor(td[band]["gain"]),
                                          torch.as_tensor(st["gain"])))
        e["sigma0"] = max(e["sigma0"], relmax(
            torch.as_tensor(td[band]["sigma0"]),
            torch.as_tensor(st["sigma0"])))
        e["psd_cells_differing"] += int(np.sum(
            (td[band]["alpha"] != st["alpha"])
            | (td[band]["fknee"] != st["fknee"])))
    d_got, d_ref = (os.path.dirname(p) for p in (p_got, p_ref))
    for f in sorted(os.listdir(d_ref)):
        if not (f.startswith("tod_4D_") and f.endswith("k000001.h5")):
            continue
        with hdf5.File(os.path.join(d_got, f), "r") as x, \
                hdf5.File(os.path.join(d_ref, f), "r") as y:
            for det, grp in y.root.members.items():
                for name, ds in grp.members.items():
                    ref = y.read_dataset(ds)
                    got = x.read_dataset(x.root.members[det].members[name])
                    e["maps4d"] = max(e["maps4d"], relmax(
                        torch.as_tensor(got), torch.as_tensor(ref)))
                    e["n4d"] += 1
    return e


def _hold_tod_pair(k, argv, paths) -> dict:
    """A float64 pair (paths: the chains of the card, its CPU twin and
    optionally a witness), card against its CPU twin: each band's TOD gains
    and sigma0 to TOD_PAIR_TOL of their max, iteration 1's bandpass and
    index MH acceptances the same, sample 1's alms to 1e-3 of their max,
    its theta to THETA_STEPS grid steps and the 4D maps to 1e-6 of their
    max. With a witness (the CPU twin with the Legendre stage in the
    kernels' float32 arithmetic, kernel_arithmetic; for the whole model
    from TOD, whose joint CG amplifies that stage's rounding: ROADMAP queue
    3 item 10d) W, the witness's distance from the CPU twin, sets the
    bounds: the card's alms and theta (in the 99th percentile of pixels;
    the worst swing between the posterior's modes) are held to the witness
    to max(1e-3, W / WITNESS_FACTOR) and max(THETA_STEPS, W /
    WITNESS_FACTOR), and its 4D maps (weighted by gain^2 / sigma0^2,
    which read the float32 stage's sky) to the CPU to max(1e-6,
    WITNESS_FACTOR W); _tod_parts_check holds them to 1e-6 on a shared
    sky."""
    import os

    p_card, p_cpu, p_wit = (list(paths) + [None])[:3]
    _, g = _host_indices(argv)
    err = _pair_err(p_card, p_cpu, g)
    holds = [("gain", err["gain"], TOD_PAIR_TOL),
             ("sigma0", err["sigma0"], TOD_PAIR_TOL)]
    wit = card_wit = None
    if p_wit is None:
        holds += [("alm", err["alm"], 1e-3),
                  ("theta_steps", err["theta_steps"], THETA_STEPS),
                  ("maps4d", err["maps4d"], 1e-6)]
    else:
        wit = _pair_err(p_wit, p_cpu, g)
        card_wit = _pair_err(p_card, p_wit, g)
        holds += [("alm against the witness", card_wit["alm"],
                   max(1e-3, wit["alm"] / WITNESS_FACTOR)),
                  ("theta_p99 against the witness", card_wit["theta_p99"],
                   max(THETA_STEPS, wit["theta_p99"] / WITNESS_FACTOR)),
                  ("maps4d", err["maps4d"],
                   max(1e-6, WITNESS_FACTOR * wit["maps4d"]))]
    logs = [open(os.path.join(os.path.dirname(p), "log.txt")).read()
            for p in (p_card, p_cpu)]
    mh = [[x for x in _log_lines(lg, "bandpass") + _log_lines(lg, " acc ")
           if x[0] == 1] for lg in logs]
    err.update(mh_same=mh[0] == mh[1], mh=mh[0], witness=wit,
               card_vs_witness=card_wit,
               holds={n: [v, b] for n, v, b in holds})
    say(f"[6] host_loop_tod pair {k} ({' '.join(argv)}): card and CPU: "
        f"alms {err['alm']:.2e} of their max, theta {err['theta_steps']:.3g}"
        f" grid steps (99th percentile {err['theta_p99']:.3g}), TOD gains "
        f"{err['gain']:.2e}, sigma0 {err['sigma0']:.2e}, 4D maps "
        f"{err['maps4d']:.2e} over {err['n4d']} datasets, noise-PSD cells "
        f"differing {err['psd_cells_differing']}; iteration 1's MH the same "
        f"{mh[0] == mh[1]}: {mh[0]}")
    if wit is not None:
        for tag, e in (("the witness (the CPU with the kernels' float32 "
                        "Legendre stage) and the CPU", wit),
                       ("the card and the witness", card_wit)):
            say(f"[6] host_loop_tod pair {k}: {tag}: alms {e['alm']:.2e}, "
                f"theta {e['theta_steps']:.3g} grid steps (99th percentile "
                f"{e['theta_p99']:.3g}), TOD gains {e['gain']:.2e}, sigma0 "
                f"{e['sigma0']:.2e}, 4D maps {e['maps4d']:.2e}")
    say(f"[6] host_loop_tod pair {k}: held " + ", ".join(
        f"{n} {v:.3g} <= {b:.3g}" for n, v, b in holds))
    if not (mh[0] == mh[1] and all(v <= b for _, v, b in holds)):
        raise AssertionError(f"host_loop_tod: the float64 pair {k} on the "
                             f"card disagrees with --cpu")
    if "--TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER=1" in argv and not err["n4d"]:
        raise AssertionError(f"host_loop_tod: pair {k} wrote no 4D maps")
    return err


def _tod_parts_check(dev) -> dict:
    """The host loop's TOD stage (loop.host_tod_phase) on the card against
    the CPU given the same inputs, in float64 at nside 32 (the rehearsal:
    8) on HOST_TOD_SMALL's first configuration (every band's bandpass
    move, the monopoles with the guard, the 4D maps): the same simulated
    TOD, the same model sky (the truth's, synthesized on the CPU), the same
    draws (a generator on the card, seeded alike), in two stages: at
    scalar theta (the bandpass moves' fast form), then under F_pix from a
    synch beta map (their general form): the noise-PSD cells identical,
    the TOD gains, sigma0, n_corr, monopoles and binned maps to 1e-6 of
    their max,
    the moves' forms and acceptances identical (their chi^2 reported: the
    unit streams and the proposal's sky come from the card's float32
    transforms), the 4D maps of both stages to 1e-6 of their max. Returns
    the errors."""
    import os
    import shutil

    from commander_tpu_torch.driver import loop
    from commander_tpu_torch.driver import specind as hs
    from commander_tpu_torch.driver.model import build_model
    from commander_tpu_torch.io import hdf5
    from commander_tpu_torch.io.params import Params, lower_params
    from commander_tpu_torch.sampling import chisq, tod_gibbs
    from commander_tpu_torch.sampling.gibbs import GibbsState

    on_card = dev.type == "cuda"
    ns, lm = (32, 64) if on_card else (8, 16)
    argv = HOST_TOD_SMALL["a_bp_mono_4d"]
    cfg = lower_params(Params.load(argv[0], [a for a in argv
                                             if a.startswith("--")
                                             and "=" in a]))
    mc = build_model(cfg, nside=ns, lmax=lm, synthetic=True,
                     dtype=torch.float64, pol=True, device="cpu")
    t0 = mc.ts.prior_mean
    p0 = torch.as_tensor(mc.meta["ptsrc_true"], dtype=torch.float64)
    sky = chisq.full_sky(mc.sys, mc.plan, mc.truth, mc.ts, mc.ps, t0, p0)
    beta = -3.1 + 0.2 * np.tanh(np.random.default_rng(6).standard_normal(
        12 * ns * ns))
    got = {}
    for d in (dev, torch.device("cpu")):
        m = mc if d.type == "cpu" else build_model(
            cfg, nside=ns, lmax=lm, synthetic=True, dtype=torch.float64,
            pol=True, device=d)
        m = m._replace(sys=dataclasses.replace(
            m.sys, data=mc.sys.data.to(d), inv_rms=mc.sys.inv_rms.to(d),
            inv_rms2=mc.sys.inv_rms2.to(d)))
        bands = tod_gibbs.simulate_bands(
            ns, mc.meta["sky_true"], mc.sys.inv_rms,
            [b.nominal_freq_ghz * 1e9 for b in cfg.bands], nscan=8,
            ndet=cfg.synth_tod_ndet, ntod=4096,
            sigma0_scale=cfg.synth_tod_sigma0_scale,
            fknee=cfg.synth_tod_fknee, seed=cfg.base_seed, sample_mono=True,
            dtype=torch.float64, device=d, mono_guard=True)
        gen = torch.Generator(dev)
        gen.manual_seed(23)
        st = GibbsState(a=mc.truth.to(d), cl_bins=None, t=t0.to(d),
                        p=p0.to(d))
        out = f"build/host_tod_parts_{d.type}"
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        rec, rec2, bp = {}, {}, np.zeros(len(cfg.bands))
        thetas = [list(c.theta0) for c in m.diffuse]
        bands, sys2 = loop.host_tod_phase(
            cfg, m, m.sys, st, thetas, bands, bp, True, gen, {}, out, 1, rec,
            sky=sky.to(d))
        # a second stage under F_pix (a synch beta map): the moves' general
        # form on the same sky
        thetas[1][0] = torch.as_tensor(beta, device=d)
        sys_fp = hs.rebuild_mixing(m.diffuse, m.bps, thetas, sys2,
                                   deltas=bp.tolist())
        bands, sys2 = loop.host_tod_phase(
            cfg, m, sys_fp, st, thetas, bands, bp, False, gen, {}, out, 2,
            rec2, sky=sky.to(d))
        maps4d = {}
        for f in sorted(os.listdir(out)):
            with hdf5.File(os.path.join(out, f), "r") as h:
                for det, grp in h.root.members.items():
                    for name, ds in grp.members.items():
                        maps4d[(f, det, name)] = torch.as_tensor(
                            h.read_dataset(ds))
        got[d.type] = dict(
            ncorr=[b.state.n_corr.cpu() for b in bands],
            bands=[(b.state, b.mono) for b in bands], data=sys2.data.cpu(),
            inv_rms=sys2.inv_rms.cpu(), bp=list(rec["bp"].values())
            + list(rec2["bp"].values()), maps4d=maps4d, bp_deltas=bp)
    c, g = got["cpu"], got[dev.type]
    err = dict(data=relmax(g["data"], c["data"]),
               inv_rms=relmax(g["inv_rms"], c["inv_rms"]),
               gain=0.0, sigma0=0.0, mono=0.0, cells=0, chi2=0.0)
    for (sg, mg), (sc, mcpu) in zip(g["bands"], c["bands"]):
        err["gain"] = max(err["gain"], relmax(sg.gain.cpu(), sc.gain))
        err["sigma0"] = max(err["sigma0"], relmax(sg.sigma0.cpu(),
                                                  sc.sigma0))
        err["mono"] = max(err["mono"], relmax(mg.cpu(), mcpu))
        err["cells"] += int(torch.sum((sg.alpha.cpu() != sc.alpha)
                                      | (sg.fknee.cpu() != sc.fknee)))
    for r, q in zip(c["bp"], g["bp"]):
        for key in ("chi2_cur", "chi2_prop"):
            err["chi2"] = max(err["chi2"], abs(q[key] - r[key])
                              / abs(r[key]))
    err["bp"] = [(r["form"], r["accepted"]) for r in c["bp"]]
    err["bp_same"] = err["bp"] == [(r["form"], r["accepted"])
                                   for r in g["bp"]]
    err["maps4d"] = max(relmax(g["maps4d"][k], v)
                        for k, v in c["maps4d"].items())
    err["ncorr"] = max(relmax(x, y) for x, y in zip(g["ncorr"], c["ncorr"]))
    err["n4d"] = len(c["maps4d"])
    say(f"[6] host_loop_tod: the TOD stage in float64 at nside {ns}, card "
        f"against the CPU on the same TOD, sky and draws: {err}")
    if not (err["cells"] == 0 and err["bp_same"]
            and [f for f, _ in err["bp"]] == ["fast"] * 3 + ["general"] * 3
            and all(err[k] <= 1e-6 for k in ("data", "inv_rms", "gain",
                                              "sigma0", "ncorr", "mono",
                                              "maps4d"))
            and err["n4d"] == 2 * 3 * 3 * cfg.synth_tod_ndet
            and sorted(g["maps4d"]) == sorted(c["maps4d"])):
        raise AssertionError("host_loop_tod: the TOD stage on the card "
                             "disagrees with the CPU")
    return err


def host_tod_pairs_start(dev) -> dict:
    """Start HOST_TOD_SMALL's pairs as processes (_small_start; the
    WITNESS_PAIRS with their witness), at nside 8 in the CPU rehearsal.
    main starts them before the driver phase, so that their CPU twins run
    beside the card-bound driver and host_loop phases. Returns {"smalls":
    the commands, "procs": the processes by pair, "t0": the start}."""
    import shutil

    on_card = dev.type == "cuda"
    smalls = {k: list(v) for k, v in HOST_TOD_SMALL.items()}
    if not on_card:
        for k, v in smalls.items():
            smalls[k] = [{"--nside": "8", "--lmax": "16"}.get(
                v[i - 1], a.replace("16384", "2048"))
                for i, a in enumerate(v)]
    out = dict(smalls=smalls, procs={}, t0=time.perf_counter())
    try:
        for k, a in smalls.items():
            d = f"build/host_tod_small_{k}"
            shutil.rmtree(d, ignore_errors=True)
            out["procs"][k] = _small_start(a, on_card, d,
                                           witness=k in WITNESS_PAIRS)
    except BaseException:
        _stop_pairs(out)
        raise
    return out


def _stop_pairs(pairs):
    """Kill the pairs' processes that still run."""
    for p, _ in (x for v in pairs["procs"].values() for x in v):
        if p.poll() is None:
            p.kill()
            p.communicate()


def host_loop_tod_phase(dev, pairs=None, p5=None):
    """Phase 6, run()'s host loop from TOD through the program: HOST_TOD_ARGV
    (the reference tutorial's TOD setting at nside 1024 / lmax 2000 in
    float64: the whole model with its md, radio and relquad rows, synch
    beta an alm field to l = 100, every band's bandpass sampled on the TOD
    chi^2, the TOD monopoles) through run.main in this process, under
    HOST_TOD_RUN_S; the build, the TOD simulation, the warm start (its CG
    iterations), the burn-in, the output; per attempt s/step split into the
    TOD stage, the bandpass moves, the CG and the index phase, CG iterations
    and relres, per band the bandpass proposal, the two chi^2 and whether it
    was taken; the monopoles (finite, zero-sum) and the hit pixels seen at
    fewer than three angles; peak memory; held to a finite state, an
    accepted sample at relres <= tol, a chain with bp_delta and each band's
    TOD state with its monopoles, the launch counts of the build, the warm
    start and each attempt exactly (_hold_host_tod_launches). Beside it the
    HOST_TOD_SMALL pairs at nside 64, card against its CPU twin
    (_hold_tod_pair), started here or before by host_tod_pairs_start
    (pairs). Returns (launches, attempts, measured)."""
    import os
    import shutil

    from commander_tpu_torch import run as trun
    from commander_tpu_torch.io.chain import ChainFile
    from commander_tpu_torch.sphere import cuda_sht

    on_card = dev.type == "cuda"
    argv = list(HOST_TOD_ARGV)
    if not on_card:
        argv += ["--cpu", "--nside", "16", "--lmax", "32",
                 "--SYNTH_TOD_NSCAN=6", "--SYNTH_TOD_NTOD=2048"]
    out = argv[argv.index("--outdir") + 1]
    shutil.rmtree(out, ignore_errors=True)
    cfg, grids = _host_indices(argv)
    if pairs is None:
        pairs = host_tod_pairs_start(dev)
    smalls, procs, t_small = pairs["smalls"], pairs["procs"], pairs["t0"]
    try:

        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for k in cuda_sht.LAUNCHES:
            cuda_sht.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        with _host_tod_probe(HOST_TOD_RUN_S) as parts:
            (res,) = trun.main(argv)
        secs = time.perf_counter() - t0
        launches = dict(cuda_sht.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if on_card else float("nan")
        tm = res.timer.acc
        w = res.warm
        say(f"[6] host_loop_tod: {' '.join(argv)}")
        warm_s = parts["cg_s"][0]
        say(f"[6] host_loop_tod: build {tm.get('init', 0):.1f} s, TOD "
            f"simulation {tm.get('tod_sim', 0):.1f} s, warm start "
            f"{warm_s:.1f} s (CG iters {w['cg_iters']}, relres "
            f"{w['cg_relres']:.2e}), burn-in "
            f"{tm.get('tod_burnin', 0) - warm_s:.1f} s ({w['npasses']} "
            f"passes), "
            f"output {tm.get('output', 0):.1f} s; launches: build "
            f"{parts['build']}, warm start {parts['warm']}")
        steps = []
        for i, (r, d) in enumerate(zip(res.records, parts["attempts"])):
            cg_s = parts["cg_s"][i + 1]
            idx_s = sum(v["seconds"] for v in r["specind"].values())
            steps.append(dict(
                it=r["it"], attempt=r["attempt"], ok=r["ok"],
                seconds=r["seconds"], tod_s=r["tod_seconds"] - r[
                    "bp_seconds"], bandpass_s=r["bp_seconds"], cg_s=cg_s,
                index_s=idx_s, cg_iters=r["cg_iters"],
                cg_relres=r["cg_relres"], chisq=r["chisq"],
                bp={cfg.bands[b].label: v for b, v in r["bp"].items()}))
            say(f"[6] host_loop_tod iteration {r['it']} attempt "
                f"{r['attempt']}: {'accepted' if r['ok'] else 'REJECTED'}, "
                f"{r['seconds']:.2f} s/step: TOD stage "
                f"{steps[-1]['tod_s']:.2f} s, bandpass moves "
                f"{r['bp_seconds']:.2f} s, CG (gibbs_step) {cg_s:.2f} s, "
                f"index phase {idx_s:.2f} s; CG iters {r['cg_iters']}, "
                f"relres {r['cg_relres']:.2e}, chi2 {r['chisq']:.6g}; "
                f"launches {d}")
            for b, v in r["bp"].items():
                say(f"[6] host_loop_tod   band {cfg.bands[b].label}: "
                    f"{v['form']} form, delta {v['delta']:.6g} Hz, proposal "
                    f"{v['prop']:.6g} Hz, TOD chi2 {v['chi2_cur']:.10g} -> "
                    f"{v['chi2_prop']:.10g}, "
                    f"{'accepted' if v['accepted'] else 'rejected'}")
        mono = {}
        for b, band in enumerate(res.bands):
            m = band.mono.detach().cpu().double()
            cov = _psi_coverage(band)
            usable = res.records[-1]["mono_ok"][b]
            mono[cfg.bands[b].label] = dict(
                values=m.tolist(), usable=usable,
                finite=bool(torch.isfinite(m).all()), sum=float(m.sum()),
                **cov)
            say(f"[6] host_loop_tod   band {cfg.bands[b].label}: "
                + (f"monopoles {[f'{x:.6g}' for x in m.tolist()]} uK: "
                   f"finite {mono[cfg.bands[b].label]['finite']}, sum "
                   f"{float(m.sum()):.3g}" if usable else
                   f"the monopole draw DISCARDED (not finite: the "
                   f"unguarded solve of singular Stokes blocks, ROADMAP "
                   f"queue 3 item 4a), the burn-in's monopoles "
                   f"{[f'{x:.6g}' for x in m.tolist()]} uK kept")
                + f"; hit pixels {cov['hit']}, seen at fewer than three "
                f"angles {cov['fewer_than_3_psi']} "
                f"({100 * cov['share']:.1f}%)")
        say(f"[6] host_loop_tod: run {secs:.1f} s; peak device memory "
            f"{peak:.2f} GiB; launches {launches}")
        st = res.state
        fin = bool(torch.isfinite(torch.view_as_real(st.a)).all()
                   and torch.isfinite(st.t).all()
                   and torch.isfinite(st.p).all()
                   and all(v["finite"] and abs(v["sum"]) <= 1e-6 * max(
                       1.0, max(abs(x) for x in v["values"]))
                       for v in mono.values() if v["usable"]))
        bad = [r for r in res.records if r["ok"] and not r.get("forced")
               and not r["cg_relres"] <= cfg.cg_tol]
        accepted = [r["it"] for r in res.records if r["ok"]]
        with ChainFile(res.chain_path, "r") as ch:
            last = ch.read_sample(ch.last_sample())
            tod = ch.read_tod_state(ch.last_sample())
        bp_out = last["aux"]["bp_delta"]
        with_mono = sorted(b for b, v in tod.items() if "mono" in v
                           and "bp_delta" in v)
        say(f"[6] host_loop_tod: state and the usable monopole draws "
            f"finite and zero-sum {fin}, draws usable in "
            f"{sum(v['usable'] for v in mono.values())} of {len(mono)} "
            f"bands; "
            f"accepted iterations {accepted}; the chain's bp_delta "
            f"{bp_out.tolist()}, TOD states with mono and bp_delta "
            f"{with_mono}")
        if not fin or bad or accepted != [1] or len(with_mono) != 3 \
                or not np.allclose(bp_out, res.bp_deltas):
            raise AssertionError("host_loop_tod: the full-width run does not"
                                 " hold")
        if not all(v["form"] == "fast" for v in res.records[0]["bp"].values()):
            raise AssertionError("host_loop_tod: attempt 1 (scalar theta) "
                                 "did not take the bandpass move's fast "
                                 "form")
        if on_card:
            _hold_host_tod_launches(res, launches, parts, 3, cfg)
        timers = dict(res.timer.acc)
        parts_err = _tod_parts_check(dev)
        diff_err = _diff_parts_check(dev, p5)
        del res, st
        if on_card:
            torch.cuda.empty_cache()
    finally:
        small_paths = {}
        try:
            for k, p in procs.items():
                small_paths[k] = _small_wait(p, f"host_loop_tod small {k}")
        finally:
            _stop_pairs(pairs)
    secs_small = time.perf_counter() - t_small
    held = {k: _hold_tod_pair(k, smalls[k], small_paths[k])
            for k in smalls}
    say(f"[6] host_loop_tod: the pairs in {secs_small:.1f} s after their "
        f"start (processes beside the full-width run and the phases before "
        f"it)")
    measured = dict(run_s=secs, peak_gib=peak, small_s=secs_small,
                    pairs=held, parts=parts_err, diff_pass=diff_err,
                    steps=steps, mono=mono,
                    timers=timers,
                    warm=w, launches_by_part={
                        k: parts[k] for k in ("build", "warm", "tod",
                                              "attempts")})
    return launches, len(steps), measured


def _phases_3_to_5(dev, p5):
    """Phases 3 (the kernels), 4 (the spin-2 transform) and 5 (the entry
    problems against the worker's CPU references). Returns phase 3's
    rows."""
    from commander_tpu_torch.sampling.amplitude import LOWL_CHUNK, lowl_grid

    on_card = dev.type == "cuda"
    big = (1024, 2000) if on_card else (32, 64)
    small = (256, 512) if on_card else (16, 32)
    # the low-ell block's degraded plans, a column chunk of B x S entries
    # (the rehearsal: a batch of 6)
    # tutorial_multires' nside-512 group: two bands, so mp 0 at batch 2 and
    # mp -2, +2 at batch 4
    mid = (512, 1000) if on_card else (16, 32)
    lowl_batch = LOWL_CHUNK * 3 * 3 if on_card else 6
    # (the library call at nside 1024 is timed at mp 0 batch 3 and mp -2,
    # +2 batch 6, the shapes every path and every polarized path gives the
    # kernels; the other shapes' with torch_tools/kernel_shapes.py)
    sizes = [small + ((0, 2, -2), 3), small + ((-2, 2), 6, False, True),
             big + ((0,), 3), big + ((-2, 2), 6, True, True),
             big + ((0,), 1, True), big + ((0,), 6, True),
             big + ((-2, 2), 2, True),
             mid + ((0,), 2, False, True), mid + ((-2, 2), 4, False, True),
             big + ((0,), 5, True), big + ((-2, 2), 10, True)]
    sizes += [lowl_grid(L, 2001) + ((0, 2, -2), lowl_batch)
              for L in LOWL_LMAX]
    prebuilt = prebuild_tables(dev)
    rows = kernel_phase(dev, sizes)
    table_phase(dev, prebuilt)

    done(3)

    # [4] the spin-2 transform composed from the kernels
    spin2_phase(dev, *small)
    spin2_phase(dev, *big)

    done(4)

    # [5] the entry problems against the CPU float64 step
    size = (64, 128) if on_card else (16, 32)
    for preset in ("entry", "entry_pol"):
        entry_phase(dev, p5, preset, *size)
    entry_full_phase(dev, p5, *size)
    entry_tod_phase(dev, p5, *size)
    entry_tod_phase(dev, p5, *size, preset="entry_joint")
    # the multi-resolution step (the rehearsal: nside 8 and 16)
    entry_multires_phase(dev, p5)
    say(f"[5] the CPU float64 references (a worker process beside phases "
        f"3-5, {PHASE5_THREADS} threads; its card inputs saved "
        f"{p5['t0'] - T_START:.0f} s after the start): " + "; ".join(_p5_log().strip().splitlines()))

    done(5)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase at small shapes on the CPU, "
                         "through the plain versions (never reports a gpu)")
    args = ap.parse_args(argv)

    if args.cpu_rehearsal:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; nothing was run",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda")

    import commander_tpu_torch  # noqa: F401  (fails outside the repo)
    from commander_tpu_torch.sphere import cuda_sht

    # [1] the card
    card = card_line() if dev.type == "cuda" else "cpu rehearsal"
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    say(f"[1] {card}; cuda device count {count}; torch {torch.__version__}")

    # [2] build
    if dev.type == "cuda":
        info = cuda_sht.build()
        say(f"[2] kernels built in {info['seconds']:.1f} s")
        for ln in info["ptxas"]:
            say("[2]   " + ln.strip())
        spilled = [ln.strip() for ln in info["ptxas"] if any(
            int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        if spilled:
            raise AssertionError(f"the kernels must build free of register "
                                 f"spills; ptxas said: {spilled}")

    # phase 5's problems on the card, and its CPU float64 references in a
    # worker process beside phases 3 and 4
    on_card = dev.type == "cuda"
    p5 = phase5_start(dev)
    try:
        return _phases_3_to_7(dev, p5, card, count)
    finally:
        phase5_stop(p5)


def _phases_3_to_7(dev, p5, card, count) -> int:
    """Phases 3 to 7 (main's docstring), the reference worker started."""
    from commander_tpu_torch import entry

    on_card = dev.type == "cuda"
    rows = _phases_3_to_5(dev, p5)
    big = (1024, 2000) if on_card else (32, 64)

    # [6] the main paths: the amplitude + C_l step, then the whole iteration
    over = {} if on_card else dict(nside=big[0], lmax=big[1])
    paths = {"tutorial": 2, "tutorial_pol": 2, "tutorial_full": 3,
             "fullgibbs": 2, "tutorial_tod": TOD_DIAG_STEPS,
             "tutorial_joint": JOINT_STEPS,
             "tutorial_multires": MULTIRES_STEPS, "multires_tod": 0,
             "driver": 0, "driver_wmap": 0, "host_loop": 0,
             "host_loop_tod": 0}
    launches, measured = {}, {}
    tod_pairs = None
    try:
        for preset, steps in list(paths.items()):
            if preset == "driver":
                # the host_loop_tod pairs' CPU twins run beside the
                # card-bound driver and host_loop phases
                tod_pairs = host_tod_pairs_start(dev)
                launches[preset], paths[preset], measured[preset] = \
                    driver_phase(dev)
            elif preset == "driver_wmap":
                launches[preset], paths[preset], measured[preset] = \
                    driver_wmap_phase(dev)
            elif preset == "multires_tod":
                launches[preset], paths[preset], measured[preset] = \
                    multires_tod_phase(dev)
            elif preset == "host_loop":
                launches[preset], paths[preset], measured[preset] = \
                    host_loop_phase(dev)
            elif preset == "host_loop_tod":
                launches[preset], paths[preset], measured[preset] = \
                    host_loop_tod_phase(dev, tod_pairs, p5)
            elif preset == "tutorial_multires":
                launches[preset], measured[preset] = multires_path_phase(
                    dev, preset, steps, **({} if on_card else dict(
                        nsides=(16, 16, 32), lmaxs=(32, 32, 64))))
            elif preset == "tutorial_joint":
                opt = dict(tod=dict(entry.PRESETS[preset]["tod"],
                                    nscan=PRESET_TOD_NSCAN)) if on_card \
                    else dict(over, cg_maxiter=20, tod=dict(
                        entry.PRESETS[preset]["tod"], nscan=6, ntod=2048))
                launches[preset], measured[preset] = joint_path_phase(
                    dev, preset, steps, **opt)
            elif preset == "tutorial_tod":
                # the rehearsal: fewer scans and samples, and a CG cut short
                opt = dict(tod=dict(entry.PRESETS[preset]["tod"],
                                    nscan=PRESET_TOD_NSCAN)) if on_card \
                    else dict(over, cg_maxiter=20, tod=dict(
                        entry.PRESETS[preset]["tod"], nscan=6, ntod=2048))
                by_path, measured[preset] = tod_path_phase(
                    dev, preset, steps, p5, **opt)
                launches.update(by_path)
                # the further preconditioners' paths: one step each
                paths.update({p: 1 for p in by_path if p != preset})
            elif preset in ("tutorial_full", "fullgibbs"):
                launches[preset], measured[preset] = full_path_phase(
                    dev, preset, steps, **over)
            else:
                launches[preset], measured[preset] = main_path_phase(
                    dev, preset, steps, 20 if on_card else 5, **over)
            done(f"6 {preset}")
    finally:
        if tod_pairs is not None:
            _stop_pairs(tod_pairs)
    say("[6] " + json.dumps({"main_paths": measured}))
    done(6)

    say(f"[7] smoke wall time {time.perf_counter() - T_START:.0f} s")
    # [7] results: each kernel at the shape every path gives it (mp 0, batch
    # 3), its other shapes under by_shape, its launches summed over the
    # main paths and per path
    src = {"synth": ("legendre_synth",
                     "commander_tpu_torch/csrc/legendre_synth.cu",
                     "commander_tpu/sphere/pallas_sht.py:544"),
           "adjoint": ("legendre_adjoint",
                       "commander_tpu_torch/csrc/legendre_adjoint.cu",
                       "commander_tpu/sphere/pallas_sht.py:683")}
    kernels = []
    for k in ("synth", "adjoint"):
        by_path = {preset: launches[preset][k] for preset in paths}
        kernels.append(dict(
            name=src[k][0], route="cuda", source=src[k][1],
            replaces=src[k][2], launches=sum(by_path.values()),
            launches_by_path=by_path,
            launches_per_step={p: (sum(
                a[k] for a in measured[p]["launches_by_part"][0]
                ["attempts"]) if p == "driver" else sum(
                a[k] for a in measured[p]["launches_by_part"]["attempts"])
                if p in ("host_loop", "host_loop_tod", "driver_wmap",
                         "multires_tod") else by_path[p])
                / paths[p]
                for p in paths},
            **rows[(big[0], 0, 3)][k],
            by_shape=[r[k] for r in rows.values()]))
    if on_card and min(n for k in kernels
                       for n in k["launches_by_path"].values()) < 1:
        raise AssertionError("a kernel of a main path never launched")
    say(json.dumps({"kernels": kernels}))
    say(card)
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    platform = "gpu" if dev.type == "cuda" else "cpu"
    print(json.dumps({"ok": True, "device": {"platform": platform,
                                             "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
