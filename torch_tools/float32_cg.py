"""Why the whole model's amplitude CG fails in float32 at full width,
measured on the CPU.

    python3 torch_tools/float32_cg.py [--nside 8] [--lmax 16] \
        [--scale 128] [--maxiter 100]

param_tutorial_full.txt's whole model (five components on three bands,
T/Q/U) at a small nside, its noise rms divided by --scale: 128 gives each
mode at nside 8 the signal-to-noise of nside 1024 at the file's rms
(12 * 1024^2 / 768 = 128^2 times the pixels). One amplitude draw
(amplitude.sample_amplitudes, tol 1e-6, the same numpy draws) in:

  f64            float64;
  f32            float32;
  f32_precond64  float32, the diagonal preconditioner applied in float64;
  f32_mix64      that, and the band projection (F and its transpose) in
                 float64 too;
  f64_route      float64 with every Legendre synthesis and adjoint rounded
                 to complex64 at its input and output, as the card's
                 float64 route rounds them (torch_tools/host_loop_rounding).

Per variant: CG iterations, relres and the largest difference of the
amplitudes from f64's, relative to each component's max. Prints one JSON
object.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _wide(x):
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


@contextlib.contextmanager
def _variant(name):
    """The module patches of one variant, undone on exit."""
    from commander_tpu_torch.sampling import amplitude as amp
    from commander_tpu_torch.sphere import cuda_sht

    from host_loop_rounding import _rounded

    saved = {k: getattr(amp, k) for k in
             ("build_preconditioner", "_project_bands", "_project_bands_T")}
    plain = (cuda_sht.synth_legendre_plain, cuda_sht.adjoint_legendre_plain)
    if name in ("f32_precond64", "f32_mix64"):
        def precond(sys, plan):
            apply = saved["build_preconditioner"](
                dataclasses.replace(sys, bl=sys.bl.double()), plan)
            return lambda r: apply(_wide(r)).to(r.dtype)
        amp.PRECONDS["diagonal"] = precond
    if name == "f32_mix64":
        def proj(sys, plan, a):
            out = torch.einsum("bcs,...cslm->...bslm", sys.F.double().to(
                _wide(a).dtype), _wide(a)) * sys.bl.double()[..., None]
            return out.to(a.dtype)

        def proj_T(sys, plan, alm_b):
            w = _wide(alm_b) * sys.bl.double()[..., None]
            return torch.einsum("bcs,...bslm->...cslm", sys.F.double().to(
                w.dtype), w).to(alm_b.dtype)
        amp._project_bands, amp._project_bands_T = proj, proj_T
    if name == "f64_route":
        cuda_sht.synth_legendre_plain = _rounded(plain[0])
        cuda_sht.adjoint_legendre_plain = _rounded(plain[1])
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(amp, k, v)
        amp.PRECONDS["diagonal"] = saved["build_preconditioner"]
        (cuda_sht.synth_legendre_plain,
         cuda_sht.adjoint_legendre_plain) = plain


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nside", type=int, default=8)
    ap.add_argument("--lmax", type=int, default=16)
    ap.add_argument("--scale", type=float, default=128.0)
    ap.add_argument("--maxiter", type=int, default=100)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(__file__))
    from commander_tpu_torch.driver.model import build_model
    from commander_tpu_torch.io.params import Params, lower_params
    from commander_tpu_torch.sampling import amplitude as amp
    from commander_tpu_torch.sphere import sht

    cfg = lower_params(Params.load("param_tutorial_full.txt", []))
    m = build_model(cfg, nside=args.nside, lmax=args.lmax, synthetic=True,
                    dtype=torch.float64, pol=True, device="cpu")
    s64 = dataclasses.replace(m.sys, inv_rms2=m.sys.inv_rms2 * args.scale ** 2,
                              inv_rms=m.sys.inv_rms * args.scale)
    s32 = dataclasses.replace(s64, **{
        f.name: getattr(s64, f.name).float()
        for f in dataclasses.fields(s64)
        if isinstance(getattr(s64, f.name), torch.Tensor)
        and getattr(s64, f.name).dtype == torch.float64})
    C, S, nl = s64.F.shape[1], s64.bl.shape[1], args.lmax + 1
    rng = np.random.default_rng(5)
    eta1 = torch.as_tensor(rng.standard_normal(tuple(s64.data.shape)))
    eta2 = (rng.standard_normal((C, S, nl, nl))
            + 1j * rng.standard_normal((C, S, nl, nl))) * np.tril(
                np.ones((nl, nl)))
    eta2[..., 0] = eta2[..., 0].real
    eta2 = torch.as_tensor(eta2)
    out, ref = {}, None
    for name in ("f64", "f32", "f32_precond64", "f32_mix64", "f64_route"):
        s = s32 if name.startswith("f32") else s64
        dt = s.data.dtype
        plan = sht.get_plan(args.nside, args.lmax, spin2=S == 3, dtype=dt,
                            device="cpu")
        cdt = torch.complex64 if dt == torch.float32 else torch.complex128
        with _variant(name):
            x, res = amp.sample_amplitudes(
                s, plan, eta1=eta1.to(dt), eta2=eta2.to(cdt), tol=1e-6,
                maxiter=args.maxiter)
        x = x.to(torch.complex128)
        ref = x if ref is None else ref
        diff = max(float((x[c] - ref[c]).abs().max() / ref[c].abs().max())
                   for c in range(C))
        out[name] = dict(iters=res.iters, relres=res.rel_res,
                         amp_diff_of_comp_max=diff)
        print(f"[float32_cg] {name}: {out[name]}", flush=True)
    print(json.dumps(dict(nside=args.nside, lmax=args.lmax, scale=args.scale,
                          runs=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
