"""Hand-written CUDA kernels for the on-the-fly Legendre stage, and their
plain torch versions.

Counterpart of commander_tpu.sphere.pallas_sht. Two functions, for spin
weight mp in {0, +2, -2}, with lamhat = sqrt((2l+1)/4pi) d^l_{m,mp}(theta_r)
on the nh = 2 nside northern rings:

  synthesis  F_n(r,m) = sum_l lamhat_lm(r) a_lm,
             F_s(r,m) = sum_l (-1)^(l+m) lamhat_lm(r) a_lm;
  adjoint    a_lm = sum_r lamhat_lm(r) [G_n(r,m) + (-1)^(l+m) G_s(r,m)].

synth_legendre / adjoint_legendre dispatch on the tensor's device: a CUDA
tensor goes to the kernel (csrc/legendre_synth.cu, csrc/legendre_adjoint.cu)
or raises; a CPU tensor goes to the plain version, the chunked torch
recurrence of sht_otf. Each wrapper counts its kernel launches in LAUNCHES.

The kernels are compiled with nvcc at first use into
build/commander_tpu_torch/ beside the package and bound through ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from . import healpix
from .sht_otf import (LegendreOTF, _rec_coeffs, _seed_log, _split_seed,
                      adjoint_legendre_chunked, ell_norm,
                      synth_legendre_chunked)

# kernel launches made by the wrappers on CUDA tensors (one per wrapper call)
LAUNCHES = {"synth": 0, "adjoint": 0}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build",
    "commander_tpu_torch")
_SOURCES = ("legendre_common.cuh", "legendre_synth.cu", "legendre_adjoint.cu")
# what the last build reported: seconds, and nvcc's -Xptxas -v lines
BUILD_INFO: dict = {}


@functools.lru_cache(maxsize=None)
def _coeff_pack_f64(nside: int, lmax: int, mp: int, mmax: int):
    """Host recurrence coefficients with the per-l norm sqrt((2l+1)/4pi)
    folded in: lamhat_l = n_l d^l_{m,mp} obeys
      lamhat_{l+1} = (Ahat_l x + Bhat_l) lamhat_l - betahat_l lamhat_{l-1}
    with Ahat = A n_{l+1}/n_l, betahat = beta n_{l+1}/n_{l-1}, and seeds
    premultiplied by n_{l0(m)}. Returns float64 seeds (nh, nm), int32 seed
    exponents (nh, nm), A/B/beta (nl, nm) and x (nh,), unpadded."""
    logv, sign = _seed_log(nside, mp, mmax)
    l0 = np.maximum(np.arange(mmax + 1), abs(mp))[None, :]
    seed_mant, seed_exp = _split_seed(
        logv + 0.5 * np.log((2 * l0 + 1) / (4 * np.pi)), sign)
    A, Bc, beta = _rec_coeffs(lmax, mp, mmax)
    ell = np.arange(lmax + 1, dtype=np.float64)[:, None]
    r_up = ell_norm(ell + 1) / ell_norm(ell)                   # n_{l+1}/n_l
    r_skip = ell_norm(ell + 1) / ell_norm(np.maximum(ell - 1, 0))
    return (seed_mant, seed_exp, A * r_up, Bc * r_up, beta * r_skip,
            healpix.ring_geometry(nside).z[: 2 * nside])


@functools.lru_cache(maxsize=None)
def _coeff_pack(nside: int, lmax: int, mp: int, mmax: int):
    """The kernels' pack: _coeff_pack_f64 with the floats rounded to
    float32 (int32 exponents unchanged)."""
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    sm, se, A, Bc, beta, x = _coeff_pack_f64(nside, lmax, mp, mmax)
    return f32(sm), se, f32(A), f32(Bc), f32(beta), f32(x)


def _device_pack(otf: LegendreOTF, device: torch.device):
    """The coefficient pack on `device`, copied there once and kept on the
    LegendreOTF object (at lmax 2000 it is ~48 MB of A/B/beta plus ~33 MB
    of seeds: a host-to-device copy per transform would dominate)."""
    cache = otf.__dict__.setdefault("_packs", {})
    key = str(device)
    if key not in cache:
        host = _coeff_pack(otf.nside, otf.lmax, otf.mp, otf.mmax)
        cache[key] = tuple(torch.as_tensor(a, device=device) for a in host)
    return cache[key]


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA Legendre kernels cannot be "
                       "built on this machine")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Compile csrc/*.cu for sm_90a (once per source hash) and load them."""
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so = os.path.join(_BUILD_DIR, f"liblegendre_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"   # concurrent builds never collide
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp,
               os.path.join(_CSRC, "legendre_synth.cu"),
               os.path.join(_CSRC, "legendre_adjoint.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        BUILD_INFO["ptxas"] = [ln for ln in (proc.stdout + proc.stderr)
                               .splitlines()
                               if "registers" in ln or "spill" in ln]
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
        os.replace(tmp, so)
    else:
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("ptxas", [])
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.legendre_synth.argtypes = [p, p, p, p, p, p, p, p, p,
                                   i, i, i, i, i, p]
    lib.legendre_synth.restype = i
    lib.legendre_adjoint.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                     i, i, i, i, i, i, p]
    lib.legendre_adjoint.restype = i
    return lib


def build() -> dict:
    """Build (if needed) and load the kernels; returns BUILD_INFO."""
    _lib()
    return BUILD_INFO


def _check(name: str, t: torch.Tensor, shape: tuple):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.complex64:
        raise TypeError(f"{name}: expected complex64, got {t.dtype}")
    if tuple(t.shape[-2:]) != shape:
        raise ValueError(f"{name}: trailing shape {tuple(t.shape[-2:])} "
                         f"!= {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# Plain versions (the chunked torch recurrence) and the dispatching wrappers
# ---------------------------------------------------------------------------

def pack_otf(otf: LegendreOTF) -> LegendreOTF:
    """The recurrence of `otf` re-expressed on the kernels' coefficient pack
    (norm folded into seeds and A/B/beta, norm = 1), in otf's dtype and on
    its device; cached on otf.

    In float32 the plain version then runs the kernels' recurrence with the
    same inputs and the same single-rounded operations (the kernels use
    __fmul_rn/__fsub_rn, never a contracted FMA, on the recurrence), so
    both emit the same lamhat bits and differ only in the order of the
    final sums. That matters: near the poles the three-term recurrence is
    marginally stable (both characteristic roots near 1), and any change of
    rounding inside it grows like eps * l^1.5 (~3e-3 at l = 2000)."""
    dt = otf.seed_mant.dtype
    cache = otf.__dict__.setdefault("_pack_otfs", {})
    key = (str(otf.seed_mant.device), str(dt))
    if key not in cache:
        host = (_coeff_pack if dt == torch.float32 else _coeff_pack_f64)(
            otf.nside, otf.lmax, otf.mp, otf.mmax)
        sm, se, A, Bc, beta, x = (torch.as_tensor(a, device=otf.x.device)
                                  for a in host)
        cache[key] = LegendreOTF(
            seed_mant=sm.to(dt), seed_exp=se, A=A.to(dt), Bc=Bc.to(dt),
            beta=beta.to(dt), x=x.to(dt), norm=torch.ones_like(otf.norm),
            parity_m=otf.parity_m, m_vals=otf.m_vals, nside=otf.nside,
            lmax=otf.lmax, mmax=otf.mmax, mp=otf.mp, chunk=otf.chunk)
    return cache[key]


def synth_legendre_plain(otf: LegendreOTF, alm: torch.Tensor, nh: int):
    """Plain torch synthesis: the chunked recurrence on the kernels' pack,
    in otf's dtype, on any device."""
    return synth_legendre_chunked(pack_otf(otf), alm, nh)


def adjoint_legendre_plain(otf: LegendreOTF, F_n: torch.Tensor,
                           F_s: torch.Tensor) -> torch.Tensor:
    """Plain torch adjoint: the chunked recurrence on the kernels' pack."""
    return adjoint_legendre_chunked(pack_otf(otf), F_n, F_s)


def synth_legendre(otf: LegendreOTF, alm: torch.Tensor, nh: int):
    """alm (..., nl, nm) complex -> (F_n, F_s) (..., nh, nm).

    CUDA tensor: complex64 in and out, through legendre_synth.cu. CPU
    tensor: the plain version."""
    if alm.device.type == "cpu":
        return synth_legendre_plain(otf, alm, nh)
    nl, nm = otf.lmax + 1, otf.mmax + 1
    _check("alm", alm, (nl, nm))
    if nh != 2 * otf.nside:
        raise ValueError(f"nh {nh} != 2*nside {2 * otf.nside}")
    lib = _lib()
    seeds, seede, A, B, beta, x = _device_pack(otf, alm.device)
    batch = alm.shape[:-2]
    nb = int(np.prod(batch, dtype=np.int64))
    Fn = torch.empty(batch + (nh, nm), dtype=torch.complex64,
                     device=alm.device)
    Fs = torch.empty_like(Fn)
    stream = torch.cuda.current_stream(alm.device).cuda_stream
    rc = lib.legendre_synth(seeds.data_ptr(), seede.data_ptr(),
                            A.data_ptr(), B.data_ptr(), beta.data_ptr(),
                            x.data_ptr(), alm.data_ptr(), Fn.data_ptr(),
                            Fs.data_ptr(), nb, nh, nl, nm, otf.mp, stream)
    _raise_on(rc, "legendre_synth")
    LAUNCHES["synth"] += 1
    return Fn, Fs


def adjoint_slices(nh: int) -> int:
    """Ring slices of the adjoint kernel: each slice's blocks sum their
    ring chunks into their own partial output, and a second pass adds the
    slices in a fixed order (no float atomics, so the result is the same
    bits on every run)."""
    nchunks = -(-nh // 32)
    return max(1, min(nchunks, 16))


def adjoint_legendre(otf: LegendreOTF, F_n: torch.Tensor,
                     F_s: torch.Tensor) -> torch.Tensor:
    """(F_n, F_s) (..., nh, nm) complex -> alm (..., nl, nm).

    CUDA tensors: complex64, through legendre_adjoint.cu. CPU tensors: the
    plain version."""
    if F_n.device.type == "cpu" and F_s.device.type == "cpu":
        return adjoint_legendre_plain(otf, F_n, F_s)
    nl, nm = otf.lmax + 1, otf.mmax + 1
    nh = 2 * otf.nside
    _check("F_n", F_n, (nh, nm))
    _check("F_s", F_s, (nh, nm))
    if F_n.shape != F_s.shape or F_n.device != F_s.device:
        raise ValueError("F_n and F_s differ in shape or device")
    lib = _lib()
    seeds, seede, A, B, beta, x = _device_pack(otf, F_n.device)
    batch = F_n.shape[:-2]
    nb = int(np.prod(batch, dtype=np.int64))
    nslice = adjoint_slices(nh)
    nbg = min(nb, 4)                 # the kernel's batch group
    part = torch.empty((nslice, nbg, nl, nm), dtype=torch.complex64,
                       device=F_n.device)
    out = torch.empty(batch + (nl, nm), dtype=torch.complex64,
                      device=F_n.device)
    stream = torch.cuda.current_stream(F_n.device).cuda_stream
    rc = lib.legendre_adjoint(seeds.data_ptr(), seede.data_ptr(),
                              A.data_ptr(), B.data_ptr(), beta.data_ptr(),
                              x.data_ptr(), F_n.data_ptr(), F_s.data_ptr(),
                              part.data_ptr(), out.data_ptr(),
                              nb, nh, nl, nm, otf.mp, nslice, stream)
    _raise_on(rc, "legendre_adjoint")
    LAUNCHES["adjoint"] += 1
    return out
