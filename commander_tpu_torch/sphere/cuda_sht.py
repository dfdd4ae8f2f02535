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

The kernels are compiled with nvcc at first use (one nvcc per source, both
at once) into build/commander_tpu_torch/ beside the package and bound
through ctypes.
"""
from __future__ import annotations

import ctypes
import dataclasses
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

# wrapper calls that launched their kernel on CUDA tensors (one per call,
# however many batch groups the call was cut into)
LAUNCHES = {"synth": 0, "adjoint": 0}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build",
    "commander_tpu_torch")
_HEADERS = ("legendre_common.cuh",)
_KERNEL_SOURCES = ("legendre_synth.cu", "legendre_adjoint.cu")
# what the last build reported: seconds, and nvcc's -Xptxas -v lines
BUILD_INFO: dict = {}

# the kernels' constants (csrc/legendre_common.cuh; a CPU test holds these
# to the constexpr values parsed from the sources)
MAX_NB = 4              # batch entries per kernel launch
RINGS_PER_THREAD = 4    # neighbouring rings of one thread (R)
WARPS_PER_BLOCK = 8     # warps of one block, each on further rings (TY)
RINGS_PER_BLOCK = RINGS_PER_THREAD * WARPS_PER_BLOCK
MAX_CLUSTER = 8         # blocks of one thread-block cluster (portable limit)
MAX_SLICES = 8          # ring slices of the adjoint's partial rows


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
def _lib():
    """Compile csrc/*.cu for sm_90a, one nvcc per source and all at once
    (once per hash of the sources), and load them. Returns the two bound C
    functions."""
    h = hashlib.sha256()
    for name in _HEADERS + _KERNEL_SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tag = h.hexdigest()[:16]
    sos = [os.path.join(_BUILD_DIR, f"lib{name[:-3]}_{tag}.so")
           for name in _KERNEL_SOURCES]
    BUILD_INFO.setdefault("seconds", 0.0)
    BUILD_INFO.setdefault("ptxas", [])
    t0 = time.perf_counter()
    procs = []
    for name, so in zip(_KERNEL_SOURCES, sos):
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"   # concurrent builds never collide
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, os.path.join(_CSRC, name)]
        procs.append((so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + out)
        BUILD_INFO["ptxas"] += [ln for ln in out.splitlines()
                                if "registers" in ln or "spill" in ln
                                or "Compiling entry" in ln]
        os.replace(tmp, so)
    if procs:
        BUILD_INFO["seconds"] = time.perf_counter() - t0
    p, i = ctypes.c_void_p, ctypes.c_int
    synth = ctypes.CDLL(sos[0]).legendre_synth
    synth.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    synth.restype = i
    adjoint = ctypes.CDLL(sos[1]).legendre_adjoint
    adjoint.argtypes = [p, p, p, p, p, p, p, p, p, p,
                        i, i, i, i, i, i, i, p]
    adjoint.restype = i
    return synth, adjoint


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


def _check_spin(otf: LegendreOTF):
    # the kernels unroll l by parity from an even first ell, and seed at
    # max(m, |mp|) <= lmax
    if otf.mp not in (0, 2, -2) or otf.lmax < abs(otf.mp):
        raise ValueError(f"mp {otf.mp} at lmax {otf.lmax}: the kernels take "
                         "mp in (0, +2, -2) and lmax >= |mp|")
    if otf.mmax > otf.lmax:
        raise ValueError(f"mmax {otf.mmax} > lmax {otf.lmax}")


def batch_groups(nb: int) -> tuple:
    """How the wrappers cut a batch of nb into kernel launches of at most
    MAX_NB entries: the fewest launches, of sizes as even as they go (6 is
    3 + 3, not 4 + 2: the adjoint's 4-entry instantiation holds one block
    per SM where the smaller ones hold two)."""
    if nb < 1:
        raise ValueError(f"empty batch ({nb})")
    n = -(-nb // MAX_NB)
    return tuple(nb // n + (i < nb % n) for i in range(n))


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
    _check_spin(otf)
    synth, _ = _lib()
    seeds, seede, A, B, beta, x = _device_pack(otf, alm.device)
    batch = alm.shape[:-2]
    nb = int(np.prod(batch, dtype=np.int64))
    Fn = torch.empty(batch + (nh, nm), dtype=torch.complex64,
                     device=alm.device)
    Fs = torch.empty_like(Fn)
    stream = torch.cuda.current_stream(alm.device).cuda_stream
    b0 = 0
    for g in batch_groups(nb):
        rc = synth(seeds.data_ptr(), seede.data_ptr(), A.data_ptr(),
                   B.data_ptr(), beta.data_ptr(), x.data_ptr(),
                   alm.data_ptr() + b0 * nl * nm * 8,
                   Fn.data_ptr() + b0 * nh * nm * 8,
                   Fs.data_ptr() + b0 * nh * nm * 8, g, nh, nl, nm, otf.mp,
                   stream)
        _raise_on(rc, "legendre_synth")
        b0 += g
    LAUNCHES["synth"] += 1
    return Fn, Fs


@dataclasses.dataclass(frozen=True)
class AdjointPlan:
    """How the adjoint kernel divides the nh rings.

    A block holds RINGS_PER_BLOCK neighbouring rings; `cluster` blocks of
    neighbouring rings form a thread-block cluster that adds its sums
    through distributed shared memory; cluster number q = pass * nslice +
    slice of the ring axis is run by ring slice `slice` in its pass `pass`,
    and each slice adds its passes into its own partial rows; a second
    kernel adds the slices in order. Every sum has a fixed order (no float
    atomics), so the result is the same bits on every run."""
    cluster: int
    nslice: int
    npass: int

    def owner(self, ring: int):
        """(slice, pass, rank in cluster, warp, k) of the thread that runs
        `ring`; the sums run over k, then warp, then rank, then pass, then
        slice, each in rising order."""
        chunk, r = divmod(ring, RINGS_PER_BLOCK)
        q, rank = divmod(chunk, self.cluster)
        p, s = divmod(q, self.nslice)
        warp, k = divmod(r, RINGS_PER_THREAD)
        return s, p, rank, warp, k


def adjoint_plan(nh: int) -> AdjointPlan:
    """The adjoint kernel's ring partition: the largest cluster (a power of
    two up to MAX_CLUSTER) that nh fills, and up to MAX_SLICES ring slices.
    nh = 2048 gives 8 slices of one 8-block cluster each, one pass: every
    partial row is written once; nh >= 4096 takes further passes."""
    nchunks = -(-nh // RINGS_PER_BLOCK)
    cluster = 1
    while cluster * 2 <= min(nchunks, MAX_CLUSTER):
        cluster *= 2
    nsuper = -(-nchunks // cluster)
    nslice = min(nsuper, MAX_SLICES)
    return AdjointPlan(cluster=cluster, nslice=nslice,
                       npass=-(-nsuper // nslice))


def adjoint_scratch_bytes(otf: LegendreOTF, nb: int) -> int:
    """Bytes of partial rows that adjoint_legendre allocates for a batch of
    nb: (nslice, largest batch group, nl, nm) complex64."""
    plan = adjoint_plan(2 * otf.nside)
    return (plan.nslice * max(batch_groups(nb)) * (otf.lmax + 1)
            * (otf.mmax + 1) * 8)


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
    _check_spin(otf)
    _, adjoint = _lib()
    seeds, seede, A, B, beta, x = _device_pack(otf, F_n.device)
    batch = F_n.shape[:-2]
    nb = int(np.prod(batch, dtype=np.int64))
    plan = adjoint_plan(nh)
    part = torch.empty(adjoint_scratch_bytes(otf, nb) // 8,
                       dtype=torch.complex64, device=F_n.device)
    out = torch.empty(batch + (nl, nm), dtype=torch.complex64,
                      device=F_n.device)
    stream = torch.cuda.current_stream(F_n.device).cuda_stream
    b0 = 0
    for g in batch_groups(nb):
        rc = adjoint(seeds.data_ptr(), seede.data_ptr(), A.data_ptr(),
                     B.data_ptr(), beta.data_ptr(), x.data_ptr(),
                     F_n.data_ptr() + b0 * nh * nm * 8,
                     F_s.data_ptr() + b0 * nh * nm * 8, part.data_ptr(),
                     out.data_ptr() + b0 * nl * nm * 8, g, nh, nl, nm,
                     otf.mp, plan.nslice, plan.cluster, stream)
        _raise_on(rc, "legendre_adjoint")
        b0 += g
    LAUNCHES["adjoint"] += 1
    return out
