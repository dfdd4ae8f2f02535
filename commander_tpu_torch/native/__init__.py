"""Host C++ of the port: the Huffman decoder of the TOD archives.

native/huffman.cpp (huffman_decode, cumsum_i64) is compiled with g++ at
first use, once per hash of the source, into build/commander_tpu_torch/
beside the package (the directory the CUDA kernels build into), and bound
through ctypes. A build that fails raises: the port has no silent
pure-Python stand-in for the decoder (tod/huffman.decode_plain is the plain
version, which callers ask for by name).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "huffman.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build",
    "commander_tpu_torch")
# the readers decode on a pool of threads: the first calls wait for one
# build
_LOCK = threading.Lock()


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler (g++) found: the Huffman decoder "
                       "cannot be built on this machine")


def lib() -> ctypes.CDLL:
    """Build (if needed) and load libhuffman, once per process; raises
    RuntimeError where it cannot be built."""
    with _LOCK:
        return _lib()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libhuffman_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"     # concurrent builds never collide
        proc = subprocess.run([_compiler(), "-O3", "-shared", "-fPIC", "-o",
                               tmp, _SRC], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("the Huffman decoder failed to build:\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, so)
    L = ctypes.CDLL(so)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    i64 = ctypes.c_longlong
    L.huffman_decode.restype = i64
    L.huffman_decode.argtypes = [i64p, i64p, i64, i64, i64p, u8p, i64, i64p,
                                 i64]
    L.cumsum_i64.restype = None
    L.cumsum_i64.argtypes = [i64p, i64]
    return L
