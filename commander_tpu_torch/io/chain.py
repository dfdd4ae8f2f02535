"""HDF5 chain files: Commander-compatible sample storage and resume.

The port's counterpart of commander_tpu.io.chain (the reference's
comm_output_mod.f90 init_chain_file :30-90 and output_hdf_sample :91-374,
and the restart scan of commander.f90:160-174), on the port's narrow HDF5
reader and writer (io/hdf5.py) in place of h5py. Groups, dataset names,
shapes and dtypes are the JAX package's, so each package reads the other's
files:

    /000001/<comp>/alm      (nmaps, (lmax+1)^2) float64, packed real alms;
                            attribute lmax
    /000001/<comp>/Dl       (nmaps, lmax+1)
    /000001/<comp>/specind  (npar,)
    /000001/gain            (nband,)
    /000001/aux/<name>      chisq, cg_iters, md_amps, ptsrc_amps, ...
    /000001/tod/<band>/...  the TOD state: gain, sigma0, alpha, fknee, ...
    /parameters             model metadata as attributes

Samples are zero-padded 6-digit groups. The packed alms are the HEALPix
real layout the reference writes: index l^2 + l + m, a(l, m) = sqrt(2) Re,
a(l, -m) = sqrt(2) Im for m > 0, a(l, 0) real.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from . import hdf5


@functools.lru_cache(maxsize=4)
def _pack_index(lmax: int):
    """(l, m, l^2 + l + m) over the triangle m <= l, in l-major order."""
    ell, m = np.tril_indices(lmax + 1)
    return ell, m, ell * ell + ell


def pack_alm_real(alm: np.ndarray, lmax: int) -> np.ndarray:
    """Complex (..., lmax+1, mmax+1) -> packed real (..., (lmax+1)^2)
    float64, index l^2 + l + m with m in [-l, l]."""
    ell, m, base = _pack_index(lmax)
    a = np.asarray(alm)[..., ell, m]
    out = np.zeros(alm.shape[:-2] + ((lmax + 1) ** 2,), dtype=np.float64)
    m0 = m == 0
    out[..., base[m0]] = a[..., m0].real
    pos = ~m0
    out[..., base[pos] + m[pos]] = np.sqrt(2.0) * a[..., pos].real
    out[..., base[pos] - m[pos]] = np.sqrt(2.0) * a[..., pos].imag
    return out


def unpack_alm_real(packed: np.ndarray, lmax: int) -> np.ndarray:
    """Inverse of pack_alm_real: (..., (lmax+1)^2) -> complex128
    (..., lmax+1, lmax+1)."""
    ell, m, base = _pack_index(lmax)
    packed = np.asarray(packed)
    out = np.zeros(packed.shape[:-1] + (lmax + 1, lmax + 1), np.complex128)
    m0 = m == 0
    out[..., ell[m0], 0] = packed[..., base[m0]]
    pos = ~m0
    out[..., ell[pos], m[pos]] = (packed[..., base[pos] + m[pos]]
                                  + 1j * packed[..., base[pos] - m[pos]]) \
        / np.sqrt(2.0)
    return out


class ChainFile:
    """Append-only chain writer and reader (one file per chain, like
    chain_c0001.h5). mode: "a" (read and append, made when missing), "r"
    or "w"."""

    def __init__(self, path: str, mode: str = "a"):
        self.path = path
        self.f = hdf5.File(path, mode)

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def sample_name(i: int) -> str:
        return f"{i:06d}"

    def last_sample(self) -> int:
        """Highest sample index present (0 if none)."""
        idx = [int(k) for k in self.f.root.members if k.isdigit()]
        return max(idx) if idx else 0

    def _put(self, group: hdf5.Group, name: str, v):
        self.f.write_dataset(group, name, np.asarray(v))

    def write_sample(self, i: int, comps: dict, gains=None, bp_deltas=None,
                     extra: Optional[dict] = None):
        """comps: {name: {'alm': complex (S, nl, nm), 'Dl': (S, nl),
        'specind': array, 'map': (S, P)}}: alm packed on write. gains,
        bp_deltas: (nband,); extra: arrays under aux/."""
        g = self.f.require_group(self.sample_name(i))
        for name, fields in comps.items():
            cg = self.f.require_group(f"{self.sample_name(i)}/{name}")
            for k, v in fields.items():
                if v is None:
                    continue
                v = np.asarray(v)
                if k == "alm":
                    lmax = v.shape[-2] - 1
                    v = pack_alm_real(v, lmax)
                    cg.attrs["lmax"] = lmax
                self._put(cg, k, v)
        if gains is not None:
            self._put(g, "gain", gains)
        if bp_deltas is not None:
            self._put(g, "bp_delta", bp_deltas)
        if extra:
            eg = self.f.require_group(f"{self.sample_name(i)}/aux")
            for k, v in extra.items():
                self._put(eg, k, v)
        self.f.flush()

    def read_sample(self, i: int) -> dict:
        g = self.f.get(self.sample_name(i))
        if not isinstance(g, hdf5.Group):
            raise KeyError(f"sample {i} not in {self.path}")
        read = self.f.read_dataset
        out = {"comps": {}}
        for name, item in g.members.items():
            if name in ("gain", "bp_delta"):
                out[name] = read(item)
            elif name == "aux":
                out["aux"] = {k: read(v) for k, v in item.members.items()}
            elif name == "tod":
                continue
            else:
                fields = {}
                for k, v in item.members.items():
                    arr = read(v)
                    if k == "alm":
                        arr = unpack_alm_real(arr, int(item.attrs["lmax"]))
                    fields[k] = arr
                out["comps"][name] = fields
        return out

    def write_tod_state(self, i: int, band_label: str, tod: dict):
        """A band's TOD state under <sample>/tod/<band> (the reference's
        tod%dumpToHDF): gain and (sigma0, fknee, alpha) per scan and
        detector, and the optional per-detector fields."""
        g = self.f.require_group(f"{self.sample_name(i)}/tod/{band_label}")
        for k, v in tod.items():
            if v is not None:
                self._put(g, k, v)
        self.f.flush()

    def read_tod_state(self, i: int) -> dict:
        """{band_label: {field: array}} stored by write_tod_state (empty
        when the sample has none)."""
        g = self.f.get(f"{self.sample_name(i)}/tod")
        if not isinstance(g, hdf5.Group):
            return {}
        return {band: {k: self.f.read_dataset(v)
                       for k, v in item.members.items()}
                for band, item in g.members.items()}

    def write_metadata(self, meta: dict):
        pg = self.f.require_group("parameters")
        pg.attrs.update(meta)
        self.f.modified()
        self.f.flush()

    def read_metadata(self) -> dict:
        pg = self.f.get("parameters")
        return {} if pg is None else dict(pg.attrs)
