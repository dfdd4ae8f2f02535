"""Instrument-file loaders: beam b_ell tables and the real-packed alm layout.

The port's counterpart of commander_tpu.instrument.files: HEALPix-style b_l
FITS tables (comm_B_bl_mod.f90 file input), read with the port's narrow
FITS reader (io/fits.py), the band-average bandpass, and the real-packed /
complex alm helpers of the RIMO layout (commander_instrument.py add_alms).

Not ported yet: the HDF instrument readers (load_bandpass_hdf,
load_rimo_tod, write_rimo_tod). They come with the archive reader (ROADMAP
queue 1 item 6) and raise until then.
"""
from __future__ import annotations

import numpy as np

from ..io import fits as fitsio
from .bandpass import Bandpass

GHZ = 1e9

_ARCHIVE = "is not ported: ROADMAP queue 1 item 6 (the archive reader)"


def load_bandpass_hdf(path: str, det: str, unit: str = "uK_cmb",
                      profile_type: str = "LFI") -> Bandpass:
    """A detector's bandpass from a Commander instrument HDF file: not
    ported (raises)."""
    raise NotImplementedError(f"the HDF bandpass reader ({path!r}) "
                              f"{_ARCHIVE}")


def load_rimo_tod(path: str, dets: list):
    """Per-detector TOD instrument data from a RIMO HDF file: not ported
    (raises)."""
    raise NotImplementedError(f"the RIMO reader ({path!r}) {_ARCHIVE}")


def average_bandpass(bps: list, unit: str = "uK_cmb") -> Bandpass:
    """Band-average bandpass over detectors (the reference's band-level
    profile when per-detector ones exist)."""
    nu = bps[0].nu
    tau = np.mean([np.interp(nu, b.nu, b.tau, left=0, right=0) for b in bps],
                  axis=0)
    return Bandpass(nu=nu, tau=tau, unit=unit,
                    profile_type=bps[0].profile_type)


def load_beam_bl_fits(path: str, lmax: int) -> np.ndarray:
    """Read a b_ell FITS table (TT[,EE,BB[,TE]] columns) -> (lmax+1, ncol)
    float64, padded with zeros or cut to lmax."""
    with open(path, "rb") as f:
        buf = f.read()
    hdr0, off = fitsio._parse_header(buf, 0)
    if hdr0.get("NAXIS", 0):
        n = 1
        for i in range(1, hdr0["NAXIS"] + 1):
            n *= hdr0.get(f"NAXIS{i}", 1)
        nbytes = n * abs(hdr0.get("BITPIX", 8)) // 8
        off += ((nbytes + fitsio._BLOCK - 1) // fitsio._BLOCK) * fitsio._BLOCK
    hdr, off = fitsio._parse_header(buf, off)
    nrows = hdr["NAXIS2"]
    ncols = hdr["TFIELDS"]
    dtypes = []
    for i in range(1, ncols + 1):
        tf = str(hdr[f"TFORM{i}"]).strip()
        repeat = int(tf[:-1]) if tf[:-1] else 1
        dtypes.append((f"c{i}", fitsio._TFORM_DTYPES[tf[-1]], (repeat,)))
    rec = np.frombuffer(buf, dtype=np.dtype(dtypes), count=nrows, offset=off)
    cols = np.stack([rec[f"c{i}"].astype(np.float64).reshape(-1)
                     for i in range(1, ncols + 1)], axis=-1)
    out = np.zeros((lmax + 1, cols.shape[1]))
    n = min(lmax + 1, cols.shape[0])
    out[:n] = cols[:n]
    return out


def _realpacked_to_complex(vals: np.ndarray, lmax: int, mmax: int):
    """Real-packed alms (lfi.complex2realAlms layout) -> complex (nl, nm).

    vals[l^2+l+m] = sqrt(2) Re a_lm (m>0), vals[l^2+l-m] = sqrt(2) Im a_lm,
    vals[l^2+l] = a_l0 (real). Returns (lmax+1, mmax+1) complex128."""
    out = np.zeros((lmax + 1, mmax + 1), np.complex128)
    for l in range(lmax + 1):
        base = l * l + l
        out[l, 0] = vals[base]
        for m in range(1, min(l, mmax) + 1):
            out[l, m] = (vals[base + m] + 1j * vals[base - m]) / np.sqrt(2.0)
    return out


def _complex_to_realpacked(alm: np.ndarray):
    """Inverse of _realpacked_to_complex: (nl, nm) complex -> (nl^2,) real."""
    nl, nm = alm.shape
    lmax = nl - 1
    vals = np.zeros((lmax + 1) ** 2)
    for l in range(lmax + 1):
        base = l * l + l
        vals[base] = alm[l, 0].real
        for m in range(1, min(l, nm - 1) + 1):
            vals[base + m] = np.sqrt(2.0) * alm[l, m].real
            vals[base - m] = np.sqrt(2.0) * alm[l, m].imag
    return vals
