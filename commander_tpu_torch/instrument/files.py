"""Instrument files: HDF bandpasses, the TOD instrument (RIMO) files, beam
b_ell tables and the real-packed alm layout.

The port's counterpart of commander_tpu.instrument.files: the reference's
instrument HDF files (written by commander_instrument.py: <det>/bandpassx
[GHz] and <det>/bandpass per detector, read by comm_bp_mod.f90; the RIMO's
per-detector sidelobe and main-beam alms, read by load_instrument_file,
comm_tod_mod.f90:334-380) through the port's HDF5 subset (io/hdf5.py),
HEALPix-style b_l FITS tables (comm_B_bl_mod.f90 file input) through its
FITS reader (io/fits.py), and the band-average bandpass. A detector or
dataset a file lacks raises KeyError, as h5py does.
"""
from __future__ import annotations

import numpy as np

from ..io import fits as fitsio
from ..io import hdf5
from .bandpass import Bandpass, trim_profile

GHZ = 1e9
_RIMO_SCALARS = ("fwhm", "elip", "psi_ell", "mbeam_eff", "centFreq")


def load_bandpass_hdf(path: str, det: str, unit: str = "uK_cmb",
                      profile_type: str = "LFI") -> Bandpass:
    """One detector's bandpass from a Commander instrument HDF file:
    <det>/bandpassx (GHz, or Hz where its largest node is 1e7 or more) and
    <det>/bandpass, the nodes with tau > 0, trimmed by the profile type's
    threshold (comm_bp_mod.f90:99-116, trim_profile)."""
    with hdf5.File(path, "r") as f:
        nu = np.asarray(f.read(f"{det}/bandpassx"), np.float64)
        tau = np.asarray(f.read(f"{det}/bandpass"), np.float64)
    if nu.max() < 1e7:      # stored in GHz
        nu = nu * GHZ
    good = tau > 0
    nu, tau = trim_profile(nu[good], tau[good], profile_type)
    return Bandpass(nu=nu, tau=tau, unit=unit, profile_type=profile_type)


def load_rimo_tod(path: str, dets: list) -> dict:
    """Per-detector TOD instrument data from a RIMO HDF file: det ->
    {'sl': (sllmax+1, slmmax+1) complex sidelobe beam alms or None, 'beam':
    the main beam's or None, and the scalars fwhm (arcmin), elip, psi_ell,
    mbeam_eff, centFreq (GHz), 0 where absent} (load_instrument_file)."""
    out = {}
    with hdf5.File(path, "r") as f:
        for det in dets:
            f[det]                          # KeyError for a missing det
            d = {k: float(f.read(f"{det}/{k}").reshape(-1)[0])
                 if f"{det}/{k}" in f else 0.0 for k in _RIMO_SCALARS}
            for field in ("sl", "beam"):
                if f"{det}/{field}" in f and f"{det}/{field}lmax" in f:
                    lmax = int(f.read(f"{det}/{field}lmax").reshape(-1)[0])
                    mmax = int(f.read(f"{det}/{field}mmax").reshape(-1)[0])
                    vals = np.asarray(f.read(f"{det}/{field}/T"),
                                      np.float64).reshape(-1)
                    d[field] = _realpacked_to_complex(vals, lmax, mmax)
                else:
                    d[field] = None
            out[det] = d
    return out


def write_rimo_tod(path: str, dets: dict):
    """A RIMO file in the reference's layout (commander_instrument.py
    add_alms): dets maps a detector to a dict with optional 'sl' / 'beam'
    complex (nl, nm) alms (written real-packed with their lmax and mmax),
    the scalars of load_rimo_tod, and optional 'bandpassx' / 'bandpass'
    arrays (the detector's bandpass, read by load_bandpass_hdf)."""
    with hdf5.File(path, "w") as f:
        for det, d in dets.items():
            for k in _RIMO_SCALARS:
                f.put(f"{det}/{k}", np.float64(d.get(k, 0.0)))
            for field in ("sl", "beam"):
                alm = d.get(field)
                if alm is None:
                    continue
                alm = np.asarray(alm)
                f.put(f"{det}/{field}/T", _complex_to_realpacked(alm))
                f.put(f"{det}/{field}lmax",
                      np.asarray([alm.shape[0] - 1], np.int64))
                f.put(f"{det}/{field}mmax",
                      np.asarray([alm.shape[1] - 1], np.int64))
            if "bandpassx" in d:
                f.put(f"{det}/bandpassx", np.asarray(d["bandpassx"]))
                f.put(f"{det}/bandpass", np.asarray(d["bandpass"]))


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
