"""Minimal HEALPix FITS map reader/writer in pure numpy.

The port's copy of commander_tpu.io.fits, on the port's sphere/healpix.py.
The reference reads and writes HEALPix maps through CFITSIO and the HEALPix
Fortran library (comm_map_mod.f90 FITS paths); with no astropy or CFITSIO
this implements the narrow subset HEALPix sky maps need: a primary HDU and
one BINTABLE extension whose columns are the Stokes maps, with ORDERING =
RING or NESTED. That covers maps written by healpy.write_map and the
HEALPix tools.

Format facts used (FITS standard): 2880-byte logical records; 80-char ASCII
header cards; BINTABLE rows of big-endian binary columns described by
TFORMn like '1024E'.
"""
from __future__ import annotations

import numpy as np

from ..sphere import healpix

_BLOCK = 2880


def _cards(header: dict) -> bytes:
    out = []
    for k, v in header.items():
        if k == "COMMENT":
            for c in np.atleast_1d(v):
                out.append(f"COMMENT {c}".ljust(80)[:80])
            continue
        if isinstance(v, bool):
            s = "T" if v else "F"
            card = f"{k:<8}= {s:>20}"
        elif isinstance(v, (int, np.integer)):
            card = f"{k:<8}= {v:>20d}"
        elif isinstance(v, float):
            card = f"{k:<8}= {v:>20.12G}"
        else:
            card = f"{k:<8}= '{v}'"
        out.append(card.ljust(80)[:80])
    out.append("END".ljust(80))
    data = "".join(out).encode("ascii")
    pad = (-len(data)) % _BLOCK
    return data + b" " * pad


def _parse_header(buf: bytes, off: int):
    """Parse header cards from offset; returns (dict, new offset)."""
    hdr = {}
    while True:
        block = buf[off:off + _BLOCK]
        off += _BLOCK
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                return hdr, off
            if "=" not in card[8:10]:
                continue
            val = card[10:].split("/")[0].strip()
            if val.startswith("'"):
                hdr[key] = val.strip("'").strip()
            elif val == "T":
                hdr[key] = True
            elif val == "F":
                hdr[key] = False
            else:
                try:
                    hdr[key] = int(val)
                except ValueError:
                    try:
                        hdr[key] = float(val)
                    except ValueError:
                        hdr[key] = val
        if off >= len(buf):
            raise ValueError("unterminated FITS header")


_TFORM_DTYPES = {"E": ">f4", "D": ">f8", "J": ">i4", "K": ">i8", "I": ">i2",
                 "B": "u1"}


def read_map(path: str, nest: bool | None = None) -> np.ndarray:
    """Read a HEALPix map FITS file -> (nmaps, npix) float64, RING order."""
    with open(path, "rb") as f:
        buf = f.read()
    hdr0, off = _parse_header(buf, 0)
    # skip primary data (usually none)
    if hdr0.get("NAXIS", 0):
        n = 1
        for i in range(1, hdr0["NAXIS"] + 1):
            n *= hdr0.get(f"NAXIS{i}", 1)
        nbytes = n * abs(hdr0.get("BITPIX", 8)) // 8
        off += ((nbytes + _BLOCK - 1) // _BLOCK) * _BLOCK
    hdr, off = _parse_header(buf, off)
    if hdr.get("XTENSION", "").startswith("BINTABLE") is False and \
       "BINTABLE" not in str(hdr.get("XTENSION", "")):
        raise ValueError(f"expected BINTABLE extension, got {hdr.get('XTENSION')}")
    nrows = hdr["NAXIS2"]
    rowbytes = hdr["NAXIS1"]
    ncols = hdr["TFIELDS"]
    dtypes = []
    for i in range(1, ncols + 1):
        tf = str(hdr[f"TFORM{i}"]).strip()
        repeat = int(tf[:-1]) if tf[:-1] else 1
        code = tf[-1]
        dtypes.append((f"c{i}", _TFORM_DTYPES[code], (repeat,)))
    rec = np.frombuffer(buf, dtype=np.dtype(dtypes), count=nrows, offset=off)
    cols = [rec[f"c{i}"].astype(np.float64).reshape(-1) for i in range(1, ncols + 1)]
    maps = np.stack(cols)
    npix = maps.shape[1]
    nside = int(np.sqrt(npix / 12))
    ordering = str(hdr.get("ORDERING", "RING")).upper()
    if nest is None:
        nest = ordering.startswith("NEST")
    if nest:
        maps = maps[:, healpix.ring2nest_table(nside)]
    # HEALPix bad value
    maps[maps < -1.63e30] = np.nan
    return maps


def write_map(path: str, maps: np.ndarray, nest: bool = False,
              unit: str = "uK", extra_header: dict | None = None):
    """Write (nmaps, npix) RING maps as a standard HEALPix FITS file."""
    maps = np.atleast_2d(np.asarray(maps, dtype=np.float64))
    nmaps, npix = maps.shape
    nside = int(np.sqrt(npix / 12))
    if 12 * nside * nside != npix:
        raise ValueError(f"npix {npix} is not a HEALPix size")
    if nest:
        maps = maps[:, healpix.nest2ring_table(nside)]

    primary = _cards({"SIMPLE": True, "BITPIX": 8, "NAXIS": 0, "EXTEND": True})
    names = (["TEMPERATURE", "Q_POLARISATION", "U_POLARISATION"][:nmaps]
             if nmaps <= 3 else [f"COL{i+1}" for i in range(nmaps)])
    hdr = {
        "XTENSION": "BINTABLE", "BITPIX": 8, "NAXIS": 2,
        "NAXIS1": 4 * nmaps, "NAXIS2": npix, "PCOUNT": 0, "GCOUNT": 1,
        "TFIELDS": nmaps,
    }
    for i, nm in enumerate(names):
        hdr[f"TTYPE{i+1}"] = nm
        hdr[f"TFORM{i+1}"] = "1E"
        hdr[f"TUNIT{i+1}"] = unit
    hdr.update({
        "PIXTYPE": "HEALPIX", "ORDERING": "NESTED" if nest else "RING",
        "NSIDE": nside, "FIRSTPIX": 0, "LASTPIX": npix - 1,
        "INDXSCHM": "IMPLICIT", "OBJECT": "FULLSKY",
    })
    if extra_header:
        hdr.update(extra_header)
    table = np.empty(npix, dtype=np.dtype([(f"c{i}", ">f4") for i in range(nmaps)]))
    for i in range(nmaps):
        table[f"c{i}"] = maps[i].astype(">f4")
    data = table.tobytes()
    pad = (-len(data)) % _BLOCK
    with open(path, "wb") as f:
        f.write(primary)
        f.write(_cards(hdr))
        f.write(data + b"\x00" * pad)
