"""Experiment data to Commander TOD archives: Planck LFI Level-2 exchange
files, LiteBIRD-style per-detector streams and WMAP differential day
records (host tooling).

Counterpart of commander_tpu.tod.convert (the reference's
todscripts/lfitohdf5.py, litebird/litebirdtohdf5.py and
wmap/fits_to_h5.py), on the port's HDF5 subset (io/hdf5.py) and archive
writers (tod/loader.py); each converter writes its archives and the
reference filelist ('scanid filename weight theta phi' under an entry
count), and returns the filelist's path:

    convert_l2_to_archive(od_files, dets, nside, fsamp, out_dir)
    convert_litebird_to_archive(det_files, dets, nside, fsamp, out_dir)
    convert_wmap_to_archive(days, dets, nside, fsamp, out_dir)

Per-scan vsun and satpos come from an L2 file's common/vsun and
common/satpos where present, else zeros.
"""
from __future__ import annotations

import os

import numpy as np

from ..io import hdf5
from ..sphere import healpix
from .loader import write_archive, write_archive_diff


def _ang2pix(nside, theta, phi):
    return np.asarray(healpix.ang2pix_ring(nside, np.asarray(theta),
                                           np.asarray(phi)), np.int64)


def _write_filelist(path: str, entries: list):
    with open(path, "w") as fh:
        fh.write(f"{len(entries)}\n")
        for sid, name, w, th, ph in entries:
            fh.write(f"{sid} {name} {w:.1f} {th:.5f} {ph:.5f}\n")


def read_l2_od(path: str, dets) -> list:
    """One operational day's exchange file as its pointing periods: dicts
    {pid, n, vsun, satpos, det: {d: {theta, phi, psi, flag, tod}}}, the
    samples with PID_start <= OBT < PID_end, periods of fewer than 2
    samples dropped (lfitohdf5.py:116-221 layout: Time/OBT, AHF_info/{PID,
    PID_start, PID_end}, <det>/{theta, phi, psi, flag, tod}, optional
    common/{vsun, satpos})."""
    periods = []
    with hdf5.File(path, "r") as f:
        obt = f.read("Time/OBT")
        pids = f.read("AHF_info/PID")
        p0 = f.read("AHF_info/PID_start")
        p1 = f.read("AHF_info/PID_end")
        vsun = f.read("common/vsun") if "common/vsun" in f else np.zeros(3)
        satpos = f.read("common/satpos") if "common/satpos" in f \
            else np.zeros(2)
        streams = {d: {k: f.read(f"{d}/{k}")
                       for k in ("theta", "phi", "psi", "flag", "tod")}
                   for d in dets}
    for i, pid in enumerate(pids):
        sel = (obt >= p0[i]) & (obt < p1[i])
        n = int(sel.sum())
        if n < 2:
            continue
        periods.append(dict(pid=int(pid), n=n, vsun=vsun, satpos=satpos,
                            det={d: {k: v[k][sel] for k in v}
                                 for d, v in streams.items()}))
    return periods


def convert_l2_to_archive(od_files, dets, nside: int, fsamp: float,
                          out_dir: str, band_label: str = "band",
                          npsi: int = 4096) -> str:
    """L2 exchange files -> one archive per file (<od>_arch.h5, its
    pointing periods as scans 1..n) and filelist_<band_label>.txt (weights
    the samples per period, angles the first detector's mean theta and
    phi)."""
    os.makedirs(out_dir, exist_ok=True)
    entries = []
    for od_path in od_files:
        periods = read_l2_od(od_path, dets)
        if not periods:
            continue
        scans = []
        for p in periods:
            nd, nt = len(dets), p["n"]
            pix = np.zeros((nd, nt), np.int64)
            psi = np.zeros((nd, nt))
            flag = np.zeros((nd, nt), np.int64)
            tod = np.zeros((nd, nt))
            for d, det in enumerate(dets):
                s = p["det"][det]
                pix[d] = _ang2pix(nside, s["theta"], s["phi"])
                psi[d] = np.mod(s["psi"], 2 * np.pi)
                flag[d] = s["flag"].astype(np.int64)
                tod[d] = s["tod"]
            scans.append(dict(pix=pix, psi=psi, flag=flag, tod=tod,
                              vsun=p["vsun"], satpos=p["satpos"]))
        name = os.path.splitext(os.path.basename(od_path))[0] + "_arch.h5"
        write_archive(os.path.join(out_dir, name), nside, fsamp, list(dets),
                      scans, npsi=npsi)
        for j, p in enumerate(periods):
            s0 = p["det"][dets[0]]
            entries.append((j + 1, name, p["n"], float(np.mean(s0["theta"])),
                            float(np.mean(s0["phi"]))))
    flist = os.path.join(out_dir, f"filelist_{band_label}.txt")
    _write_filelist(flist, entries)
    return flist


def convert_litebird_to_archive(det_files, dets, nside: int, fsamp: float,
                                out_dir: str, band_label: str = "LFT_40",
                                chunk_seconds: float = 3600.0,
                                npsi: int = 4096, polang=None, mbang=None,
                                vsun=None) -> str:
    """Per-detector full-segment streams {theta, phi, psi, tod} (an HDF
    file per detector, or a dict of arrays) -> one archive
    <band_label>_arch.h5 of chunk_seconds pointing periods (at least one;
    the streams cut to the shortest) with per-detector polang / mbang, and
    filelist_<band_label>.txt (angles of each period's first pixel)."""
    os.makedirs(out_dir, exist_ok=True)
    keys = ("theta", "phi", "psi", "tod")
    streams = {}
    for d in dets:
        src = det_files[d]
        if isinstance(src, dict):
            streams[d] = {k: np.asarray(src[k]) for k in keys}
        else:
            with hdf5.File(src, "r") as f:
                streams[d] = {k: f.read(k) for k in keys}
    n = min(len(s["tod"]) for s in streams.values())
    nsamp = max(int(chunk_seconds * fsamp), 1)
    nchunk = max(n // nsamp, 1)
    th_all, ph_all = healpix.pix2ang_ring(nside)
    name = f"{band_label}_arch.h5"
    scans, entries = [], []
    for c in range(nchunk):
        sl = slice(c * nsamp, min((c + 1) * nsamp, n))
        nt, nd = sl.stop - sl.start, len(dets)
        rec = dict(pix=np.zeros((nd, nt), np.int64), psi=np.zeros((nd, nt)),
                   flag=np.zeros((nd, nt), np.int64), tod=np.zeros((nd, nt)),
                   vsun=np.asarray(vsun if vsun is not None
                                   else np.zeros(3)))
        for di, d in enumerate(dets):
            s = streams[d]
            rec["pix"][di] = _ang2pix(nside, s["theta"][sl], s["phi"][sl])
            rec["psi"][di] = np.mod(s["psi"][sl], 2 * np.pi)
            rec["tod"][di] = s["tod"][sl]
        scans.append(rec)
        p0 = int(rec["pix"][0, 0])
        entries.append((c + 1, name, nt, float(th_all[p0]),
                        float(ph_all[p0])))
    write_archive(os.path.join(out_dir, name), nside, fsamp, list(dets),
                  scans, npsi=npsi, polang=polang, mbang=mbang)
    flist = os.path.join(out_dir, f"filelist_{band_label}.txt")
    _write_filelist(flist, entries)
    return flist


# J2000 celestial -> galactic rotation (fits_to_h5.py:266-278)
_CEL2GAL = np.array([
    [-0.0548755604, -0.8734370902, -0.4838350155],
    [+0.4941094279, -0.4448296300, +0.7469822445],
    [-0.8676661490, -0.1980763734, +0.4559837762]])


def _q2m(q) -> np.ndarray:
    """Quaternions (N, 4) [x, y, z, w] -> rotation matrices (N, 3, 3)
    (fits_to_h5.py:280-339 Q2M)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    q1, q2, q3, q4 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    m = np.empty((len(q), 3, 3))
    m[:, 0, 0] = q1 * q1 - q2 * q2 - q3 * q3 + q4 * q4
    m[:, 0, 1] = 2 * (q1 * q2 + q3 * q4)
    m[:, 0, 2] = 2 * (q1 * q3 - q2 * q4)
    m[:, 1, 0] = 2 * (q1 * q2 - q3 * q4)
    m[:, 1, 1] = -q1 * q1 + q2 * q2 - q3 * q3 + q4 * q4
    m[:, 1, 2] = 2 * (q2 * q3 + q1 * q4)
    m[:, 2, 0] = 2 * (q1 * q3 + q2 * q4)
    m[:, 2, 1] = 2 * (q2 * q3 - q1 * q4)
    m[:, 2, 2] = -q1 * q1 - q2 * q2 + q3 * q3 + q4 * q4
    return m


def quat_to_pointing(quat, dir_los, dir_pol, nside: int):
    """Attitude quaternions (N, 4) and a horn's line of sight and
    polarization axes in the spacecraft frame -> galactic (pix, psi): psi
    the polarization direction's angle from galactic north in the tangent
    plane (gamma_from_pol, fits_to_h5.py:340-375), in [0, 2 pi)."""
    M = _q2m(quat)
    d_gal = (M @ np.asarray(dir_los, np.float64)) @ _CEL2GAL.T
    p_gal = (M @ np.asarray(dir_pol, np.float64)) @ _CEL2GAL.T
    d_gal /= np.linalg.norm(d_gal, axis=-1, keepdims=True)
    theta = np.arccos(np.clip(d_gal[:, 2], -1.0, 1.0))
    phi = np.mod(np.arctan2(d_gal[:, 1], d_gal[:, 0]), 2 * np.pi)
    pix = _ang2pix(nside, theta, phi)
    st = np.maximum(np.sqrt(d_gal[:, 0] ** 2 + d_gal[:, 1] ** 2), 1e-12)
    east = np.stack([-d_gal[:, 1] / st, d_gal[:, 0] / st,
                     np.zeros(len(d_gal))], -1)
    north = (np.array([0.0, 0.0, 1.0]) - d_gal * d_gal[:, 2:3]) \
        / st[:, None]
    p_t = p_gal - d_gal * np.sum(p_gal * d_gal, -1, keepdims=True)
    psi = np.arctan2(np.sum(p_t * east, -1), np.sum(p_t * north, -1))
    return pix, np.mod(psi, 2 * np.pi)


def _flags_to_tod_rate(flags, ntod: int) -> np.ndarray:
    """Per-frame flags onto the TOD's samples, each taking the flag of the
    frame at or before it (fits_to_h5.py:113-118)."""
    flags = np.asarray(flags)
    t0 = np.arange(len(flags))
    t = np.linspace(t0.min(), t0.max(), ntod)
    idx = np.minimum(np.searchsorted(t0, t, side="right") - 1,
                     len(flags) - 1)
    return flags[np.maximum(idx, 0)]


def convert_wmap_to_archive(days, dets, nside: int, fsamp: float,
                            out_dir: str, band_label: str = "K1",
                            n_per_day: int = 1, npsi: int = 4096,
                            x_im=None, fknee: float = 0.1,
                            alpha: float = -1.0) -> str:
    """WMAP day records -> one differential archive per day
    (wmap_<band_label>_<day>_arch.h5, n_per_day periods) and
    filelist_<band_label>.txt (fits_to_h5.py write_file_parallel,
    :54-235). A day: per detector 'tod' frames (nframes, nsamp) taken in
    row order, 'daflags' (nframes,) spread to the samples, 'gain' guesses
    (the scalars' gain; sigma0 each period's std, fknee and alpha as
    given), and either 'pixA' / 'psiA' / 'pixB' / 'psiB' streams or 'quat'
    with 'losA' / 'losB' / 'polA' / 'polB' axes (quat_to_pointing);
    optional 'vsun'."""
    os.makedirs(out_dir, exist_ok=True)
    entries = []
    x_im = np.zeros(len(dets)) if x_im is None else np.asarray(x_im)
    th_all, ph_all = healpix.pix2ang_ring(nside)
    for day_i, day in enumerate(days):
        if "pixA" in day:
            pixA, psiA = np.asarray(day["pixA"]), np.asarray(day["psiA"])
            pixB, psiB = np.asarray(day["pixB"]), np.asarray(day["psiB"])
        else:
            pixA, psiA = quat_to_pointing(day["quat"], day["losA"],
                                          day["polA"], nside)
            pixB, psiB = quat_to_pointing(day["quat"], day["losB"],
                                          day["polB"], nside)
        ntod_day = len(pixA)
        splits = np.array_split(np.arange(ntod_day), n_per_day)
        flags = _flags_to_tod_rate(day["daflags"], ntod_day)
        scans = []
        for chunk in splits:
            nd, nt = len(dets), len(chunk)
            rec = dict(pixA=np.zeros((nd, nt), np.int64),
                       psiA=np.zeros((nd, nt)),
                       pixB=np.zeros((nd, nt), np.int64),
                       psiB=np.zeros((nd, nt)),
                       flag=np.zeros((nd, nt), np.int64),
                       tod=np.zeros((nd, nt)),
                       vsun=np.asarray(day.get("vsun", np.zeros(3))),
                       scalars=np.zeros((nd, 4)), x_im=x_im)
            for d, det in enumerate(dets):
                flat = np.asarray(day["tod"][det], np.float64).ravel(
                    order="C")[:ntod_day]
                rec["pixA"][d] = pixA[chunk]
                rec["psiA"][d] = np.mod(psiA[chunk], 2 * np.pi)
                rec["pixB"][d] = pixB[chunk]
                rec["psiB"][d] = np.mod(psiB[chunk], 2 * np.pi)
                rec["flag"][d] = flags[chunk].astype(np.int64)
                rec["tod"][d] = flat[chunk]
                g = float(day.get("gain", {}).get(det, 1.0))
                rec["scalars"][d] = [g, float(flat[chunk].std() or 1.0),
                                     fknee, alpha]
            scans.append(rec)
        name = f"wmap_{band_label}_{day_i + 1:06d}_arch.h5"
        write_archive_diff(os.path.join(out_dir, name), nside, fsamp,
                           list(dets), scans, npsi=npsi)
        for j, chunk in enumerate(splits):
            p0 = int(pixA[chunk[0]])
            entries.append((j + 1, name, len(chunk), float(th_all[p0]),
                            float(ph_all[p0])))
    flist = os.path.join(out_dir, f"filelist_{band_label}.txt")
    _write_filelist(flist, entries)
    return flist
