"""The Commander TOD archives: writer, reader, filelists and the scan
distribution (host I/O; the blocks go to the device at the end).

Counterpart of commander_tpu.tod.loader, on the port's own HDF5 subset
(io/hdf5.py) and Huffman coder (tod/huffman.py); the files are the ones the
reference writes (commander_tools/tod_tools/commander_tod.py,
todscripts/lfitohdf5.py) and reads (comm_tod_mod.f90 read_tod /
read_hdf_scan), and h5py and the JAX package read and write them alike:

    /common/{fsamp, nside, npsi, det, polang, mbang, pids}
    /NNNNNN/common/{ntod, time, vsun, satpos, hufftree, huffsymb}
    /NNNNNN/<det>/{pix, psi, flag, tod, scalars}

pix, psi and flag are differences Huffman-coded with the scan's shared tree
(psi quantized to npsi bins first), stored as opaque blobs; scalars =
[gain, sigma0, fknee, alpha]. The differential (WMAP) layout carries
pixA, psiA, pixB, psiB, flag and x_im per detector instead. A reader
decodes every stream on the host (the native decoder, on a pool of threads)
and pads the scans to the longest with mask 0; the TodBlock (or
DiffTodBlock) and TodState are built on `device` (None: the CUDA card) in
`dtype` at the end, pix int32.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..io import hdf5
from ..utils.device import resolve_device
from . import huffman
from .model import TodBlock, TodState

_DEFAULT_SCALARS = np.array([1.0, 1.0, 0.1, -1.0])


def _psi_bins(psi, npsi: int) -> np.ndarray:
    return np.round(np.asarray(psi) / (2 * np.pi / npsi)).astype(
        np.int64) % npsi


def _write_common(f: hdf5.File, nside: int, fsamp: float, det_names: list,
                  nscan: int, npsi: int, polang, mbang):
    nd = len(det_names)
    f.put("common/fsamp", np.float64(fsamp))
    f.put("common/nside", np.asarray([nside], np.int64))
    f.put("common/npsi", np.asarray([npsi], np.int64))
    f.put("common/det", np.bytes_(", ".join(det_names)))
    f.put("common/polang", np.zeros(nd) if polang is None
          else np.asarray(polang, np.float64))
    f.put("common/mbang", np.zeros(nd) if mbang is None
          else np.asarray(mbang, np.float64))
    f.put("common/pids", np.arange(1, nscan + 1, dtype=np.int64))


def _write_scan(f: hdf5.File, pid: str, det_names: list, sc: dict,
                streams: list, names: tuple, satpos: bool):
    """One scan group: the shared tree of the detectors' difference
    streams (streams[d * len(names) + k] is detector d's stream names[k]),
    the coded streams, tod in float32 and the scalars."""
    nt = len(streams[0])
    tree, symb, inv = huffman.build_tree(np.concatenate(streams), True)
    f.put(f"{pid}/common/ntod", np.asarray([nt], np.int64))
    f.put(f"{pid}/common/time", np.zeros(3))
    f.put(f"{pid}/common/vsun", np.asarray(sc["vsun"], np.float64))
    if satpos:
        f.put(f"{pid}/common/satpos",
              np.asarray(sc.get("satpos", [0.0, 0.0]), np.float64))
    f.put(f"{pid}/common/hufftree", tree)
    f.put(f"{pid}/common/huffsymb", symb)
    sca = sc.get("scalars")
    table = huffman.code_table(tree, symb)
    for d, det in enumerate(det_names):
        g = f"{pid}/{det}"
        for k, name in enumerate(names):
            i = d * len(names) + k
            f.put(f"{g}/{name}", np.void(huffman.encode_indices(
                inv[i * nt:(i + 1) * nt], table)))
        f.put(f"{g}/tod", np.asarray(sc["tod"][d], np.float32))
        f.put(f"{g}/scalars", _DEFAULT_SCALARS if sca is None
              else np.asarray(sca[d], np.float64))
    return tree, symb


def write_archive(path: str, nside: int, fsamp: float, det_names: list,
                  scans: list, npsi: int = 4096, polang=None, mbang=None):
    """An LFI archive. scans: dicts {'pix', 'psi', 'flag', 'tod' (Nd, Nt)
    arrays, 'vsun' (3,), optional 'satpos' (2,) ([0, 0] where absent) and
    'scalars' (Nd, 4)}; polang / mbang: per-detector polarization and
    main-beam angles (radians)."""
    with hdf5.File(path, "w") as f:
        _write_common(f, nside, fsamp, det_names, len(scans), npsi, polang,
                      mbang)
        for i, sc in enumerate(scans):
            pix = np.asarray(sc["pix"], np.int64)
            pb = _psi_bins(sc["psi"], npsi)
            flag = np.asarray(sc["flag"], np.int64)
            streams = []
            for d in range(pix.shape[0]):
                streams += [np.diff(pix[d], prepend=0),
                            np.diff(pb[d], prepend=0),
                            np.diff(flag[d], prepend=0)]
            _write_scan(f, f"{i + 1:06d}", det_names, sc, streams,
                        ("pix", "psi", "flag"), True)


def write_archive_diff(path: str, nside: int, fsamp: float, det_names: list,
                       scans: list, npsi: int = 4096):
    """A differential (two-horn, WMAP) archive: per detector pixA, psiA,
    pixB, psiB and flag streams, tod, scalars and x_im, and common/diff_horn
    = [1] (todscripts/wmap/fits_to_h5.py:190-215). scans: dicts {'pixA',
    'psiA', 'pixB', 'psiB', 'flag', 'tod' (Nd, Nt), 'vsun' (3,), optional
    'scalars' (Nd, 4), optional 'x_im' (Nd,)}."""
    with hdf5.File(path, "w") as f:
        _write_common(f, nside, fsamp, det_names, len(scans), npsi, None,
                      None)
        f.put("common/diff_horn", np.asarray([1], np.int64))
        for i, sc in enumerate(scans):
            pixA = np.asarray(sc["pixA"], np.int64)
            pixB = np.asarray(sc["pixB"], np.int64)
            bA, bB = _psi_bins(sc["psiA"], npsi), _psi_bins(sc["psiB"], npsi)
            flag = np.asarray(sc["flag"], np.int64)
            streams = []
            for d in range(pixA.shape[0]):
                streams += [np.diff(x[d], prepend=0)
                            for x in (pixA, bA, pixB, bB, flag)]
            pid = f"{i + 1:06d}"
            _write_scan(f, pid, det_names, sc, streams,
                        ("pixA", "psiA", "pixB", "psiB", "flag"), False)
            xim = sc.get("x_im")
            for d, det in enumerate(det_names):
                f.put(f"{pid}/{det}/x_im", np.float64(
                    0.0 if xim is None else xim[d]))


def _raw(f: hdf5.File, path: str) -> bytes:
    return f.read(path).tobytes()


def _decode_all(jobs: list) -> list:
    """Each (raw bytes, tree, symbols, ntod) decoded and summed, on a pool
    of threads (the native decoder releases the GIL)."""
    def one(job):
        raw, tree, symb, nt = job
        return huffman.decode(raw, tree, symb, n_expected=nt, cumsum=True)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(one, jobs))


def _header(f: hdf5.File, dets):
    fsamp = float(f.read("common/fsamp").reshape(-1)[0])
    nside = int(f.read("common/nside").reshape(-1)[0])
    npsi = int(f.read("common/npsi").reshape(-1)[0])
    all_dets = [s.strip() for s in
                f.read("common/det")[()].decode().split(",")]
    dets = [d for d in all_dets if dets is None or d in dets]
    pids = sorted(k for k in f.root.members if k.isdigit())
    return fsamp, nside, npsi, all_dets, dets, pids


def _read(path: str, names: tuple, bad_flag_bits: int, scan_ids, dets,
          check_ids: bool):
    """The host arrays of an archive: meta, per stream name (Ns, Nd, Nt)
    decoded values (psi as bin indices), tod, mask, vsun, satpos, the
    scalars and x_im."""
    with hdf5.File(path, "r") as f:
        fsamp, nside, npsi, all_dets, dets, pids = _header(f, dets)
        sel = [all_dets.index(d) for d in dets]
        polang = f.read("common/polang")[sel] if "common/polang" in f \
            else np.zeros(len(dets))
        if scan_ids is not None:
            want = {int(s) for s in scan_ids}
            have = {int(p) for p in pids}
            missing = sorted(want - have)
            if check_ids and missing:
                raise KeyError(
                    f"archive {path!r} is missing requested scan ids "
                    f"{missing} (archive holds {sorted(have)[:5]}... "
                    f"{len(have)} scans)")
            pids = [p for p in pids if int(p) in want]
        if not pids:
            raise ValueError(f"archive {path!r} contains no scan groups")
        ntods = [int(f.read(f"{p}/common/ntod").reshape(-1)[0])
                 for p in pids]
        nt_max = max(ntods)
        Ns, Nd = len(pids), len(dets)
        out = {k: np.zeros((Ns, Nd, nt_max), np.int64) for k in names}
        tod = np.zeros((Ns, Nd, nt_max), np.float64)
        vsun = np.zeros((Ns, 3), np.float64)
        satpos = np.zeros((Ns, 2), np.float64)
        scal = np.ones((Ns, Nd, 4), np.float64)
        x_im = np.zeros(Nd, np.float64)
        jobs, where = [], []
        for s, p in enumerate(pids):
            nt = ntods[s]
            tree = f.read(f"{p}/common/hufftree").astype(np.int64)
            symb = f.read(f"{p}/common/huffsymb").astype(np.int64)
            vsun[s] = f.read(f"{p}/common/vsun")
            if f"{p}/common/satpos" in f:
                satpos[s] = f.read(f"{p}/common/satpos")[:2]
            for d, det in enumerate(dets):
                g = f"{p}/{det}"
                for k in names:
                    jobs.append((_raw(f, f"{g}/{k}"), tree, symb, nt))
                    where.append((k, s, d, nt))
                tod[s, d, :nt] = f.read(f"{g}/tod")[:nt]
                if f"{g}/scalars" in f:
                    scal[s, d] = f.read(f"{g}/scalars")
                if f"{g}/x_im" in f:
                    x_im[d] = float(f.read(f"{g}/x_im").reshape(-1)[0])
    for (k, s, d, nt), vals in zip(where, _decode_all(jobs)):
        out[k][s, d, :nt] = vals
    mask = np.zeros((Ns, Nd, nt_max), np.float64)
    for s, nt in enumerate(ntods):
        mask[s, :, :nt] = (out["flag"][s, :, :nt] & bad_flag_bits) == 0
    for k in names:
        if k.startswith("psi"):
            out[k] = (out[k] % npsi) * (2 * np.pi / npsi)
    meta = dict(nside=nside, npsi=npsi, dets=dets, fsamp=fsamp,
                polang=polang)
    return meta, out, tod, mask, vsun, satpos, scal, x_im


def _state(scal: np.ndarray, like: torch.Tensor) -> TodState:
    t = lambda a: torch.as_tensor(a).to(like.device, like.dtype)
    return TodState(gain=t(scal[..., 0]), sigma0=t(scal[..., 1]),
                    fknee=t(scal[..., 2]), alpha=t(scal[..., 3]),
                    n_corr=torch.zeros_like(like))


def _lfi_block(out, tod, mask, vsun, satpos, fsamp, device, dtype):
    t = lambda a: torch.as_tensor(a).to(device, dtype)
    return TodBlock(tod=t(tod), pix=torch.as_tensor(
        out["pix"].astype(np.int32)).to(device), psi=t(out["psi"]),
        mask=t(mask), vsun=t(vsun), fsamp=fsamp, satpos=t(satpos))


def read_archive(path: str, flag_mask: int = 0, bad_flag_bits: int = 0,
                 scan_ids=None, dets=None, device=None,
                 dtype=torch.float64):
    """An LFI archive as (TodBlock, TodState seed, meta {nside, npsi, dets,
    fsamp, polang}). Scans are padded to the longest with mask 0; a sample
    with any bit of bad_flag_bits set in its flag is masked (iand(flag,
    flag0) != 0, comm_tod_mod.f90:1331), so 0 (BAND_TOD_FLAG's default)
    masks nothing. scan_ids: the 1-based PIDs to read (KeyError where the
    archive lacks one); dets: a subset of the detectors. flag_mask is
    accepted and unused, as in the JAX reader."""
    device = resolve_device(device)
    meta, out, tod, mask, vsun, satpos, scal, _ = _read(
        path, ("pix", "psi", "flag"), bad_flag_bits, scan_ids, dets, True)
    block = _lfi_block(out, tod, mask, vsun, satpos, meta["fsamp"], device,
                       dtype)
    return block, _state(scal, block.tod), meta


def read_archive_diff(path: str, bad_flag_bits: int = 0, scan_ids=None,
                      dets=None, device=None, dtype=torch.float64):
    """A differential archive as (DiffTodBlock, TodState seed, meta with
    x_im (Nd,)). As the JAX reader, scan ids the archive lacks are skipped
    without a word (read_archive raises on them)."""
    from .differential import DiffTodBlock

    device = resolve_device(device)
    meta, out, tod, mask, vsun, _, scal, x_im = _read(
        path, ("pixA", "psiA", "pixB", "psiB", "flag"), bad_flag_bits,
        scan_ids, dets, False)
    t = lambda a: torch.as_tensor(a).to(device, dtype)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32)).to(device)
    block = DiffTodBlock(tod=t(tod), pixA=i32(out["pixA"]),
                         psiA=t(out["psiA"]), pixB=i32(out["pixB"]),
                         psiB=t(out["psiB"]), mask=t(mask), vsun=t(vsun),
                         fsamp=meta["fsamp"])
    del meta["polang"]
    meta["x_im"] = x_im
    return block, _state(scal, block.tod), meta


def read_filelist(path: str, first_scan: int = 1,
                  last_scan: int = 2 ** 31 - 1) -> dict:
    """A reference filelist (BAND_TOD_FILELIST): the entry count on the
    first line, then 'scanid filename weight theta phi' per line (spin-axis
    angles). Returns {scanid, filename, weight, spin} of the entries in
    [first_scan, last_scan]."""
    sids, names, weights, spins = [], [], [], []
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    n = int(lines[0][0])
    for parts in lines[1:n + 1]:
        sid = int(parts[0])
        if sid < first_scan or sid > last_scan:
            continue
        sids.append(sid)
        names.append(parts[1].strip('"'))
        weights.append(float(parts[2]) if len(parts) > 2 else 1.0)
        spins.append((float(parts[3]), float(parts[4]))
                     if len(parts) > 4 else (0.0, 0.0))
    if not sids:
        raise ValueError(f"No accepted scans in filelist {path!r} "
                         f"(first/last = {first_scan}/{last_scan})")
    return dict(scanid=np.asarray(sids), filename=names,
                weight=np.asarray(weights), spin=np.asarray(spins))


def distribute_scans(weights, spin, nproc: int) -> np.ndarray:
    """Scans over nproc shards (get_scan_ids, comm_tod_mod.f90:731-768):
    sorted by the spin axis' angle from the first scan's about their mean
    symmetry axis, cut into contiguous blocks of equal cumulative weight,
    filled from shard nproc - 1 down. Returns proc (n,) in [0, nproc)."""
    n = len(weights)
    weights = np.asarray(weights, np.float64)
    spin = np.asarray(spin, np.float64)
    th, ph = spin[:, 0], spin[:, 1]
    ax = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                   np.cos(th)], axis=-1)
    v = np.cross(ax[0], ax)
    v[v[:, 2] < 0] *= -1.0
    nv = np.linalg.norm(v, axis=-1)
    v0 = (v[nv > 0] / nv[nv > 0, None]).sum(0) if (nv > 0).any() \
        else np.array([0.0, 0.0, 1.0])
    v0 /= max(np.linalg.norm(v0), 1e-30)
    sid = np.arccos(np.clip(ax @ ax[0], -1.0, 1.0))
    sid[np.cross(ax[0], ax) @ v0 < 0] *= -1.0
    order = np.argsort(sid, kind="stable")
    cum = np.cumsum(weights[order]) - 0.5 * weights[order]
    shard_of_sorted = np.minimum(
        (cum / weights.sum() * nproc).astype(np.int64), nproc - 1)
    proc = np.zeros(n, np.int64)
    proc[order] = (nproc - 1) - shard_of_sorted
    return proc


def load_band_tod(filelist_path: str, data_dir: str | None = None,
                  bad_flag_bits: int = ~0, dets=None, first_scan: int = 1,
                  last_scan: int = 2 ** 31 - 1, shard: int = 0,
                  nshard: int = 1, device=None, dtype=torch.float64):
    """BAND_TOD_FILELIST as (TodBlock, TodState, meta with nscan): the
    filelist read, its scans distributed by weight, this shard's scans read
    from their archives (file by file, in name order; relative names under
    data_dir, else the filelist's directory) and padded into one block.
    bad_flag_bits defaults to ~0 (every flag bit masks), where read_archive
    defaults to 0; the driver passes BAND_TOD_FLAG."""
    device = resolve_device(device)
    fl = read_filelist(filelist_path, first_scan, last_scan)
    proc = distribute_scans(fl["weight"], fl["spin"], nshard)
    mine = np.nonzero(proc == shard)[0]
    if mine.size == 0:
        raise ValueError(f"shard {shard}/{nshard} received no scans")
    by_file: dict = {}
    for i in mine:
        by_file.setdefault(fl["filename"][i], []).append(int(fl["scanid"][i]))
    parts, meta = [], None
    for fname, sids in sorted(by_file.items()):
        path = fname if os.path.isabs(fname) else os.path.join(
            data_dir or os.path.dirname(filelist_path), fname)
        m, out, tod, mask, vsun, satpos, scal, _ = _read(
            path, ("pix", "psi", "flag"), bad_flag_bits, sids, dets, True)
        parts.append((out, tod, mask, vsun, satpos, scal))
        if meta is None:
            meta = m
        elif (m["nside"] != meta["nside"] or m["dets"] != meta["dets"]
              or m["fsamp"] != meta["fsamp"] or m["npsi"] != meta["npsi"]):
            raise ValueError(f"inconsistent archives in {filelist_path!r}: "
                             f"{m} vs {meta}")
    nt = max(p[1].shape[-1] for p in parts)
    pad = lambda a: np.pad(a, [(0, 0)] * (a.ndim - 1)
                           + [(0, nt - a.shape[-1])])
    cat = lambda i: np.concatenate([pad(p[i]) for p in parts], axis=0)
    out = {k: np.concatenate([pad(p[0][k]) for p in parts], axis=0)
           for k in ("pix", "psi")}
    block = _lfi_block(out, cat(1), cat(2),
                       np.concatenate([p[3] for p in parts], axis=0),
                       np.concatenate([p[4] for p in parts], axis=0),
                       meta["fsamp"], device, dtype)
    scal = np.concatenate([p[5] for p in parts], axis=0)
    meta["nscan"] = block.nscan
    return block, _state(scal, block.tod), meta
