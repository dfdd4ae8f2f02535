"""4D maps: (pixel, psi-bin) binned TOD products for null tests (torch).

Counterpart of commander_tpu.tod.maps4d (the reference's
comm_4D_map_mod.f90): bin_4d sorts the samples by the combined index
pix * npsi + psi_bin and sums each run in float64, without atomics;
write_4d_hdf writes them through the port's own HDF5 writer (io/hdf5.py),
which h5py reads.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..io import hdf5
from .model import _run_sums, pixel_runs


def bin_4d(tod, pix, psi, mask, inv_var, npix: int, npsi: int):
    """Returns float64 (signal_sum (npix, npsi), weight_sum (npix, npsi),
    mean)."""
    # a true division: the card divides by a scalar through its reciprocal,
    # which moves samples on a bin edge (psi at multiples of pi / 32 in the
    # simulator's scans) into the bin below
    psi_bin = torch.floor(psi / torch.full_like(psi, 2.0 * math.pi)
                          * npsi).to(torch.int32) % npsi
    runs = pixel_runs(pix.to(torch.int32) * npsi + psi_bin, npix * npsi)
    w_all = (mask * inv_var[..., None]).reshape(-1)

    def planes(idx):
        w = w_all.index_select(0, idx).to(torch.float64)
        d = tod.reshape(-1).index_select(0, idx).to(torch.float64)
        return torch.stack([d * w, w], dim=1)

    ssum, wsum = _run_sums(runs, planes, 2)
    mean = torch.where(wsum > 0, ssum / torch.clamp(wsum, min=1e-30), 0.0)
    return (ssum.reshape(npix, npsi), wsum.reshape(npix, npsi),
            mean.reshape(npix, npsi))


def write_4d_hdf(path: str, det: str, ssum, wsum, mean):
    """The detector's (npix, npsi) signal sum, weight sum and mean as the
    datasets signal, weight and mean of group `det` in the HDF5 file `path`
    (made when missing, else added to; a dataset of that name is replaced),
    as the reference's 4D-map files hold them (comm_4D_map_mod.f90:97)."""
    host = lambda x: x.detach().to("cpu").numpy() \
        if isinstance(x, torch.Tensor) else np.asarray(x)
    with hdf5.File(path, "a") as f:
        g = f.require_group(det)
        for name, arr in (("signal", ssum), ("weight", wsum),
                          ("mean", mean)):
            f.write_dataset(g, name, host(arr))
