"""4D maps: (pixel, psi-bin) binned TOD products for null tests (torch).

Counterpart of commander_tpu.tod.maps4d.bin_4d (the reference's
comm_4D_map_mod.f90 binning): the samples are sorted by the combined index
pix * npsi + psi_bin and each run summed in float64, without atomics. The
HDF writer waits for the port of io/.
"""
from __future__ import annotations

import math

import torch

from .model import _run_sums, pixel_runs


def bin_4d(tod, pix, psi, mask, inv_var, npix: int, npsi: int):
    """Returns float64 (signal_sum (npix, npsi), weight_sum (npix, npsi),
    mean)."""
    psi_bin = torch.floor(psi / (2.0 * math.pi) * npsi).to(torch.int32) % npsi
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
