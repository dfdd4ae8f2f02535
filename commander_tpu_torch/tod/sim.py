"""Synthetic TOD: a scanning strategy, the sky and orbital dipole signal, and
1/f plus white noise (host numpy, then the block on the device).

Counterpart of commander_tpu.tod.sim, with the same numpy draws in the same
order and the same nearest-centre pointing, so that a seed gives the JAX
simulator's bits; the signal goes through this package's project_sky and
orbital_dipole (in float64 on the host). The nearest-centre tree is built
once per nside and queried on every core (the result does not depend on the
number of workers).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..sphere import healpix
from ..utils.device import resolve_device
from .model import TodBlock, orbital_dipole, project_sky


@functools.lru_cache(maxsize=1)
def pixel_tree(nside: int):
    """A cKDTree of the RING pixel centres' unit vectors."""
    from scipy.spatial import cKDTree
    return cKDTree(healpix.pix2vec_ring(nside))


def great_circle_scans(nside: int, nscan: int, ndet: int, ntod: int,
                       fsamp: float = 10.0, seed: int = 0):
    """Precessing great-circle pointing covering the sky: 3 revolutions per
    scan, a golden-ratio tilt ladder up to polar orbits, a transverse dither
    of 0.01 rad, and a polarization angle advancing 2/3 rad per scan radian
    (so that a pixel revisited on the next revolution sees a new angle).

    Returns pix (Ns, Nd, Nt) int32 and psi (Ns, Nd, Nt) float64."""
    rng = np.random.default_rng(seed)
    t = np.arange(ntod) / ntod * 2.0 * np.pi * 3.0
    x_all = np.empty((nscan, ndet, ntod, 3))
    psi = np.zeros((nscan, ndet, ntod))
    for s in range(nscan):
        phi0 = 2.0 * np.pi * s / nscan + rng.uniform(0, 0.1)
        tilt = 0.25 + (np.pi / 2 - 0.25) * ((s * 0.6180339887) % 1.0)
        for d in range(ndet):
            off = 0.05 * d
            x = np.stack([
                np.cos(t + off) * np.cos(phi0)
                - np.sin(t + off) * np.sin(phi0) * np.cos(tilt),
                np.cos(t + off) * np.sin(phi0)
                + np.sin(t + off) * np.cos(phi0) * np.cos(tilt),
                np.sin(t + off) * np.sin(tilt)], axis=-1)
            x = x + rng.normal(scale=0.01, size=x.shape)
            x /= np.linalg.norm(x, axis=-1, keepdims=True)
            x_all[s, d] = x
            psi[s, d] = (t * (2.0 / 3.0) + 0.7 * d + 0.2 * s) % np.pi
    _, idx = pixel_tree(nside).query(x_all.reshape(-1, 3), workers=-1)
    return idx.reshape(nscan, ndet, ntod).astype(np.int32), psi


@functools.lru_cache(maxsize=3)
def _pointing(nside: int, nscan: int, ndet: int, ntod: int, fsamp: float,
              seed: int):
    """great_circle_scans, kept for the last three calls: two presets with
    the same scan configuration and seeds (tutorial_tod and tutorial_joint,
    three bands each) share their pointing, half of the simulator's time at
    nside 1024. Callers only read the arrays."""
    return great_circle_scans(nside, nscan, ndet, ntod, fsamp, seed)


def simulate_tod(nside: int, sky_maps, nscan=8, ndet=2, ntod=4096,
                 fsamp=10.0, gain0=1.0, sigma0=0.1, alpha=-1.5, fknee=0.3,
                 nu=30e9, pol=False, seed=0, dtype=torch.float64,
                 device=None):
    """Simulate a TodBlock from sky maps (S, npix) (array or tensor; used on
    the host in float64); the block goes to `device` (None: the CUDA card)
    in `dtype`, pix int32. The first 8 samples of every (scan, det) are
    flagged. Returns (TodBlock, truth dict of the parameters and the
    float64 host arrays ncorr, s_sky, s_orb)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed + 1)
    pix, psi = _pointing(nside, nscan, ndet, ntod, fsamp, seed)
    vsun = rng.standard_normal((nscan, 3)) * 1e4 + np.array([0, 3e4, 0])
    pvec = torch.as_tensor(healpix.pix2vec_ring(nside))
    sky = torch.as_tensor(sky_maps).to("cpu", torch.float64)
    pix_t = torch.as_tensor(pix)
    s_sky = project_sky(sky, pix_t, torch.as_tensor(psi), pol).numpy()
    s_orb = orbital_dipole(torch.as_tensor(vsun), pvec, nu, pix_t).numpy()

    # 1/f + white noise via FFT shaping
    freqs = np.fft.rfftfreq(ntod, 1.0 / fsamp)
    S = np.zeros_like(freqs)
    S[1:] = (freqs[1:] / fknee) ** alpha
    wn = rng.standard_normal((nscan, ndet, ntod))
    nf = np.fft.rfft(rng.standard_normal((nscan, ndet, ntod)), axis=-1)
    ncorr = np.fft.irfft(nf * np.sqrt(S), n=ntod, axis=-1) * sigma0
    tod = gain0 * (s_sky + s_orb) + ncorr + sigma0 * wn

    mask = np.ones((nscan, ndet, ntod))
    mask[:, :, :8] = 0.0       # flagged edges
    t = lambda a: torch.as_tensor(a).to(device, dtype)
    # (the pointing is the cache's: the block takes copies)
    block = TodBlock(tod=t(tod), pix=torch.tensor(pix, device=device),
                     psi=torch.tensor(psi, device=device, dtype=dtype),
                     mask=t(mask), vsun=t(vsun), fsamp=fsamp)
    truth = dict(gain=gain0, sigma0=sigma0, alpha=alpha, fknee=fknee,
                 ncorr=ncorr, s_sky=s_sky, s_orb=s_orb)
    return block, truth
