"""Differential-horn (WMAP-style) TOD: the data model, the simulator, the
CG mapmaker and one Gibbs pass (torch).

Counterpart of commander_tpu.tod.differential (process_WMAP_tod,
comm_tod_WMAP_mod.f90:142-485). Each detector measures the difference of
two horns,

  d_t = g [ (1 + x_im) s_A(t) - (1 - x_im) s_B(t) ] + n_t,
  s_X(t) = T[pix_X] + Q[pix_X] cos 2 psi_X + U[pix_X] sin 2 psi_X,

with a transmission imbalance x_im per detector. Each sample couples two
pixels, so the map is the CG solution of P^T N^-1 P m = P^T N^-1 d with the
diagonal hit-weight preconditioner, tol 1e-8 and maxiter 150 as the JAX
function has them.

The adjoint P^T sums each horn's samples per pixel without atomics: the
horn's pointing never changes, so its samples are sorted by pixel once per
block (DiffTodBlock.horns, tod/model.pixel_runs), and each application
gathers its weighted samples in that order and sums the runs of equal
pixels in float64 (torch.segment_reduce), where the JAX package adds with
.at[].add. Each pixel's sum runs in sample order, so a seeded pass gives the
same bits twice on the card.

Randomness: a torch.Generator, or the pass's draws ready-made
(diff_pass_draws gives their names and shapes; the parity tests replay the
JAX keys' draws).

The reference's simulation has no orbital dipole, but its pass puts the
horns' dipole difference into the gain template and takes it from the
calibrated data: the port copies both (ROADMAP queue 3 item 16).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cg import pcg
from ..utils.device import rand, randn, resolve_device
from . import model as M
from .process import TodConfig, _grids

F64 = torch.float64
MAPMAKER_TOL = 1e-8
MAPMAKER_MAXITER = 150


class Horn(NamedTuple):
    """One horn's pointing as the mapmaker uses it: pix (Ns, Nd, Nt) int32,
    cos 2psi and sin 2psi in the data dtype, the samples sorted by pixel
    (runs) and cos 2psi, sin 2psi in that order in float64."""
    pix: torch.Tensor
    cos2: torch.Tensor
    sin2: torch.Tensor
    runs: M.PixelRuns
    cos2_sorted: torch.Tensor
    sin2_sorted: torch.Tensor


def make_horn(pix: torch.Tensor, psi: torch.Tensor, npix: int) -> Horn:
    """A Horn from a pointing; sorts the samples by pixel (one host read)."""
    runs = M.pixel_runs(pix, npix)
    c, s = torch.cos(2.0 * psi), torch.sin(2.0 * psi)
    order = runs.order.to(torch.int64)
    return Horn(pix, c, s, runs, c.reshape(-1)[order].to(F64),
                s.reshape(-1)[order].to(F64))


@dataclasses.dataclass(frozen=True)
class DiffTodBlock:
    """Differential-horn TOD block: per (scan, det, t) horn A's and horn
    B's pointing and the differenced timestream."""
    tod: torch.Tensor     # (Ns, Nd, Nt)
    pixA: torch.Tensor    # (Ns, Nd, Nt) int32
    psiA: torch.Tensor
    pixB: torch.Tensor
    psiB: torch.Tensor
    mask: torch.Tensor
    vsun: torch.Tensor    # (Ns, 3)
    fsamp: float = 10.0

    @property
    def nscan(self):
        return self.tod.shape[0]

    @property
    def ndet(self):
        return self.tod.shape[1]

    @property
    def ntod(self):
        return self.tod.shape[2]

    def horns(self, npix: int) -> tuple:
        """(Horn A, Horn B), made at the first call and kept on the block
        (its pointing never changes)."""
        cache = self.__dict__.setdefault("_horns", {})
        if npix not in cache:
            cache[npix] = (make_horn(self.pixA, self.psiA, npix),
                           make_horn(self.pixB, self.psiB, npix))
        return cache[npix]

    def to(self, device, dtype=None) -> "DiffTodBlock":
        """The block on `device`, its float arrays in `dtype` (default: as
        they are); the pixels stay int32."""
        f = lambda x: x.to(device, dtype or x.dtype)
        return DiffTodBlock(tod=f(self.tod), pixA=self.pixA.to(device),
                            psiA=f(self.psiA), pixB=self.pixB.to(device),
                            psiB=f(self.psiB), mask=f(self.mask),
                            vsun=f(self.vsun), fsamp=self.fsamp)


def _horn_signal(maps, pix, cos2, sin2, pol: bool):
    s = M._gather(maps[0], pix)
    if pol and maps.shape[0] >= 3:
        s = s + M._gather(maps[1], pix) * cos2 \
            + M._gather(maps[2], pix) * sin2
    return s


def _project(maps, hA, hB, x_im, pol: bool):
    return (1.0 + x_im) * _horn_signal(maps, hA.pix, hA.cos2, hA.sin2, pol) \
        - (1.0 - x_im) * _horn_signal(maps, hB.pix, hB.cos2, hB.sin2, pol)


def _horn_sums(h: Horn, w: torch.Tensor, k: int) -> torch.Tensor:
    """(k, npix) float64 per-pixel sums of w, and with k = 3 of w cos 2psi
    and w sin 2psi, over one horn's samples (each pixel's run in sample
    order)."""
    runs = h.runs
    ws = w.reshape(-1).index_select(0, runs.order).to(F64)
    out = torch.empty((k, runs.offsets.numel() - 1), dtype=F64,
                      device=ws.device)
    for p0, p1, s0, s1 in runs.chunks:
        wc = ws[s0:s1]
        planes = [wc] if k == 1 else [wc, wc * h.cos2_sorted[s0:s1],
                                      wc * h.sin2_sorted[s0:s1]]
        out[:, p0:p1] = torch.segment_reduce(
            torch.stack(planes, dim=1), "sum",
            offsets=runs.offsets[p0:p1 + 1] - s0, axis=0, unsafe=True).T
    return out


def _project_T(tod_w, hA, hB, x_im, pol: bool):
    k = 3 if pol else 1
    return (_horn_sums(hA, (1.0 + x_im) * tod_w, k)
            - _horn_sums(hB, (1.0 - x_im) * tod_w, k)).to(tod_w.dtype)


def project_diff(maps, pixA, psiA, pixB, psiB, x_im, pol: bool):
    """maps (k, npix) -> differential TOD (..., Nt). x_im: a scalar, or
    per (scan, det) with a trailing axis of 1."""
    hA = (pixA, torch.cos(2.0 * psiA), torch.sin(2.0 * psiA))
    hB = (pixB, torch.cos(2.0 * psiB), torch.sin(2.0 * psiB))
    return (1.0 + x_im) * _horn_signal(maps, *hA, pol) \
        - (1.0 - x_im) * _horn_signal(maps, *hB, pol)


def project_diff_T(tod_w, pixA, psiA, pixB, psiB, x_im, npix: int,
                   pol: bool, horns: tuple | None = None):
    """The adjoint of project_diff: weighted TOD -> (k, npix) in tod_w's
    dtype, each horn's samples summed per pixel in float64 on pixel-sorted
    runs. horns: (Horn A, Horn B) of this pointing (DiffTodBlock.horns),
    made here when not given."""
    hA, hB = horns if horns is not None else (make_horn(pixA, psiA, npix),
                                             make_horn(pixB, psiB, npix))
    return _project_T(tod_w, hA, hB, x_im, pol)


def _hit_weights(hA, hB, w, x_im):
    """(npix,) float64 accumulated weights (1 + x)^2 w over horn A and
    (1 - x)^2 w over horn B: the mapmaker's diagonal."""
    return (_horn_sums(hA, (1.0 + x_im) ** 2 * w, 1)[0]
            + _horn_sums(hB, (1.0 - x_im) ** 2 * w, 1)[0])


def solve_diff_map(tod, pixA, psiA, pixB, psiB, x_im, mask, inv_var,
                   npix: int, pol: bool, tol: float = MAPMAKER_TOL,
                   maxiter: int = MAPMAKER_MAXITER,
                   horns: tuple | None = None):
    """CG mapmaker for differential data: returns (maps (k, npix), the
    CGResult, hits (npix,) bool). inv_var: per (scan, det) white-noise
    weight; x_im a scalar. The operator is two gathers and the two horns'
    run sums per application; the preconditioner is the diagonal of
    per-pixel accumulated weights (half of it for Q and U)."""
    hA, hB = horns if horns is not None else (make_horn(pixA, psiA, npix),
                                             make_horn(pixB, psiB, npix))
    w = mask * inv_var[..., None]

    def apply_A(m):
        return _project_T(_project(m, hA, hB, x_im, pol) * w, hA, hB, x_im,
                          pol)

    b = _project_T(tod * w, hA, hB, x_im, pol)
    diagT = _hit_weights(hA, hB, w, x_im).to(tod.dtype)
    k = 3 if pol else 1
    diag = torch.stack([diagT] + [0.5 * diagT] * (k - 1))
    hits = diagT > 0
    pos = diag > 0
    safe = torch.clamp(diag, min=1e-30)

    def M_inv(r):
        return torch.where(pos, r / safe, 0.0)

    res = pcg(apply_A, b, M_inv=M_inv, tol=tol, maxiter=maxiter)
    return res.x * hits[None, :], res, hits


def sample_imbalance(tod, s_A, s_B, mask, sigma0, prior_std: float = 0.05,
                     generator: torch.Generator | None = None, eta=None):
    """Draw x_im | d, sky: u = s_A + s_B, x_im ~ N(<u, d>/<u, u>, 1/<u,u>)
    per (scan, det) with white-noise weights and the N(0, prior_std^2)
    prior (the reference samples x_im in its gain block). tod: the
    calibrated residual d - (s_A - s_B). eta: optional (Ns, Nd) standard
    normals. Returns (Ns, Nd) in tod's dtype."""
    u = s_A + s_B
    w = mask / torch.clamp(sigma0[..., None] ** 2, min=1e-30)
    num = M._sum64(u * tod * w, -1)
    den = M._sum64(u * u * w, -1) + 1.0 / prior_std ** 2
    mean = num / torch.clamp(den, min=1e-30)
    std = 1.0 / torch.sqrt(torch.clamp(den, min=1e-30))
    eta = M._normal(eta, mean.shape, tod, generator)
    return (mean + std * eta).to(tod.dtype)


def simulate_tod_diff(nside: int, sky_maps, nscan=4, ndet=2, ntod=2048,
                      fsamp=10.0, gain0=1.0, sigma0=0.5, alpha=-1.5,
                      fknee=0.1, x_im0=0.01, pol=False, seed=0,
                      dtype=torch.float64, device=None):
    """Synthetic differential TOD with the JAX simulator's numpy draws in
    its order: horn A on the great-circle scans of `seed`, horn B on those
    of seed + 1000, tod = gain0 s + n_corr + white noise (no orbital
    dipole), the first 8 samples of every (scan, det) flagged. sky_maps
    (S, npix) is used on the host in float64; the block goes to `device`
    (None: the CUDA card) in `dtype`. Returns (DiffTodBlock, truth dict of
    the parameters and the float64 host arrays ncorr and s)."""
    from .sim import _pointing

    device = resolve_device(device)
    rng = np.random.default_rng(seed + 7)
    pixA, psiA = _pointing(nside, nscan, ndet, ntod, fsamp, seed)
    pixB, psiB = _pointing(nside, nscan, ndet, ntod, fsamp, seed + 1000)
    vsun = rng.standard_normal((nscan, 3)) * 1e4 + np.array([0, 3e4, 0])
    sky = torch.as_tensor(sky_maps).to("cpu", F64).numpy()

    def horn(pix, psi):
        # (numpy's cosine gives the JAX simulator's bits on the host)
        h = sky[0][pix]
        if pol and sky.shape[0] >= 3:
            h = h + sky[1][pix] * np.cos(2 * psi) \
                + sky[2][pix] * np.sin(2 * psi)
        return h
    s = (1.0 + x_im0) * horn(pixA, psiA) - (1.0 - x_im0) * horn(pixB, psiB)
    freqs = np.fft.rfftfreq(ntod, 1.0 / fsamp)
    S = np.zeros_like(freqs)
    S[1:] = (freqs[1:] / fknee) ** alpha
    nf = np.fft.rfft(rng.standard_normal((nscan, ndet, ntod)), axis=-1)
    ncorr = np.fft.irfft(nf * np.sqrt(S), n=ntod, axis=-1) * sigma0
    tod = gain0 * s + ncorr + sigma0 * rng.standard_normal(s.shape)
    mask = np.ones_like(tod)
    mask[:, :, :8] = 0.0
    t = lambda a: torch.as_tensor(a).to(device, dtype)
    # (the pointing is the cache's: the block takes copies)
    block = DiffTodBlock(tod=t(tod), pixA=torch.tensor(pixA, device=device),
                         psiA=torch.tensor(psiA, device=device, dtype=dtype),
                         pixB=torch.tensor(pixB, device=device),
                         psiB=torch.tensor(psiB, device=device, dtype=dtype),
                         mask=t(mask), vsun=t(vsun), fsamp=fsamp)
    truth = dict(gain=gain0, sigma0=sigma0, alpha=alpha, fknee=fknee,
                 x_im=x_im0, ncorr=ncorr, s=s)
    return block, truth


def diff_pass_draws(cfg: TodConfig, block: DiffTodBlock,
                    generator: torch.Generator) -> dict:
    """Every draw of one process_tod_diff call, from `generator`, on the
    block's device: standard normals in the data dtype for the gain ("gain"
    (Ns, Nd)), n_corr ("ncorr": (re, im) of (Ns, Nd, Nt//2 + 1)) and the
    imbalance ("x_im" (Ns, Nd)); float64 for the PSD ("psd_gamma" (Ns, Nd)
    Gamma(npair/2, 1) variates, "psd_u" (Ns, Nd) uniforms)."""
    Ns, Nd, Nt = block.tod.shape
    dev, dt = block.tod.device, block.tod.dtype
    n = lambda *shape: randn(shape, generator, dt, dev)
    m2 = block.mask[..., 1:] * block.mask[..., :-1]
    npair = torch.clamp(torch.sum(m2, -1, dtype=F64), min=1.0)
    return {"gain": n(Ns, Nd),
            "psd_gamma": M.gamma_marsaglia_tsang(generator, npair / 2.0),
            "psd_u": rand((Ns, Nd), generator, F64, dev),
            "ncorr": (n(Ns, Nd, Nt // 2 + 1), n(Ns, Nd, Nt // 2 + 1)),
            "x_im": n(Ns, Nd)}


def process_tod_diff(cfg: TodConfig, block: DiffTodBlock, state: M.TodState,
                     sky_maps: torch.Tensor, pix_vec: torch.Tensor,
                     generator: torch.Generator | None = None,
                     draws: dict | None = None):
    """One differential-TOD Gibbs pass, in the JAX function's order: the
    per-scan gain (boxcar-smoothed), the noise PSD, n_corr, the imbalance
    x_im, the CG mapmaker on calibrated n_corr-subtracted data with the
    orbital dipole difference removed, the diagonal rms. sky_maps (k, npix)
    is the band sky. draws: optional diff_pass_draws-shaped dict used in
    place of the generator's. Returns (new TodState, products: map, rms (k,
    npix), hits (npix,), x_im (Ns, Nd), cg_iters, cg_relres)."""
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the pass's draws")
        draws = diff_pass_draws(cfg, block, generator)
    npix = 12 * cfg.nside * cfg.nside
    hA, hB = block.horns(npix)
    mask, dt = block.mask, block.tod.dtype

    s_orbA = M.orbital_dipole(block.vsun, pix_vec, cfg.nu, block.pixA)
    s_orbB = M.orbital_dipole(block.vsun, pix_vec, cfg.nu, block.pixB)
    d_orb = s_orbA - s_orbB
    s_ref = _project(sky_maps, hA, hB, 0.0, cfg.pol) + d_orb

    gain_raw = M.sample_gain_perscan(block.tod - state.n_corr, s_ref, mask,
                                     state.sigma0, eta=draws["gain"])
    gain = M.smooth_gain(gain_raw, cfg.gain_smooth_window)
    resid = block.tod - gain[..., None] * s_ref
    del s_ref
    ag, fg = (g.to(dt) for g in _grids(cfg.alpha_grid, cfg.fknee_grid,
                                       str(resid.device)))
    sigma0, alpha, fknee = M.sample_noise_psd(
        resid, mask, block.fsamp, ag, fg, gamma=draws["psd_gamma"],
        u=draws["psd_u"])
    n_corr = M.sample_ncorr(resid, mask, sigma0, alpha, fknee, block.fsamp,
                            eta=draws["ncorr"])
    del resid

    # the imbalance given the horn signals
    sA = _horn_signal(sky_maps, hA.pix, hA.cos2, hA.sin2, cfg.pol) + s_orbA
    sB = _horn_signal(sky_maps, hB.pix, hB.cos2, hB.sin2, cfg.pol) + s_orbB
    del s_orbA, s_orbB
    calib = (block.tod - n_corr) / torch.clamp(gain[..., None], min=1e-30)
    x_im = sample_imbalance(calib - (sA - sB), sA, sB, mask, sigma0,
                            eta=draws["x_im"])
    del sA, sB
    x_im_mean = torch.mean(x_im)

    # the map from calibrated, n_corr-subtracted data, the orbital dipole
    # difference removed
    calib = calib - d_orb
    inv_var = gain ** 2 / torch.clamp(sigma0 ** 2, min=1e-30)
    maps, res, hits = solve_diff_map(calib, block.pixA, block.psiA,
                                     block.pixB, block.psiB, x_im_mean,
                                     mask, inv_var, npix, cfg.pol,
                                     horns=(hA, hB))
    # the diagonal rms from the accumulated weights
    diag = _hit_weights(hA, hB, mask * inv_var[..., None],
                        x_im_mean).to(dt)
    rms = torch.where(diag > 0, 1.0 / torch.sqrt(torch.clamp(diag,
                                                              min=1e-30)),
                      0.0)
    rms = torch.stack([rms] + [rms * np.sqrt(2.0)] * (maps.shape[0] - 1))
    new_state = M.TodState(gain=gain, sigma0=sigma0, alpha=alpha,
                           fknee=fknee, n_corr=n_corr)
    return new_state, dict(map=maps, rms=rms, hits=hits, x_im=x_im,
                           cg_iters=res.iters, cg_relres=res.rel_res)
