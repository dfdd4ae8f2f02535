"""Nonlinear (spectral-index) sampling: grid inversion samplers and MH
(torch).

Counterpart of commander_tpu.sampling.specind. The conditional for one
component c with parameter theta is
  lnL(theta) = -1/2 sum_b invN_bp (r_bp - F_b(theta) a_p)^2 + ln pi(theta)
where r is the residual with component c's signal INCLUDED (data minus all
other components), a_p the component amplitude map and F_b the
band-integrated SED. lnL is evaluated on a grid and a draw is taken by
inverting the trapezoid CDF (one draw per pixel, per region or for the whole
sky), or a smooth index field is moved by Metropolis steps. lnL types:
chisq, ridge and marginal (the component amplitude marginalized analytically
per pixel) and prior (the range-truncated prior alone).

Precision. The band integrals F_b(theta) are evaluated in float64 and cast
to the data dtype. The elementwise work runs in the data dtype; every sum
over pixels accumulates in float64, and lnL - max, the CDF and its inversion
are float64: a full-sky total over 1e8 float32 values is ~1e8-1e9, where
float32 has a spacing of 8-64, while the draw depends on differences of O(1)
between grid points.

Memory. The per-pixel grid is (P, G) with (B, S, P, G) intermediates, tens
of GB at nside 1024 and G = 64. The full-sky sampler never builds it (one
grid point at a time over (B, S, P) temporaries). The per-pixel and region
samplers walk the pixels in chunks of CHUNK_BYTES // (B S G itemsize)
pixels, so that the largest intermediate of a chunk stays at CHUNK_BYTES;
the values are those of the unchunked grid.

Randomness. Every sampler takes `generator` (a torch.Generator on the data's
device) or its random inputs ready-made (`u`, `draws`), so that a run can be
held to the reference's own draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..instrument.bandpass import Bandpass
from ..model.mixing import DiffuseComponent, mixing_element
from ..sphere import sht
from ..sphere.alm import random_alm_white, real_m0
from ..utils.device import rand, randn, resolve_device

# largest intermediate of one pixel chunk of the per-pixel grid, in bytes
CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class SpecIndConfig:
    """Sampling config for one spectral parameter."""
    grid_min: float
    grid_max: float
    ngrid: int = 96
    prior_mean: Optional[float] = None
    prior_std: Optional[float] = None
    # chisq | ridge | marginal | prior
    lnl_type: str = "chisq"

    def grid(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """The (ngrid,) grid on `device` (None: the CUDA card)."""
        return torch.linspace(self.grid_min, self.grid_max, self.ngrid,
                              dtype=dtype, device=resolve_device(device))


def _lnprior(cfg: SpecIndConfig, grid: torch.Tensor) -> torch.Tensor:
    if cfg.prior_mean is None or cfg.prior_std is None:
        return torch.zeros_like(grid)
    return -0.5 * torch.square((grid - cfg.prior_mean) / cfg.prior_std)


def _beam_ratio(amp_pix, amp_band):
    """(B, P): the beamed / common amplitude shape ratio that scales each
    band's template for ridge / marginal (1 where the amplitude vanishes and
    where all beams agree)."""
    ok = torch.abs(amp_pix[None, 0]) > 1e-30
    safe = torch.where(ok, amp_pix[None, 0], torch.ones_like(amp_pix[None, 0]))
    return torch.where(ok, amp_band[:, 0] / safe,
                       torch.ones_like(amp_band[:, 0]))


def _marginal_lnl(lnl_type, MNd, MNM):
    """Amplitude-marginalized pixel likelihood from MNd = M^T N^-1 d and
    MNM = M^T N^-1 M over the flattened (band, Stokes) axis with diagonal
    noise: 1/2 MNd^2 / MNM [+ 1/2 log MNM for 'marginal']."""
    zero = torch.zeros_like(MNM)
    safe = torch.clamp(MNM, min=1e-300)
    lnl = torch.where(MNM > 0, 0.5 * MNd * MNd / safe, zero)
    if lnl_type == "marginal":
        lnl = lnl + torch.where(MNM > 0, 0.5 * torch.log(safe), zero)
    return lnl


def _grid_lnL_pixel(comp: DiffuseComponent, bps: Sequence[Bandpass], cfg,
                    res, amp_pix, inv_rms2, theta_other, which: int,
                    amp_band=None) -> torch.Tensor:
    """lnL on the grid for every pixel: (P, G), in the data dtype.

    res: (B, S, P) residual incl. this comp; amp_pix: (S, P) comp amplitude
    map; inv_rms2: (B, S, P); theta_other: the component's full theta tuple
    (slot `which` is replaced by grid values; the other slots are floats,
    0-d tensors or (P,) maps).

    amp_band (optional): (B, S, P) per-band amplitude maps, the component
    seen through each band's beam, Y(b_l a), for a beam-consistent
    evaluation. The chisq path uses amp_band directly; ridge / marginal
    scale their band templates by the beamed / common shape ratio.
    """
    dt, dev = res.dtype, res.device
    grid = cfg.grid(torch.float64, dev)
    P, G = res.shape[-1], grid.shape[0]
    lnl_type = cfg.lnl_type or "chisq"
    prior = _lnprior(cfg, grid).to(dt)
    if lnl_type == "prior":
        return prior[None, :].expand(P, G)

    # maps broadcast as (P, 1) against the (1, G) grid
    def other(t):
        return t[:, None] if isinstance(t, torch.Tensor) and t.ndim > 0 else t

    th = tuple(grid[None, :] if i == which else other(t)
               for i, t in enumerate(theta_other))
    # (B, 1 or P, G): left unexpanded where every other theta is a scalar
    Fg = torch.stack([mixing_element(comp, bp, th, device=dev)
                      for bp in bps]).to(dt)
    if lnl_type in ("ridge", "marginal"):
        if amp_band is not None:
            Fg = Fg * _beam_ratio(amp_pix, amp_band)[..., None]
        w_d = torch.sum(inv_rms2 * res, dim=1)[..., None]     # (B, P, 1)
        w_m = torch.sum(inv_rms2, dim=1)[..., None]
        MNd = torch.sum(Fg * w_d, dim=0)
        MNM = torch.sum(Fg * Fg * w_m, dim=0)
        lnl = _marginal_lnl(lnl_type, MNd, MNM)
    else:
        # model_bspg = F_bpg a_(b)sp; chi2 over b, s. amp_band carries the
        # per-band beamed amplitude when the beams differ
        a = amp_pix[None] if amp_band is None else amp_band
        model = Fg[:, None, :, :] * a[..., None]
        lnl = -0.5 * torch.sum(inv_rms2[..., None]
                               * torch.square(res[..., None] - model),
                               dim=(0, 1))
    return lnl + prior[None, :]


def _cdf_invert(u, lnl, grid) -> torch.Tensor:
    """Batched inversion sampling along the last axis of lnl (..., G), in
    float64: normalize lnL, build the CDF by trapezoid weights, invert the
    uniform draws u (shape lnl.shape[:-1]) by linear interpolation."""
    lnl = lnl.to(torch.float64)
    grid = grid.to(torch.float64)
    lnl = lnl - torch.max(lnl, dim=-1, keepdim=True).values
    p = torch.exp(lnl)
    dx = grid[1] - grid[0]
    # trapezoid cumulative: c_i = sum_{j<i} (p_j + p_{j+1})/2
    mid = 0.5 * (p[..., 1:] + p[..., :-1])
    cdf = torch.cumsum(mid, dim=-1) * dx
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    cdf = cdf / torch.clamp(cdf[..., -1:], min=1e-300)
    # u = 0 (which a generator can return) would fall before the support's
    # lower end, where the CDF is flat, and come out as grid[0]
    u = torch.clamp(u.to(torch.float64), min=1e-300).reshape(
        lnl.shape[:-1] + (1,))
    # first index with cdf >= u, then linear interpolation
    idx = torch.sum(cdf < u, dim=-1) - 1
    idx = torch.clamp(idx, 0, grid.shape[0] - 2)
    c0 = torch.gather(cdf, -1, idx[..., None])[..., 0]
    c1 = torch.gather(cdf, -1, idx[..., None] + 1)[..., 0]
    frac = (u[..., 0] - c0) / torch.clamp(c1 - c0, min=1e-300)
    # (a 0-d idx used as an index itself would be read back to the host)
    lo = grid[idx.reshape(-1)].reshape(idx.shape)
    return lo + torch.clamp(frac, 0.0, 1.0) * dx


def _uniform(shape, like: torch.Tensor, generator, u):
    """The uniform draws of an inversion: `u` as given, else from the
    generator (float64 on the data's device)."""
    if u is not None:
        return torch.as_tensor(u, device=like.device)
    if generator is None:
        raise ValueError("pass a torch.Generator or the uniform draws u")
    return rand(shape, generator, torch.float64, like.device)


def _pixel_chunks(res, ngrid: int, nregion: int = 0):
    """Slices over the pixel axis such that the largest intermediate of one
    chunk, (B, S, chunk, G) in the data dtype or the (R, chunk) float64
    region membership, stays at CHUNK_BYTES."""
    B, S, P = res.shape
    per_pixel = max(B * S * ngrid * res.element_size(), 8 * nregion,
                    8 * ngrid)
    step = max(1, CHUNK_BYTES // per_pixel)
    return [slice(p0, min(P, p0 + step)) for p0 in range(0, P, step)]


def _at_pixels(sl, theta_other, *maps):
    """The pixel slice sl of every map-valued theta and of each (..., P)
    map (None passes through)."""
    th = tuple(t[sl] if isinstance(t, torch.Tensor) and t.ndim > 0 else t
               for t in theta_other)
    return th, tuple(None if m is None else m[..., sl] for m in maps)


def sample_specind_pixel(comp: DiffuseComponent, bps, cfg: SpecIndConfig,
                         res, amp_pix, inv_rms2, theta_other, which: int = 0,
                         amp_band=None, generator=None, u=None):
    """Per-pixel draw of one spectral parameter: returns the (P,) float64
    theta map. u: optional (P,) uniforms used in place of the generator's."""
    P = res.shape[-1]
    u = _uniform((P,), res, generator, u)
    grid = cfg.grid(torch.float64, res.device)
    out = []
    for sl in _pixel_chunks(res, cfg.ngrid):
        th, (r, a, n, ab) = _at_pixels(sl, theta_other, res, amp_pix,
                                       inv_rms2, amp_band)
        lnl = _grid_lnL_pixel(comp, bps, cfg, r, a, n, th, which,
                              amp_band=ab)
        out.append(_cdf_invert(u[sl], lnl, grid))
    return torch.cat(out)


def _grid_lnL_total(comp, bps, cfg: SpecIndConfig, res, amp_pix, inv_rms2,
                    theta_other, which: int, amp_band=None) -> torch.Tensor:
    """Pixel-summed lnL on the grid: (G,) float64, one grid point at a time.

    Equal to _grid_lnL_pixel(...).sum(0) with the Gaussian prior added once
    (not once per pixel), without the (B, P, G) intermediates: one grid
    point costs (B, S, P) temporaries. The pixel sums accumulate in float64.
    No value is read back to the host."""
    dt, dev = res.dtype, res.device
    grid = cfg.grid(torch.float64, dev)
    lnl_type = cfg.lnl_type or "chisq"
    if lnl_type == "prior":
        return _lnprior(cfg, grid)
    G = grid.shape[0]
    scalar_others = not any(isinstance(t, torch.Tensor) and t.ndim > 0
                            for i, t in enumerate(theta_other) if i != which)
    if scalar_others:
        # every band's F on the whole grid at once: (B, G)
        th = tuple(grid if i == which else t
                   for i, t in enumerate(theta_other))
        Fg = torch.stack([mixing_element(comp, bp, th, device=dev)
                          for bp in bps]).to(dt)

    def F_at(g):
        """(B, 1) or (B, P): the mixing column at grid point g."""
        if scalar_others:
            return Fg[:, g, None]
        th = tuple(grid[g] if i == which else t
                   for i, t in enumerate(theta_other))
        return torch.stack([mixing_element(comp, bp, th, device=dev)
                            for bp in bps]).to(dt)

    marginal = lnl_type in ("ridge", "marginal")
    if marginal:
        ratio = None if amp_band is None else _beam_ratio(amp_pix, amp_band)
        w_d = torch.sum(inv_rms2 * res, dim=1)               # (B, P)
        w_m = torch.sum(inv_rms2, dim=1)
    else:
        a = amp_pix[None] if amp_band is None else amp_band   # (1|B, S, P)
    out = []
    for g in range(G):
        F = F_at(g)
        if marginal:
            if ratio is not None:
                F = F * ratio
            MNd = torch.sum(F * w_d, dim=0)
            MNM = torch.sum(F * F * w_m, dim=0)
            out.append(torch.sum(_marginal_lnl(lnl_type, MNd, MNM),
                                 dtype=torch.float64))
        else:
            d = res - F[:, None, :] * a
            out.append(-0.5 * torch.sum(d.square_().mul_(inv_rms2),
                                        dtype=torch.float64))
    return torch.stack(out) + _lnprior(cfg, grid)


def sample_specind_fullsky(comp, bps, cfg: SpecIndConfig, res, amp_pix,
                           inv_rms2, theta_other, which: int = 0,
                           amp_band=None, generator=None, u=None):
    """Single global draw of one spectral parameter (0-d float64 tensor).
    u: optional 0-d uniform used in place of the generator's."""
    lnl_tot = _grid_lnL_total(comp, bps, cfg, res, amp_pix, inv_rms2,
                              theta_other, which, amp_band=amp_band)
    return _cdf_invert(_uniform((), res, generator, u), lnl_tot,
                       cfg.grid(torch.float64, res.device))


def sample_specind_regions(comp, bps, cfg: SpecIndConfig, res, amp_pix,
                           inv_rms2, theta_other, region_of_pix, nregion,
                           which: int = 0, generator=None, u=None):
    """Pixel-region draw: one theta per region. region_of_pix: (P,) integer
    region id per pixel. Returns (theta_reg (R,), theta_map (P,)).

    The region sums are products of a (R, chunk) float64 membership matrix
    with the chunk's (chunk, G) grid, added chunk by chunk in a fixed order:
    no float atomics (index_add_ on a card has them), so two runs give the
    same bits. u: optional (R,) uniforms."""
    dev = res.device
    rop = torch.as_tensor(region_of_pix, device=dev).to(torch.int64)
    ids = torch.arange(nregion, device=dev)[:, None]
    lnl_reg = torch.zeros((nregion, cfg.ngrid), dtype=torch.float64,
                          device=dev)
    for sl in _pixel_chunks(res, cfg.ngrid, nregion):
        th, (r, a, n) = _at_pixels(sl, theta_other, res, amp_pix, inv_rms2)
        lnl = _grid_lnL_pixel(comp, bps, cfg, r, a, n, th, which)
        member = (rop[sl][None, :] == ids).to(torch.float64)
        lnl_reg = lnl_reg + member @ lnl.to(torch.float64)
    theta_reg = _cdf_invert(_uniform((nregion,), res, generator, u), lnl_reg,
                            cfg.grid(torch.float64, dev))
    return theta_reg, theta_reg[rop]


def _map_lnL(comp, bps, res, amp_eff, inv_rms2, theta_other, which,
             theta_map):
    """-1/2 chi^2 of the map model with pixel mixing evaluated at
    theta_map, summed in float64."""
    th = tuple(theta_map if i == which else v
               for i, v in enumerate(theta_other))
    Fg = torch.stack([mixing_element(comp, bp, th, device=res.device)
                      for bp in bps]).to(res.dtype)            # (B, P)
    d = res - Fg[:, None, :] * amp_eff
    return -0.5 * torch.sum(inv_rms2 * d * d, dtype=torch.float64)


def sample_specind_alm(comp, bps, cfg: SpecIndConfig, plan, res, amp_pix,
                       inv_rms2, theta_other, theta_alm, which: int = 0,
                       lmax_ind: int = 2, step: float = 0.05,
                       nsteps: int = 3, amp_band=None, generator=None,
                       draws=None):
    """alm-space Metropolis sampler for a smooth spectral-index FIELD: theta
    is parametrized by low-ell alms, proposals perturb the alms, and the
    likelihood is the map chi^2 with pixel mixing at theta(p) = Y theta_alm,
    plus the Gaussian prior (if configured) acting on the map.

    theta_alm: (lmax_ind+1, lmax_ind+1) complex alms of the sampled
    parameter; theta_other: the component's full parameter tuple (the
    sampled slot is replaced by the synthesized map). draws: optional
    {"eta": (nsteps, nl_i, nl_i) white alm draws (random_alm_white), "u":
    (nsteps,) uniforms} used in place of the generator's. Returns
    (theta_alm', theta_map', n_accept). A host-level loop: the chain is
    short and sequential."""
    nl_i = lmax_ind + 1
    dev = res.device
    tri = torch.as_tensor(np.tril(np.ones((nl_i, nl_i))), device=dev)
    amp_eff = amp_pix[None] if amp_band is None else amp_band
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the draws")
        draws = {"eta": random_alm_white(generator, (nsteps, nl_i, nl_i),
                                         torch.float64, dev),
                 "u": rand(nsteps, generator, torch.float64, dev)}
    log_u = torch.log(torch.as_tensor(draws["u"])).tolist()

    def to_map(t_alm):
        pad = plan.lmax + 1 - nl_i
        return sht.alm2map(plan, torch.nn.functional.pad(
            t_alm, (0, pad, 0, pad)))

    def lnL(t_alm):
        theta_map = to_map(t_alm)
        lp = _map_lnL(comp, bps, res, amp_eff, inv_rms2, theta_other, which,
                      theta_map)
        if cfg.prior_mean is not None and cfg.prior_std is not None:
            lp = lp - 0.5 * torch.mean(torch.square(
                (theta_map - cfg.prior_mean) / cfg.prior_std))
        return float(lp)

    t = theta_alm
    ll = lnL(t)
    n_acc = 0
    for s in range(nsteps):
        prop = t + step * real_m0(torch.as_tensor(draws["eta"][s],
                                                  device=dev)) * tri
        ll_p = lnL(prop)
        if log_u[s] < ll_p - ll:
            t, ll = prop, ll_p
            n_acc += 1
    return t, to_map(t), n_acc


def sample_specind_alm_pixreg(comp, bps, cfg: SpecIndConfig, plan, res,
                              amp_pix, inv_rms2, theta_other, theta_reg,
                              region_of_pix, which: int = 0,
                              lmax_ind: int = 2, step: float = 0.05,
                              nsteps: int = 3, fwhm_postproc: float = 0.0,
                              fix_reg=None, reg_priors=None, generator=None,
                              draws=None):
    """alm-space MH with PIXEL-REGION means: proposals perturb the
    per-region values (frozen regions stay put), the field is the
    piecewise-constant region map, optionally smoothed with the postproc
    beam and clipped to the prior range, and the stored alms are its
    quadrature analysis; the MH chi^2 adds a Gaussian prior per region
    centered on reg_priors. Proposals outside the range are rejected
    outright.

    theta_reg: (R,) current region values; region_of_pix: (P,) integers.
    draws: optional {"delta": (nsteps, R) unit normals, "u": (nsteps,)
    uniforms} used in place of the generator's. Returns (theta_reg',
    theta_map', theta_alm', n_accept)."""
    nl_i = lmax_ind + 1
    dev = res.device
    t = torch.as_tensor(theta_reg, device=dev)
    rop = torch.as_tensor(region_of_pix, device=dev).to(torch.int64)
    fix = torch.zeros(t.shape, dtype=torch.bool, device=dev) \
        if fix_reg is None else torch.as_tensor(fix_reg, device=dev).bool()
    priors = torch.full_like(t, cfg.prior_mean if cfg.prior_mean is not None
                             else 0.0) if reg_priors is None \
        else torch.as_tensor(reg_priors, device=dev)
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the draws")
        draws = {"delta": randn((nsteps,) + tuple(t.shape), generator,
                                t.dtype, dev),
                 "u": rand(nsteps, generator, torch.float64, dev)}
    log_u = torch.log(torch.as_tensor(draws["u"])).tolist()

    def to_field(vals):
        th = vals[rop]
        if fwhm_postproc and fwhm_postproc > 0:
            th = sht.smooth_map(plan, th, fwhm_postproc)
        return torch.clamp(th, cfg.grid_min, cfg.grid_max)

    def lnL(vals):
        lp = _map_lnL(comp, bps, res, amp_pix[None], inv_rms2, theta_other,
                      which, to_field(vals))
        if cfg.prior_std is not None:
            lp = lp - 0.5 * torch.sum(torch.square(
                (vals - priors) / cfg.prior_std))
        return float(lp)

    ll = lnL(t)
    n_acc = 0
    for s in range(nsteps):
        delta = step * torch.as_tensor(draws["delta"][s], device=dev)
        prop = torch.where(fix, t, t + delta)
        if bool(torch.any((prop < cfg.grid_min) | (prop > cfg.grid_max))):
            continue
        ll_p = lnL(prop)
        if log_u[s] < ll_p - ll:
            t, ll = prop, ll_p
            n_acc += 1
    theta_map = to_field(t)
    t_alm = sht.map2alm(plan, theta_map)[..., :nl_i, :nl_i]
    return t, theta_map, t_alm, n_acc
