"""The per-band TOD Gibbs pass: gain -> noise PSD -> n_corr -> binned maps
(torch).

Counterpart of commander_tpu.tod.process (process_LFI_tod,
comm_tod_LFI_mod.f90:297-1137, reduced to its statistical core). Given the
current sky model at the band:
    1. project sky + orbital dipole to the TOD          (:401-418, :618)
    2. per-scan gain GLS, absolute and relative
       calibration, Wiener-smoothed deviations          (:688-742, :931-943)
    3. noise PSD (sigma0, alpha, fknee)                 (:750)
    4. correlated-noise draw n_corr                     (:744-748)
    5. per-scan chi^2 accept flags                      (compute_chisq)
    6. bin calibrated TOD -> map + rms + fluctuation    (:882-886, :1006)

The static terms beside the orbital dipole: the sidelobe term (sl_fmaps,
per-detector conviqt f-maps, read at sl_pix or the block's pixels:
tod/conviqt.py), the zodi slot (s_extra, tod/zodi.py) and the monopoles.
Randomness: a torch.Generator, or the pass's draws ready-made (pass_draws
gives their names and shapes).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import model as M
from .conviqt import conviqt_interp_dets
from ..utils.device import rand, randn

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class TodConfig:
    nside: int
    nu: float
    pol: bool = False
    gain_smooth_window: int = 5
    alpha_grid: tuple = tuple(np.linspace(-2.5, -0.5, 32).tolist())
    fknee_grid: tuple = tuple(np.geomspace(0.01, 2.0, 32).tolist())
    # generous: the per-scan chi^2 runs hot while (sigma0, n_corr) burn in
    chisq_reject_sigma: float = 25.0
    # exact Sherman-Morrison/Woodbury n_corr solve on the gaps in place of
    # the mean fill (get_ncorr_sm_cg, comm_tod_noise_mod.f90:308)
    ncorr_exact: bool = False
    ncorr_cg_iter: int = 15
    # per-detector monopoles (sample_mono, comm_tod_mapmaking_mod.f90:300)
    sample_mono: bool = False
    mono_nstep: int = 1000
    mono_sigma_prop: float = 0.03
    # port-only: the monopole draw leaves out the pixels whose Stokes block
    # is near singular (model.sample_mono; ROADMAP queue 3 item 4a)
    mono_guard: bool = False


@functools.lru_cache(maxsize=8)
def _grids(alpha_grid: tuple, fknee_grid: tuple, device: str):
    """The PSD grids as float64 tensors on `device`, made once (a copy from
    the host inside a pass would wait for the device)."""
    t = lambda g: torch.tensor(g, dtype=F64, device=device)
    return t(alpha_grid), t(fknee_grid)


def static_signal(cfg: TodConfig, block: M.TodBlock, pix_vec,
                  sl_fmaps=None, s_extra=None, mono=None, sl_pix=None):
    """Orbital dipole + sidelobe + zodi slot + per-det monopole: the signal
    terms that do not come from the sky model map
    (comm_tod_LFI_mod.f90:618-663). (Ns, Nd, Nt)."""
    return _add_templates(M.orbital_dipole(block.vsun, pix_vec, cfg.nu,
                                           block.pix), block, sl_fmaps,
                          s_extra, mono, sl_pix)


def _add_templates(s: torch.Tensor, block: M.TodBlock, sl_fmaps, s_extra,
                   mono, sl_pix) -> torch.Tensor:
    """s plus the sidelobe term (per detector, the gather and azimuthal
    Fourier sum at this pointing, at the sidelobe resolution's pixels if
    given), the zodi slot and the monopoles, where given."""
    if sl_fmaps is not None:
        s = s + conviqt_interp_dets(
            sl_fmaps, block.pix if sl_pix is None else sl_pix,
            block.psi).to(s.dtype)
    if s_extra is not None:
        s = s + s_extra
    if mono is not None:
        s = s + mono[None, :, None]
    return s


def pass_draws(cfg: TodConfig, block: M.TodBlock,
               generator: torch.Generator) -> dict:
    """Every draw of one process_tod call, from `generator`, on the block's
    device: standard normals in the data dtype for the gain ("gain" (Ns, Nd),
    "abscal" (), "relcal" (Nd,), "smooth" (re, im) of (Ns//2 + 1, Nd)) and
    n_corr ("ncorr": (re, im) of (Ns, Nd, Nt//2 + 1), or with ncorr_exact
    (d, r) of (Ns, Nd, Nt)); float64 for the PSD ("psd_gamma" (Ns, Nd)
    Gamma(npair/2, 1) variates, "psd_u" (Ns, Nd) uniforms), the map's
    fluctuation ("bin" (k, npix)) and, with sample_mono, "mono" (Nd - 1,)."""
    Ns, Nd, Nt = block.tod.shape
    dev, dt = block.tod.device, block.tod.dtype

    def n(*shape, dtype=dt):
        return randn(shape, generator, dtype, dev)

    nf = Ns // 2 + 1
    m2 = block.mask[..., 1:] * block.mask[..., :-1]
    npair = torch.clamp(torch.sum(m2, -1, dtype=F64), min=1.0)
    shp = (Ns, Nd, Nt) if cfg.ncorr_exact else (Ns, Nd, Nt // 2 + 1)
    d = {"gain": n(Ns, Nd), "abscal": n(), "relcal": n(Nd),
         "smooth": (n(nf, Nd), n(nf, Nd)),
         "psd_gamma": M.gamma_marsaglia_tsang(generator, npair / 2.0),
         "psd_u": rand((Ns, Nd), generator, F64, dev),
         "ncorr": (n(*shp), n(*shp))}
    if cfg.sample_mono:
        d["mono"] = n(Nd - 1, dtype=F64)
    d["bin"] = n(3 if cfg.pol else 1, 12 * cfg.nside ** 2, dtype=F64)
    return d


def process_tod(cfg: TodConfig, block: M.TodBlock, state: M.TodState,
                sky_maps: torch.Tensor, pix_vec: torch.Tensor,
                generator: torch.Generator | None = None,
                sl_fmaps=None, s_extra: torch.Tensor | None = None,
                mono: torch.Tensor | None = None, sl_pix=None,
                draws: dict | None = None):
    """One TOD Gibbs pass. Returns (new TodState, products dict).

    sky_maps: (nmaps, npix) current sky model at this band, or (Nd, nmaps,
    npix) per detector. pix_vec: (npix, 3) pixel unit vectors on the
    block's device. sl_fmaps: optional per-det conviqt f-maps (Nd, M+1, 2,
    npix_sl), the sidelobe term (comm_tod_LFI_mod.f90:633-646); sl_pix:
    optional (Ns, Nd, Nt) pixels at their resolution (the reference's
    ind2sl degrade, comm_tod_mod.f90:312), else block.pix. s_extra:
    optional fixed additive (Ns, Nd, Nt) signal (the zodi slot, :626-631).
    mono: optional per-det monopoles (Nd,). draws: optional
    pass_draws-shaped dict used in place of the generator's draws.
    products: map, rms, fluct (k, npix) in the data dtype, chi2, ndof,
    accept, g_abs, gain_raw, dg_det, and mono with cfg.sample_mono."""
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the pass's draws")
        draws = pass_draws(cfg, block, generator)
    npix = 12 * cfg.nside * cfg.nside
    dt = block.tod.dtype
    mask, sigma0 = block.mask, state.sigma0

    s_sky = M.project_sky(sky_maps, block.pix, block.psi, cfg.pol)
    s_orb = M.orbital_dipole(block.vsun, pix_vec, cfg.nu, block.pix)
    s_stat = _add_templates(s_orb, block, sl_fmaps, s_extra, mono, sl_pix)
    s_ref = s_sky + s_stat
    del s_sky

    # --- gain: g0 + Delta g_det + delta g_scan (comm_tod_gain_mod.f90) ---
    d_for_gain = block.tod - state.n_corr
    gain_raw = M.sample_gain_perscan(d_for_gain, s_ref, mask, sigma0,
                                     eta=draws["gain"])
    g_abs = M.sample_abscal(d_for_gain - gain_raw[..., None] * (s_ref - s_orb),
                            s_orb, mask, sigma0, eta=draws["abscal"])
    dg_det = M.sample_relcal(d_for_gain - g_abs * s_ref, s_ref, mask, sigma0,
                             eta=draws["relcal"])
    del d_for_gain, s_orb
    w_g = (torch.sum(s_ref * s_ref * mask, -1, dtype=F64)
           / torch.clamp(sigma0.to(F64) ** 2, min=1e-30))
    sigma_g = (1.0 / torch.sqrt(torch.clamp(w_g, min=1e-30))).to(dt)
    dev_g = gain_raw - g_abs - dg_det[None, :]
    sm = M.smooth_gain_wiener(dev_g, sigma_g, eta=draws["smooth"])
    gain = g_abs + dg_det[None, :] + (sm - torch.mean(sm, dim=0,
                                                      keepdim=True))

    # --- noise PSD from the full residual (sample differences suppress the
    # 1/f part), then n_corr with the fresh PSD ---
    resid = block.tod - gain[..., None] * s_ref
    del s_ref
    alpha_grid, fknee_grid = _grids(cfg.alpha_grid, cfg.fknee_grid,
                                    str(resid.device))
    sigma0, alpha, fknee = M.sample_noise_psd(
        resid, mask, block.fsamp, alpha_grid, fknee_grid,
        gamma=draws["psd_gamma"], u=draws["psd_u"])
    if cfg.ncorr_exact:
        n_corr = M.sample_ncorr_sm(resid, mask, sigma0, alpha, fknee,
                                   block.fsamp, n_iter=cfg.ncorr_cg_iter,
                                   draws=draws["ncorr"])
    else:
        n_corr = M.sample_ncorr(resid, mask, sigma0, alpha, fknee,
                                block.fsamp, eta=draws["ncorr"])

    # --- per-scan chi^2 and accept flags ---
    s02 = torch.clamp(sigma0.to(F64) ** 2, min=1e-30)
    chi2 = torch.sum((resid - n_corr) ** 2 * mask, -1, dtype=F64) / s02
    del resid
    ndof = torch.sum(mask, -1, dtype=F64)
    z = (chi2 - ndof) / torch.sqrt(2.0 * torch.clamp(ndof, min=1.0))
    accept = (torch.abs(z) < cfg.chisq_reject_sigma).to(dt)

    # --- mapmaking on calibrated, n_corr-subtracted data with every static
    # template removed ---
    n_for_map = n_corr
    if cfg.sample_mono:
        # remove the per-(scan, det) mean that the n_corr filter passes, so
        # that the DC reaches the monopole columns
        n_dc = (torch.sum(n_corr * mask, -1, keepdim=True, dtype=F64)
                / torch.clamp(torch.sum(mask, -1, keepdim=True, dtype=F64),
                              min=1.0)).to(dt)
        n_for_map = n_corr - n_dc
    calib = (block.tod - n_for_map) / torch.clamp(gain[..., None],
                                                  min=1e-30) - s_stat
    del s_stat, n_for_map
    inv_var = accept * gain ** 2 / torch.clamp(sigma0 ** 2, min=1e-30)
    runs = block.pixel_runs(npix)
    mono_new = mono
    if cfg.sample_mono:
        # bin without the monopole subtraction: the det columns absorb it and
        # sample_mono draws the total, warm-started at the current one
        calib_m = calib if mono is None else calib + mono[None, :, None]
        kst = 3 if cfg.pol else 1
        A_ext, b_ext = M.bin_tod_mono(calib_m, block.pix, block.psi, mask,
                                      inv_var, npix, cfg.pol, runs=runs)
        mono_new, mono_ok = M.sample_mono(
            A_ext, b_ext, kst, nstep=cfg.mono_nstep,
            sigma_prop=cfg.mono_sigma_prop, mono0=mono, eta=draws["mono"],
            guard=cfg.mono_guard)
        b_m = b_ext[:, :kst] - torch.einsum(
            "pkd,d->pk", A_ext[:, :kst, kst:], mono_new.to(F64))
        A = A_ext[:, :kst, :kst]
        A = M.pack_sym3(A) if kst == 3 else A[:, 0, 0][None]
        b = b_m.T
        mono_new = mono_new.to(dt)
    else:
        A, b = M.bin_tod(calib, block.pix, block.psi, mask, inv_var, npix,
                         cfg.pol, runs=runs)
    del calib
    m, rms, fluct = M.finalize_binned_map(A, b, eta=draws["bin"])

    new_state = M.TodState(gain=gain, sigma0=sigma0, alpha=alpha,
                           fknee=fknee, n_corr=n_corr)
    products = dict(map=m.to(dt), rms=rms.to(dt), fluct=fluct.to(dt),
                    chi2=chi2.to(dt), ndof=ndof.to(dt), accept=accept,
                    g_abs=g_abs, gain_raw=gain_raw, dg_det=dg_det)
    if cfg.sample_mono:
        products["mono"], products["mono_ok"] = mono_new, mono_ok
    return new_state, products


def tod_chisq(cfg: TodConfig, block: M.TodBlock, state: M.TodState,
              sky_maps: torch.Tensor, pix_vec: torch.Tensor,
              sl_fmaps=None, s_extra: torch.Tensor | None = None,
              mono: torch.Tensor | None = None, sl_pix=None,
              per_det: bool = False):
    """TOD chi^2 (float64) of a candidate sky model under the current TOD
    state: the per-proposal chi^2 of the reference's bandpass MH; per_det
    returns the (Nd,) per-detector split."""
    s_tot = M.project_sky(sky_maps, block.pix, block.psi, cfg.pol) \
        + static_signal(cfg, block, pix_vec, sl_fmaps, s_extra, mono, sl_pix)
    resid = block.tod - state.n_corr - state.gain[..., None] * s_tot
    c2 = resid ** 2 * block.mask \
        / torch.clamp(state.sigma0[..., None] ** 2, min=1e-30)
    if per_det:
        return torch.sum(c2, dim=(0, 2), dtype=F64)
    return torch.sum(c2, dtype=F64)


def init_tod_state(block: M.TodBlock, sigma0_guess=1.0) -> M.TodState:
    """Unit gains, sigma0 from the raw data's sample differences, alpha -1,
    fknee 0.1 Hz, no n_corr."""
    Ns, Nd, Nt = block.tod.shape
    dt, dev = block.tod.dtype, block.tod.device
    d = block.tod[..., 1:] - block.tod[..., :-1]
    m2 = block.mask[..., 1:] * block.mask[..., :-1]
    var = torch.sum(d ** 2 * m2, -1, dtype=F64) / torch.clamp(
        torch.sum(m2, -1, dtype=F64), min=1.0) / 2.0
    full = lambda v: torch.full((Ns, Nd), v, dtype=dt, device=dev)
    return M.TodState(gain=full(1.0),
                      sigma0=torch.sqrt(torch.clamp(var, min=1e-30)).to(dt),
                      alpha=full(-1.0), fknee=full(0.1),
                      n_corr=torch.zeros((Ns, Nd, Nt), dtype=dt, device=dev))
