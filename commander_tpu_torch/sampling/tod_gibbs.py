"""A Gibbs iteration that starts from time-ordered data: the per-band TOD pass
turns each band's TOD into a binned map and rms, these replace the band's
data and noise, and the sky step (full_gibbs_step) runs on them (torch).

Counterpart of the TOD stage that commander_tpu.run (run.py) holds
inline (the reference's process_LFI_tod ahead of the component separation,
commander.f90:179-254):
  simulate_bands   run._setup_synthetic_tod: one band of TOD per system
                   band from the noiseless band sky, sigma0 = scale /
                   mean(inv_rms) of the band, seed + b per band; an LFI band
                   (tod/sim.py) or a differential (WMAP) one
                   (tod/differential.py: half the scans and samples,
                   run.py:751-759)
  tod_pass         run.py:2068-2095 and :2187-2201: per band process_tod,
                   or process_tod_diff on a differential band, on the
                   current model sky (chisq.sky_signal), then hit pixels
                   take the map and rms and unhit pixels get inv_rms 0;
                   chi^2 scan rejection is off on the first iteration
  tod_burnin       run.py:1638-1643, :1325-1352, :1740-1744: one amplitude
                   step on the map-level data, then TOD passes on its sky with
                   rejection off, their maps discarded
  tod_gibbs_step   tod_pass, then full_gibbs_step, as run.py's loop orders
                   them

With TodConfig.sample_mono each band carries its per-detector monopoles
from pass to pass (TodBand.mono), as run.py's aux["mono"] does. A band may
carry the sidelobe inputs (TodBand.sl_blm, sl_plan, sl_tables, sl_pix) and
a zodi template (TodBand.zodi), with the meaning of run.py's aux
(_setup_tod_aux, :647-712): every pass adds the zodi template and the
sidelobe term, whose f-maps (band_sl_fmaps) are made once per stage from
the band alms of the current amplitudes (run.py:1696-1700, :1743, :2071).
With the joint system's template and point-source rows (ts, ps) the
amplitude steps draw (a, t, p) and every TOD pass runs on the full model
sky, diffuse plus templates plus sources (chisq.full_sky; run.py:2070's
sky_fn_state).

Randomness: a torch.Generator, or the draws ready-made ({"tod": one
process.pass_draws dict per band, and full_gibbs_step's eta1, eta2, gamma,
u}). A band list may hold None for a band without TOD (BAND_TOD_TYPE
none): its map and noise stay as read. run()'s host loop around these
(the bandpass MH, the 4D maps) lives in driver/loop.py. Not ported: the
per-detector-sky part of run.py's TOD stage, which archive bands reach
(ROADMAP.md queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import torch

from ..sphere import healpix
from ..tod import model as M
from ..tod import conviqt
from ..tod.differential import (DiffTodBlock, process_tod_diff,
                                simulate_tod_diff)
from ..tod.process import TodConfig, init_tod_state, process_tod
from ..tod.sim import simulate_tod
from ..utils.device import resolve_device
from . import amplitude as amp
from . import chisq
from . import full_gibbs
from . import gibbs as gibbs_mod


class TodBand(NamedTuple):
    """One band's TOD: its configuration, data (a TodBlock, or a
    DiffTodBlock for a differential band) and sampled state, the parameters
    it was simulated with ({} for data not simulated here), and with
    cfg.sample_mono the per-detector monopoles (Nd,) in the block's dtype,
    zeros at the start (run.py:711-712), else None (always on a
    differential band, as run.py:711 gives monopoles to LFI bands only).
    The sidelobe inputs, all or none (run.py:665-700): sl_blm (Nd, nl_sl,
    M+1) the detectors' sidelobe beam alms, sl_plan the sidelobe plan
    (nside ns_sl, lmax nl_sl - 1), sl_tables its conviqt_tables, sl_pix
    (Ns, Nd, Nt) the samples' pixels at ns_sl; zodi the (Ns, Nd, Nt) zodi
    template in the data's units (run.py:703-710). An LFI band's only."""
    cfg: TodConfig
    block: M.TodBlock | DiffTodBlock
    state: M.TodState
    truth: dict
    mono: torch.Tensor | None = None
    sl_blm: torch.Tensor | None = None
    sl_plan: object = None
    sl_tables: list | None = None
    sl_pix: torch.Tensor | None = None
    zodi: torch.Tensor | None = None

    @property
    def kind(self) -> str:
        """"diff" for a differential (WMAP) band, else "lfi" (run.py:637)."""
        return "diff" if isinstance(self.block, DiffTodBlock) else "lfi"

    @property
    def has_templates(self) -> bool:
        """Whether the band carries a sidelobe or zodi term (what takes a
        chain off run()'s deferred fast route, run.py:1727-1733)."""
        return self.sl_blm is not None or self.sl_pix is not None \
            or self.zodi is not None


def band_sl_fmaps(bands: Sequence[TodBand], sys: amp.AmplitudeSystem,
                  a: torch.Tensor) -> list:
    """Per band, the sidelobe f-maps (Nd, M+1, 2, npix_sl) of the band sky
    of the amplitudes a (C, S, nl, nm), or None for a band without
    sidelobe inputs (run._all_sl_fmaps, run.py:1696-1700): the temperature
    row of _project_bands, bl_b sum_c F_bc a_c, made only up to each
    band's sidelobe lmax (conviqt.sl_fmaps_for_band pads above it)."""
    out = []
    for b, band in enumerate(bands):
        if band is None or band.sl_blm is None:
            out.append(None)
            continue
        nl = min(band.sl_plan.lmax + 1, a.shape[-2])
        aT = torch.einsum("c,clm->lm", sys.F[b, :, 0].to(a.dtype),
                          a[:, 0, :nl, :nl]) * sys.bl[b, 0, :nl, None]
        out.append(conviqt.sl_fmaps_for_band(band.sl_plan, band.sl_tables,
                                             band.sl_blm, aT))
    return out


def has_tod_type(band) -> bool:
    """Whether a band carries TOD: BAND_TOD_TYPE set and not none, in any
    case. run._setup_synthetic_tod skips only None and "none", and the
    parameter parser turns the value none into the string "None", so there
    a band that says BAND_TOD_TYPE = none gets TOD and only a band without
    the key stays at map level; the port reads none as no TOD (ROADMAP
    queue 3 item 13)."""
    return band.tod_type is not None \
        and str(band.tod_type).lower() not in ("none", "")


def is_differential(band) -> bool:
    """Whether a band's TOD is differential: BAND_TOD_TYPE WMAP, in any
    case (run.py:637, :751)."""
    return has_tod_type(band) and str(band.tod_type).upper() == "WMAP"


@functools.lru_cache(maxsize=2)
def pixel_vectors(nside: int, dtype: torch.dtype, device: str
                  ) -> torch.Tensor:
    """(npix, 3) pixel unit vectors on `device`, made once per nside."""
    return torch.as_tensor(healpix.pix2vec_ring(nside)).to(device, dtype)


def simulate_bands(nside: int, sky_true, inv_rms, freqs_hz: Sequence[float],
                   nscan: int = 8, ndet: int = 2, ntod: int = 4096,
                   fsamp: float = 10.0, sigma0_scale: float = 0.05,
                   fknee: float = 0.3, alpha: float = -1.5, seed: int = 0,
                   sample_mono: bool = False, dtype=torch.float32,
                   device=None, tod=None, mono_guard: bool = False,
                   kinds=None) -> list:
    """One TodBand per band, simulated from the noiseless band sky sky_true
    (B, S, P) (array or tensor) with unit gain: sigma0 = sigma0_scale /
    mean(inv_rms[b]), seed + b; polarized when S = 3, at the band's
    frequency freqs_hz[b]. The blocks go to `device` (None: the CUDA card) in
    `dtype`, each with its pixel runs made. sample_mono: draw per-detector
    monopoles in every pass, from zeros (run.py:766-768); mono_guard: with
    the port-only guard of that draw (TodConfig.mono_guard). tod: optional
    (B,) flags, False for a band without TOD (None in the list, its seed
    skipped, as run._setup_synthetic_tod skips it). kinds: optional (B,)
    "lfi" or "diff": a differential band (run.py:751-759) takes max(nscan
    // 2, 1) scans of max(ntod // 2, 512) samples, x_im 0.01 and the
    simulator's own fsamp, alpha and no orbital dipole, monopoles or
    other terms.
    (run._setup_synthetic_tod simulates every LFI band's orbital dipole
    at the simulator's default 30 GHz; here each band has its own.)"""
    device = resolve_device(device)
    sky = torch.as_tensor(sky_true).to("cpu", torch.float64).numpy()
    inv = torch.as_tensor(inv_rms).to("cpu", torch.float64).numpy()
    S = sky.shape[1]
    bands = []
    for b in range(sky.shape[0]):
        if tod is not None and not tod[b]:
            bands.append(None)
            continue
        cfg = TodConfig(nside=nside, nu=float(freqs_hz[b]), pol=S == 3,
                        sample_mono=sample_mono, mono_guard=mono_guard)
        sigma0 = float(inv[b].mean() ** -1) * sigma0_scale
        if kinds is not None and kinds[b] == "diff":
            cfg = TodConfig(nside=nside, nu=float(freqs_hz[b]), pol=S == 3)
            block, _ = simulate_tod_diff(
                nside, sky[b], nscan=max(nscan // 2, 1), ndet=ndet,
                ntod=max(ntod // 2, 512), sigma0=sigma0, gain0=1.0,
                seed=seed + b, pol=cfg.pol, fknee=fknee, dtype=dtype,
                device=device)
            block.horns(12 * nside * nside)
            bands.append(TodBand(cfg, block, init_tod_state(block), dict(
                gain=1.0, sigma0=sigma0, fknee=fknee, x_im=0.01)))
            continue
        block, _ = simulate_tod(nside, sky[b], nscan=nscan, ndet=ndet,
                                ntod=ntod, fsamp=fsamp, gain0=1.0,
                                sigma0=sigma0, alpha=alpha, fknee=fknee,
                                nu=cfg.nu, pol=cfg.pol, seed=seed + b,
                                dtype=dtype, device=device)
        block.pixel_runs(12 * nside * nside)
        mono = torch.zeros(ndet, dtype=dtype, device=device) \
            if sample_mono else None
        bands.append(TodBand(cfg, block, init_tod_state(block), dict(
            gain=1.0, sigma0=sigma0, alpha=alpha, fknee=fknee), mono))
    return bands


def _band_pass(band: TodBand, sky, first: bool, generator, draws,
               sl_fmaps=None):
    """process_tod on one band, with its sidelobe term (sl_fmaps, from
    band_sl_fmaps, at band.sl_pix) and its zodi template, or
    process_tod_diff on a differential one (on the band sky, run.py:
    1342-1350, 2086-2093); the band returned carries the new state and,
    with cfg.sample_mono, the pass's monopoles (run.py:1346-1347,
    2090-2091)."""
    cfg = band.cfg
    dt, dev = band.block.tod.dtype, band.block.tod.device
    if band.kind == "diff":
        state, prod = process_tod_diff(
            cfg, band.block, band.state, sky,
            pixel_vectors(cfg.nside, dt, str(dev)), generator, draws=draws)
        return band._replace(state=state), prod
    if cfg.sample_mono and band.mono is None:
        raise ValueError("a band with sample_mono needs its monopoles: "
                         "TodBand.mono = zeros(ndet) at the start")
    if first:
        # the sky model has not seen the TOD maps yet: no scan rejection
        # (the reference's first_call, comm_tod_LFI_mod.f90:467)
        cfg = dataclasses.replace(cfg, chisq_reject_sigma=1e30)
    if band.sl_blm is not None and sl_fmaps is None:
        raise ValueError("a band with sidelobe inputs needs its f-maps "
                         "(band_sl_fmaps)")
    state, prod = process_tod(cfg, band.block, band.state, sky,
                              pixel_vectors(cfg.nside, dt, str(dev)),
                              generator, sl_fmaps=sl_fmaps,
                              s_extra=band.zodi, mono=band.mono,
                              sl_pix=band.sl_pix, draws=draws)
    band = band._replace(state=state)
    if cfg.sample_mono:
        band = band._replace(mono=prod["mono"])
    return band, prod


def tod_pass(bands: Sequence[TodBand], sys: amp.AmplitudeSystem,
             sky: torch.Tensor, first: bool = False,
             generator: torch.Generator | None = None,
             draws: Sequence[dict] | None = None, sl_fmaps=None):
    """The pass of every band (bands[b] is system band b; _band_pass) on
    the model sky (B, S, P), then the system update: in each band's rows,
    hit pixels take the pass's map and 1/rms, unhit pixels inv_rms 0 (their
    data stay); a band that is None keeps its rows. sl_fmaps: the bands'
    band_sl_fmaps where a band carries sidelobe inputs. Returns (new bands,
    sys with new data, inv_rms, inv_rms2)."""
    data, inv_rms = sys.data.clone(), sys.inv_rms.clone()
    out = []
    for b, band in enumerate(bands):
        if band is None:
            out.append(None)
            continue
        band, prod = _band_pass(band, sky[b], first, generator,
                                None if draws is None else draws[b],
                                None if sl_fmaps is None else sl_fmaps[b])
        out.append(band)
        k = prod["map"].shape[0]
        hit = prod["rms"] > 0
        data[b, :k] = torch.where(hit, prod["map"].to(data.dtype),
                                  data[b, :k])
        inv_rms[b, :k] = torch.where(
            hit, 1.0 / torch.where(hit, prod["rms"], 1.0).to(data.dtype), 0.0)
    return out, dataclasses.replace(sys, data=data, inv_rms=inv_rms,
                                    inv_rms2=inv_rms ** 2)


def tod_burnin(gcfg: gibbs_mod.GibbsConfig, bands: Sequence[TodBand],
               sys: amp.AmplitudeSystem, plan, state: gibbs_mod.GibbsState,
               generator: torch.Generator | None = None, npasses: int = 3,
               draws: dict | None = None, ts=None, ps=None):
    """The warm start: one amplitude + C_ell step on the map-level data of
    sys (the system at the current indices), then npasses TOD passes over
    all bands on that state's model sky, scan rejection off; the passes'
    maps are discarded, so (gain, sigma0, n_corr) converge before their maps
    feed the sky step; the sidelobe f-maps are made once, from that state
    (run.py:1743). draws: optional {eta1, eta2, gamma} of the amplitude
    step (eta_t, eta_p with ts / ps) and "tod": npasses lists of per-band
    pass_draws dicts. ts / ps: the joint system's template and source rows.
    Returns (new bands, new Gibbs state)."""
    draws = draws or {}
    state = gibbs_mod.gibbs_step(gcfg, sys, plan, state, generator,
                                 draws=draws, ts=ts, ps=ps)
    sky = chisq.full_sky(sys, plan, state.a, ts, ps, state.t, state.p)
    sl = band_sl_fmaps(bands, sys, state.a)
    bands = list(bands)
    for i in range(npasses):
        for b, band in enumerate(bands):
            if band is not None:
                bands[b], _ = _band_pass(band, sky[b], True, generator,
                                         draws["tod"][i][b] if "tod" in draws
                                         else None, sl[b])
    return bands, state


def tod_gibbs_step(gcfg: gibbs_mod.GibbsConfig, comps, bps, slots,
                   bands: Sequence[TodBand], base_sys: amp.AmplitudeSystem,
                   plan, state: gibbs_mod.GibbsState, thetas: torch.Tensor,
                   first: bool = False,
                   generator: torch.Generator | None = None,
                   beam_consistent: bool = False, draws: dict | None = None,
                   ts=None, ps=None):
    """One Gibbs iteration from the TOD: the TOD pass on the model sky of
    (state.a, thetas) and, with ts / ps, of the template and source rows at
    (state.t, state.p), the band maps and noise of base_sys replaced by its
    binned maps and rms, then full_gibbs_step on them. first: the chain's
    first iteration (no scan rejection). Returns (bands, base_sys, state,
    thetas), base_sys carrying the new maps."""
    draws = draws or {}
    sys = full_gibbs.system_at(base_sys, comps, bps, slots, thetas)
    sky = chisq.full_sky(sys, plan, state.a, ts, ps, state.t, state.p)
    bands, base_sys = tod_pass(bands, base_sys, sky, first, generator,
                               draws.get("tod"),
                               band_sl_fmaps(bands, sys, state.a))
    del sky, sys
    state, thetas, _ = full_gibbs.full_gibbs_step(
        gcfg, comps, bps, slots, base_sys, plan, state, thetas, generator,
        beam_consistent=beam_consistent, draws=draws, ts=ts, ps=ps)
    return bands, base_sys, state, thetas


def binned_map_chisq(sys: amp.AmplitudeSystem, sky_true: torch.Tensor):
    """Per band and Stokes row, the binned maps against the sky they were
    simulated from, at the pixels with inv_rms > 0 (run.py:2052-2067):
    (chi^2/dof (B, S), hit fraction (B, S)), float64 on sys's device."""
    hit = sys.inv_rms > 0
    z = (sys.data - sky_true).to(torch.float64) * sys.inv_rms
    n = torch.sum(hit, dim=-1, dtype=torch.float64)
    return (torch.sum(z ** 2, dim=-1) / torch.clamp(n, min=1.0),
            n / sys.inv_rms.shape[-1])
