"""The multi-resolution Gibbs iteration: run.run_multires' loop (torch).

Counterpart of the loop of commander_tpu.run.run_multires (the --multires
entry point, run.py:2697-2956) on a MultiProblem (entry.build_multi_problem).
With TOD (MultiresState.bands, from simulate_tod_bands and tod_burnin) each
iteration starts with tod_pass. One iteration, in run_multires' order:

  0. tod_pass          one TOD pass per TOD band at its group's resolution
                       on the band sky of the last amplitudes, its (map,
                       rms) into the band's row of its group (run.py:
                       2813-2837);
  1. multires_step     a ~ P(a | d, Cl) over every resolution group by one
                       CG (sampling/multires.py), then one inverse-gamma
                       C_l draw per component (run.py:2783-2795);
  2. multires_indices  one full-sky draw per free spectral parameter, the
                       lnL summed over the groups (run.py:2841-2890), then
                       every group's F rebuilt at the new theta
                       (:2891-2906);
  3. multires_gains    the map-level gain of each band that samples it
                       (sampling/gain.sample_gain_gls, and the hard-prior
                       branch; :2907-2940).

Declared divergences in the index lnL (ROADMAP queue 3 item 8; the reference
form sits behind _REFERENCE_FORM, which only a parity test sets):
  (a) run_multires evaluates specind._grid_lnL_pixel, which adds the
      Gaussian prior to every pixel's row, and sums over pixels and groups:
      the prior counts P_total times. The port sums, per group, the pixel
      lnL without the prior (specind._grid_lnL_total, one grid point at a
      time, no (P, G) array) and adds the prior once, as the JAX package's
      fixed full-sky sampler does;
  (b) run_multires beams the amplitude map by bl[0, :1], which on square
      (S, nl, nm) alms multiplies a_lm by b_m of band 0, for every band of
      the group. The port projects the amplitude through each band's own
      b_l (amp_band), the fast path's beam-consistent form;
  (d) run_multires' residual is the data minus the whole model sky, the
      sampled component included, at the F of the phase's start. The port
      takes the data minus the other components, at the F of the current
      theta (slot by slot), as the fast path does (chisq.compute_residual
      with exclude).
  (c) is kept for parity: the gains are drawn and recorded, and applied to
      no group's data or noise, as run_multires does.

Per slot and group the index phase runs two syntheses (the residual's sky
and the amplitude through the beams; batch B_g each), the gains one per
group that samples one. theta and the gains stay device tensors: a step
reads nothing back to the host beyond the CG's two reads per iteration.

The TOD branch copies run_multires' stand-in (simulate_tod_bands): per
band a small block simulated at its group's nside from the group's data
row, T only (ROADMAP queue 3 item 18: a polarized band's Q and U rows keep
the map-level data). At nside 512 an LFI stand-in (8 scans x 2 detectors x
4096 samples) hits under 2% of the pixels, a differential one (4 x 2 x
2048, two horns) about as many; every other pixel keeps its map-level data
and noise.

Randomness: a torch.Generator, or the draws passed in (draws = {eta1 (one
map per group), eta2, gamma (C, S, nbins), u (nslot,), eps_gain (B,),
"tod": {band index: its pass's draws}}; tod_burnin's: a list of three such
"tod" dicts).
"""
from __future__ import annotations

import dataclasses

import torch

from ..model.cl import cl_eval, sample_cl_binned_invgamma
from ..model.mixing import mixing_matrix
from ..tod.differential import simulate_tod_diff
from ..tod.process import TodConfig, init_tod_state
from ..tod.sim import simulate_tod
from . import amplitude as amp
from . import gain as gain_mod
from . import multires
from . import specind as si
from . import tod_gibbs
from .full_gibbs import theta_tuple

# run_multires' own index lnL (facts a, b and d of the module docstring), for
# the parity test only
_REFERENCE_FORM = False
# run_multires' stand-in TOD blocks (run.py:2745-2762) and its burn-in
# passes (:2798-2811)
STANDIN = {"lfi": dict(nscan=8, ndet=2, ntod=4096),
           "diff": dict(nscan=4, ndet=2, ntod=2048)}
STANDIN_SEED = 7
STANDIN_SIGMA0_SCALE = 0.05
TOD_BURNIN_PASSES = 3


@dataclasses.dataclass
class MultiresState:
    """The chain's state between iterations."""
    ms: multires.MultiSystem   # the groups, F at the current theta
    a: torch.Tensor            # (C, S, nl, nm) component amplitudes
    cl_bins: torch.Tensor      # (C, S, nbins)
    thetas: torch.Tensor       # (nslot,) float64, on the device
    gains: torch.Tensor        # (B,) float64 map-level gains (recorded)
    it: int = 0
    cg_iters: int = 0
    cg_relres: float = 0.0
    # {band index: tod_gibbs.TodBand} of the TOD branch, else None
    bands: dict | None = None


def init_state(pb) -> MultiresState:
    """run_multires' start: zero amplitudes, every C_b at 100 (run.py:2730),
    theta at the components' theta0, unit gains."""
    sys0 = pb.ms.groups[0]
    C, S, nl = pb.ms.cl.shape
    cdt = torch.complex128 if sys0.data.dtype == torch.float64 \
        else torch.complex64
    dev = sys0.data.device
    return MultiresState(
        ms=pb.ms, a=torch.zeros((C, S, nl, nl), dtype=cdt, device=dev),
        cl_bins=torch.full((C, S, len(pb.cl_cfg.bin_starts)), 100.0,
                           dtype=sys0.data.dtype, device=dev),
        thetas=pb.thetas0.clone(),
        gains=torch.ones(len(pb.cfg.bands), dtype=torch.float64,
                         device=dev))


def group_bands(pb, g: int) -> list:
    """The bands of group g, in their order in the group."""
    return sorted((j, i) for i, (gi, j) in pb.band_slot.items() if gi == g)


def group_sky(sys_g: amp.AmplitudeSystem, plan_g, a: torch.Tensor):
    """Beam-convolved band skies (B_g, S, P_g) of one group from component
    alms at the common lmax (run.py:2775-2781)."""
    nl_g = plan_g.lmax + 1
    return amp._synth(plan_g, amp._project_bands(
        sys_g, plan_g, a[..., :nl_g, :nl_g]))


def simulate_tod_bands(pb) -> dict:
    """run_multires' TOD data (run.py:2733-2767): for each band with a TOD
    type, in band order, a stand-in block simulated at its group's nside
    from the band's row of the group's data (S, P) with unit gain, T only
    (its TodConfig keeps pol False), seed STANDIN_SEED + band index, sigma0
    STANDIN_SIGMA0_SCALE x the mean over the row of 1/max(inv_rms, 1e-30);
    an LFI block of STANDIN["lfi"]'s size, or on a differential (WMAP) band
    a DiffTodBlock of STANDIN["diff"]'s (x_im 0.01), on the groups' device
    and dtype. (run_multires simulates every LFI orbital dipole at 30 GHz;
    here each band has its own frequency, as in run(): ROADMAP queue 3
    item 4b.) Returns {band index: TodBand}."""
    sys0 = pb.ms.groups[0]
    dt, dev = sys0.data.dtype, sys0.data.device
    bands = {}
    for i, band in enumerate(pb.cfg.bands):
        if not tod_gibbs.has_tod_type(band):
            continue
        g, j = pb.band_slot[i]
        sys_g = pb.ms.groups[g]
        ns_g = pb.groups[g][0]
        sky0 = sys_g.data[j].to("cpu", torch.float64)
        sigma0 = float(torch.mean(1.0 / torch.clamp(
            sys_g.inv_rms[j].to(torch.float64), min=1e-30))) \
            * STANDIN_SIGMA0_SCALE
        nu = band.nominal_freq_ghz * 1e9
        cfg = TodConfig(nside=ns_g, nu=nu)
        if tod_gibbs.is_differential(band):
            block, _ = simulate_tod_diff(
                ns_g, sky0, sigma0=sigma0, gain0=1.0,
                seed=STANDIN_SEED + i, dtype=dt, device=dev,
                **STANDIN["diff"])
            block.horns(12 * ns_g * ns_g)
        else:
            block, _ = simulate_tod(
                ns_g, sky0, sigma0=sigma0, gain0=1.0, nu=nu,
                seed=STANDIN_SEED + i, dtype=dt, device=dev,
                **STANDIN["lfi"])
            block.pixel_runs(12 * ns_g * ns_g)
        bands[i] = tod_gibbs.TodBand(cfg, block, init_tod_state(block),
                                     dict(gain=1.0, sigma0=sigma0))
    return bands


def tod_pass(pb, ms: multires.MultiSystem, bands: dict, a: torch.Tensor,
             generator: torch.Generator | None = None,
             draws: dict | None = None, update: bool = True):
    """One pass per TOD band, in band order, at its group's resolution on
    its band sky of the amplitudes a (run.py:2817-2820; each group's skies
    synthesized once), scan rejection as the band's TodConfig has it; with
    update, each band's rows that the pass made (T only) take its (map,
    1/rms) at hit pixels and inv_rms 0 elsewhere (run.py:2821-2836).
    draws: optional {band index: the pass's draws}. Returns (bands, ms)."""
    groups, skies, out = list(ms.groups), {}, dict(bands)
    for i, band in bands.items():
        g, j = pb.band_slot[i]
        if g not in skies:
            skies[g] = group_sky(groups[g], pb.plans[g], a)
        out[i], prod = tod_gibbs._band_pass(
            band, skies[g][j], False, generator,
            None if draws is None else draws[i])
        if not update:
            continue
        sys_g = groups[g]
        data, inv_rms = sys_g.data.clone(), sys_g.inv_rms.clone()
        inv_rms2 = sys_g.inv_rms2.clone()
        k = prod["map"].shape[0]
        hit = prod["rms"] > 0
        data[j, :k] = torch.where(hit, prod["map"].to(data.dtype),
                                  data[j, :k])
        ir = torch.where(hit, 1.0 / torch.clamp(prod["rms"], min=1e-30),
                         0.0).to(data.dtype)
        inv_rms[j, :k], inv_rms2[j, :k] = ir, ir * ir
        groups[g] = dataclasses.replace(sys_g, data=data, inv_rms=inv_rms,
                                        inv_rms2=inv_rms2)
    return out, dataclasses.replace(ms, groups=tuple(groups))


def tod_burnin(pb, state: MultiresState,
               generator: torch.Generator | None = None,
               draws: list | None = None) -> MultiresState:
    """TOD_BURNIN_PASSES passes over the TOD bands on the band skies of the
    state's amplitudes (zero at the chain's start: run.py:2798-2811), their
    maps discarded, so that (gain, sigma0, n_corr) settle. draws: optional
    list of one tod_pass draws dict per pass."""
    bands = state.bands
    for p in range(TOD_BURNIN_PASSES):
        bands, _ = tod_pass(pb, state.ms, bands, state.a, generator,
                            None if draws is None else draws[p],
                            update=False)
    return dataclasses.replace(state, bands=bands)


def multires_step(pb, state: MultiresState,
                  generator: torch.Generator | None = None,
                  draws: dict | None = None):
    """The amplitude draw over every group and one inverse-gamma C_l draw
    per component. Returns (a, cl_bins, CGResult)."""
    draws = draws or {}
    cl = cl_eval(pb.cl_cfg, {"cl_bins": state.cl_bins}) * pb.ell_mask
    ms = dataclasses.replace(state.ms, cl=cl.to(state.ms.cl.dtype))
    a, res = multires.sample_amplitudes_multi(
        ms, pb.plans, generator, eta1=draws.get("eta1"),
        eta2=draws.get("eta2"), tol=pb.cfg.cg_tol,
        maxiter=pb.cfg.cg_maxiter)
    gamma = draws.get("gamma")
    clb = torch.stack([sample_cl_binned_invgamma(
        pb.cl_cfg, a[c], generator=generator,
        gamma=None if gamma is None else gamma[c])
        for c in range(a.shape[0])])
    return a, clb.to(state.cl_bins.dtype), res


def groups_at(pb, ms: multires.MultiSystem, thetas: torch.Tensor):
    """ms with every group's F rebuilt at `thetas` on the device (run.py
    :2891-2906), the same for every Stokes parameter."""
    F_all = mixing_matrix(pb.diffuse, pb.bps,
                          thetas=theta_tuple(pb.diffuse, pb.slots, thetas),
                          device=thetas.device)
    new = []
    for g, sys_g in enumerate(ms.groups):
        # (a row at a time: a list index would copy it to the device)
        Fg = torch.stack([F_all[i] for _, i in group_bands(pb, g)])
        Fg = Fg[..., None].repeat(1, 1, sys_g.data.shape[1])
        new.append(dataclasses.replace(sys_g, F=Fg.to(sys_g.data.dtype)))
    return dataclasses.replace(ms, groups=tuple(new))


def _slot_lnl(pb, ms, a, thetas, slot, g):
    """Group g's lnL grid (G,) of one slot, without the prior, in the port's
    form: the residual without the slot's component (ms: F at thetas),
    against the component through each band's beam."""
    sys_g, plan_g = ms.groups[g], pb.plans[g]
    nl_g = plan_g.lmax + 1
    a_g = a[..., :nl_g, :nl_g]
    others = a_g.clone()
    others[slot.ci] = 0.0
    res_g = sys_g.data - amp._synth(
        plan_g, amp._project_bands(sys_g, plan_g, others))
    amp_band = amp._synth(plan_g, a_g[slot.ci][None] * sys_g.bl[..., None])
    amp_pix = None
    if slot.cfg.lnl_type in ("ridge", "marginal"):
        amp_pix = amp._synth(plan_g, a_g[slot.ci])
    bps_g = [pb.bps[i] for _, i in group_bands(pb, g)]
    cfg = dataclasses.replace(slot.cfg, prior_mean=None, prior_std=None)
    return si._grid_lnL_total(
        pb.diffuse[slot.ci], bps_g, cfg, res_g, amp_pix, sys_g.inv_rms2,
        theta_tuple(pb.diffuse, pb.slots, thetas)[slot.ci], slot.which,
        amp_band=amp_band)


def _slot_lnl_reference(pb, ms, a, thetas, slot, g):
    """Group g's lnL grid (G,) of one slot as run_multires computes it
    (run.py:2870-2884): residual of the whole sky at the phase's F, the
    amplitude times bl[0, :1], the pixel grid with the prior in every
    pixel's row, summed over pixels."""
    sys_g, plan_g = ms.groups[g], pb.plans[g]
    nl_g = plan_g.lmax + 1
    a_g = a[..., :nl_g, :nl_g]
    res_g = sys_g.data - group_sky(sys_g, plan_g, a)
    amp_g = amp._synth(plan_g, a_g[slot.ci] * sys_g.bl[0, :1])
    bps_g = [pb.bps[i] for _, i in group_bands(pb, g)]
    lnl = si._grid_lnL_pixel(
        pb.diffuse[slot.ci], bps_g, slot.cfg, res_g, amp_g, sys_g.inv_rms2,
        theta_tuple(pb.diffuse, pb.slots, thetas)[slot.ci], slot.which)
    return torch.sum(lnl, dim=0, dtype=torch.float64)


def index_lnl(pb, ms: multires.MultiSystem, a: torch.Tensor,
              thetas: torch.Tensor, slot) -> torch.Tensor:
    """The lnL grid (G,) float64 of one slot, summed over the groups, with
    its Gaussian prior: once in the port's form, in every pixel's row under
    _REFERENCE_FORM. ms: the groups at the phase's start."""
    ms_i = ms if _REFERENCE_FORM else groups_at(pb, ms, thetas)
    lnl = None
    for g in range(len(ms.groups)):
        if _REFERENCE_FORM:
            contrib = _slot_lnl_reference(pb, ms, a, thetas, slot, g)
        else:
            contrib = _slot_lnl(pb, ms_i, a, thetas, slot, g)
        lnl = contrib if lnl is None else lnl + contrib
    if _REFERENCE_FORM:
        return lnl
    return lnl + si._lnprior(slot.cfg, slot.cfg.grid(torch.float64,
                                                      thetas.device))


def multires_indices(pb, ms: multires.MultiSystem, a: torch.Tensor,
                     thetas: torch.Tensor,
                     generator: torch.Generator | None = None, u=None):
    """One full-sky draw per free parameter, in slot order, each given the
    draws before it, the lnL summed over the groups (index_lnl); then every
    group's F at the new theta. u: optional (nslot,) uniforms. Returns
    (thetas, ms)."""
    u = si._uniform((len(pb.slots),), ms.groups[0].data, generator, u)
    th = thetas
    for i, slot in enumerate(pb.slots):
        lnl = index_lnl(pb, ms, a, th, slot)
        th = th.clone()
        th[i] = si._cdf_invert(u[i], lnl, slot.cfg.grid(
            torch.float64, th.device)).to(th.dtype)
    return th, groups_at(pb, ms, th)


def multires_gains(pb, ms: multires.MultiSystem, a: torch.Tensor,
                   gains: torch.Tensor, it: int,
                   generator: torch.Generator | None = None, eps=None):
    """The map-level gain of every band that samples it (run.py:2907-2940),
    in band order within each group: a hard prior (BAND_GAIN_PRIOR_RMS < 0)
    keeps the gain but every NUMITER_RESAMPLE_HARD_GAIN_PRIORS-th
    iteration, where it is drawn as mean + |rms| N(0, 1); else the GLS draw
    against the unit-gain model sky, a soft prior folded in. eps: optional
    (B,) N(0, 1) draws, one per band (read by the bands that sample).
    Returns the (B,) gains; none is applied to the data (fact c)."""
    cfg = pb.cfg
    g_new = gains.clone()
    for g, (sys_g, plan_g) in enumerate(zip(ms.groups, pb.plans)):
        members = [(j, i) for j, i in group_bands(pb, g)
                   if cfg.bands[i].sample_gain]
        if not members:
            continue
        sky_g = group_sky(sys_g, plan_g, a)
        for j, i in members:
            band = cfg.bands[i]
            pm, pr = band.gain_prior_mean, band.gain_prior_rms
            e = None if eps is None else eps[i]
            if pr < 0:
                nth = max(int(cfg.resamp_hard_gain_nth or 0), 0)
                if nth and it % nth == 0:
                    z = gain_mod._normal((), g_new, generator, e)
                    g_new[i] = pm + abs(pr) * z
                continue
            g_new[i] = gain_mod.sample_gain_gls(
                sys_g.data[j], sky_g[j] / torch.clamp(g_new[i], min=1e-12),
                sys_g.inv_rms2[j], g_new[i], prior_mean=pm, prior_rms=pr,
                optimize=cfg.operation == "optimize", generator=generator,
                eps=e)
    return g_new


def multires_gibbs_step(pb, state: MultiresState,
                        generator: torch.Generator | None = None,
                        draws: dict | None = None) -> MultiresState:
    """One iteration of run_multires' loop: amplitudes and C_l, then (with
    cfg.sample_specind) the indices and F, then the gains of the bands that
    sample them; with TOD bands the TOD pass first (tod_pass on the last
    amplitudes). draws: see the module docstring."""
    draws = draws or {}
    bands = state.bands
    if bands:
        bands, ms = tod_pass(pb, state.ms, bands, state.a, generator,
                             draws.get("tod"))
        state = dataclasses.replace(state, ms=ms)
    a, cl_bins, res = multires_step(pb, state, generator, draws)
    it = state.it + 1
    ms, th = state.ms, state.thetas
    if pb.cfg.sample_specind and pb.slots:
        th, ms = multires_indices(pb, ms, a, th, generator, draws.get("u"))
    gains = state.gains
    if any(b.sample_gain for b in pb.cfg.bands):
        gains = multires_gains(pb, ms, a, gains, it, generator,
                               draws.get("eps_gain"))
    return MultiresState(ms=ms, a=a, cl_bins=cl_bins, thetas=th,
                         gains=gains, it=it, cg_iters=res.iters,
                         cg_relres=res.rel_res, bands=bands)
