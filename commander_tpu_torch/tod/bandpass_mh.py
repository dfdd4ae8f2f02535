"""Bandpass sampling on the TOD chi^2: the unit component streams, the
per-detector mixing and chi^2, and the ndelta-proposal MH over per-detector
shifts (torch).

Counterpart of commander_tpu.tod.bandpass_mh (the reference's process_TOD
proposal flow, commander.f90:274-399, and sample_bp,
comm_tod_bandpass_mod.f90:28-79). The unit-amplitude band response of every
component is synthesized and gathered to the TOD once per band
(unit_comp_tod); a proposal is then a re-quadrature of the mixing
(det_mixing) and an einsum over those streams (chisq_det), independent of
nside. The band-level move of run()'s host loop (driver/loop.py) takes its
fast form through these; sample_bp_det, the per-detector move, needs
per-detector bandpasses, which only archive bands carry (ROADMAP queue 1
item 6).
"""
from __future__ import annotations

import torch

from ..model.mixing import mixing_element
from ..utils.device import rand, randn
from . import model as M

F64 = torch.float64


def unit_comp_tod(plan, bl_b: torch.Tensor, a: torch.Tensor, block, pol: bool
                  ) -> torch.Tensor:
    """Each component's unit-amplitude band map (the band beam bl_b (S, nl)
    on the alms a (C, S, nl, nm)) gathered to the TOD: (C, Ns, Nd, Nt)."""
    from ..sampling import amplitude as amp

    maps = amp._synth(plan, a * bl_b[None, :, :, None])      # (C, S, P)
    return torch.stack([M.project_sky(m, block.pix, block.psi, pol)
                        for m in maps])


def det_mixing(comps, det_bps, thetas, deltas_det,
               shift_model: str = "additive_shift") -> torch.Tensor:
    """F[d, c] (Nd, C) at per-detector bandpass shifts deltas_det (Nd,),
    rounded to float32 as the JAX package rounds it (shift_model is the
    band's BAND_BANDPASS_MODEL; the quadrature applies the additive shift,
    as there)."""
    dev = deltas_det.device if isinstance(deltas_det, torch.Tensor) \
        else None
    rows = []
    for d, bp in enumerate(det_bps):
        rows.append(torch.stack([
            mixing_element(c, bp, tuple(th), deltas_det[d], device=dev)
            .to(torch.float32) for c, th in zip(comps, thetas)]))
    return torch.stack(rows)


def chisq_det(F_det: torch.Tensor, comp_tod: torch.Tensor, s_stat, block,
              tstate) -> torch.Tensor:
    """Per-detector TOD chi^2 (Nd,) of a candidate mixing F_det (Nd, C):
    comp_tod (C, Ns, Nd, Nt) the unit streams, s_stat (Ns, Nd, Nt) the
    static signal (orbital dipole, zodi, monopoles)."""
    s_sky = torch.einsum("dc,csdt->sdt", F_det.to(comp_tod.dtype), comp_tod)
    resid = block.tod - tstate.n_corr - tstate.gain[..., None] * (
        s_sky + s_stat)
    c2 = resid ** 2 * block.mask / torch.clamp(tstate.sigma0[..., None] ** 2,
                                               min=1e-30)
    return torch.sum(c2, dim=(0, 2))


def sample_bp_det(comps, thetas, det_bps, comp_tod, s_stat, block, tstate,
                  deltas_det0, n_prop: int = 1, sigma_prop: float = 0.1e9,
                  band_delta: float = 0.0,
                  shift_model: str = "additive_shift", optimize=False,
                  generator: torch.Generator | None = None, draws=None):
    """ndelta-proposal Metropolis over per-detector shifts relative to the
    band's (deltas_det0 (Nd,)): each proposal a zero-mean move of
    sigma_prop, accepted on the summed chi^2. draws: optional list of
    n_prop {"eta": (Nd,) normals, "u": a uniform} in place of the
    generator's. Returns (deltas (Nd,), per-detector chi^2 at acceptance,
    the number accepted)."""
    nd = len(det_bps)
    cur = torch.as_tensor(deltas_det0, dtype=F64)
    dev = comp_tod.device

    def chisq(dd):
        F = det_mixing(comps, det_bps, thetas, (dd + band_delta).to(dev),
                       shift_model)
        return chisq_det(F, comp_tod, s_stat, block, tstate)

    c_cur = chisq(cur)
    n_acc = 0
    for k in range(n_prop):
        d = None if draws is None else draws[k]
        eta = randn(nd, generator, F64, cur.device) if d is None \
            else torch.as_tensor(d["eta"], dtype=F64)
        u = None if optimize else (
            rand((), generator, F64, "cpu") if d is None
            else torch.as_tensor(d["u"], dtype=F64))
        prop = cur + sigma_prop * eta.to(cur.device)
        prop = prop - torch.mean(prop)
        c_prop = chisq(prop)
        s_new, s_old = float(torch.sum(c_prop)), float(torch.sum(c_cur))
        if optimize:
            accept = s_new <= s_old
        else:
            accept = float(u) < float(torch.exp(torch.tensor(
                -0.5 * max(s_new - s_old, 0.0), dtype=F64)))
        if accept:
            cur, c_cur = prop, c_prop
            n_acc += 1
    return cur, c_cur, n_acc
