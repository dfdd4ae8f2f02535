"""Metropolis-Hastings moves: the joint alm-C_ell rescaling (torch).

Counterpart of commander_tpu.sampling.mh:
  sample_joint_alm_cl   (mh.py:28-55; the reference's sample_joint_alm_Cl,
                        comm_signal_mod.f90:554-680) the resampling mode's
                        move (RESAMPLE_CMB) that proposes C_ell' per bin and
                        rescales the component's alms deterministically by
                        sqrt(C'/C), accepting on the data likelihood (the
                        prior terms cancel by construction of the proposal);
  sample_bandpass_shift (mh.py:57-89) a band's bandpass shift on the
                        map-level chi^2, its mixing rebuilt at the proposal;
  accept_bandpass_tod   (mh.py:92-107; sample_bp,
                        comm_tod_bandpass_mod.f90:28-82) the accept step of
                        run()'s band-level move on the TOD chi^2.
"""
from __future__ import annotations

import torch

import dataclasses

from ..model.cl import bin_index_table
from ..model.mixing import mixing_matrix
from ..utils.device import rand, randn
from .chisq import compute_chisq


def sample_joint_alm_cl(cfg, sys, plan, a: torch.Tensor,
                        cl_bins: torch.Tensor, comp: int,
                        step_size: float = 0.05,
                        generator: torch.Generator | None = None,
                        draws: dict | None = None):
    """One joint (alm, C_ell) MH move for component `comp`: per bin a
    log-normal step C' = C exp(eps), the alms scaled by sqrt(C'/C) per ell,
    accepted on -1/2 (chi^2' - chi^2) + sum(eps) (the log-normal proposal's
    asymmetry). cfg: the component's binned ClModelConfig. draws: optional
    {"eps": (S, nbins) unit normals, "u": a uniform} used in place of the
    generator's. Returns (a', cl_bins', accepted) with accepted a 0-d bool
    tensor (nothing is read back to the host)."""
    rdt, dev = a.real.dtype, a.device
    shape = tuple(cl_bins.shape[-2:])
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the draws")
        draws = {"eps": randn(shape, generator, rdt, dev),
                 "u": rand((), generator, rdt, dev)}
    eps = step_size * torch.as_tensor(draws["eps"], device=dev).to(rdt)
    cl_new = cl_bins.clone()
    cl_new[comp] = cl_bins[comp] * torch.exp(eps)
    idx = torch.as_tensor(bin_index_table(cfg), device=dev)
    scale = torch.sqrt(torch.exp(eps)[..., idx])              # (S, nl)
    a_new = a.clone()
    a_new[comp] = a[comp] * scale[..., :, None].to(a.dtype)
    chi2_old, _, _ = compute_chisq(sys, plan, a)
    chi2_new, _, _ = compute_chisq(sys, plan, a_new)
    ln_r = -0.5 * (chi2_new - chi2_old) + torch.sum(eps)
    accept = torch.log(torch.as_tensor(draws["u"], device=dev).to(rdt)) \
        < ln_r
    return (torch.where(accept, a_new, a),
            torch.where(accept, cl_new, cl_bins), accept)


def sample_bandpass_shift(comps, bps, thetas, sys, plan, a: torch.Tensor,
                          deltas: torch.Tensor, band: int,
                          step_hz: float = 0.1e9, prior_std_hz: float = 1.0e9,
                          generator: torch.Generator | None = None,
                          draws: dict | None = None):
    """A Metropolis move on one band's bandpass shift (additive_shift,
    comm_bp_mod.f90:194-204): the proposal deltas[band] + step_hz z, the
    mixing rebuilt at it, accepted on the map-level chi^2 and a Gaussian
    prior of prior_std_hz. deltas: (B,) shifts in Hz. draws: optional
    {"z": a normal, "u": a uniform}. Returns (deltas', F', accepted as a 0-d
    bool tensor)."""
    rdt, dev = sys.data.dtype, sys.data.device
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the draws")
        draws = {"z": randn((), generator, rdt, dev),
                 "u": rand((), generator, rdt, dev)}
    deltas = torch.as_tensor(deltas, dtype=torch.float64,
                             device=dev).to(rdt)
    prop = deltas[band] + step_hz * torch.as_tensor(
        draws["z"], dtype=torch.float64, device=dev).to(rdt)
    ds = deltas.clone()
    ds[band] = prop
    F_new = mixing_matrix(comps, bps, thetas=thetas, deltas=list(ds),
                          device=dev)
    F_new = F_new[..., None].repeat(1, 1, sys.F.shape[-1]).to(rdt)
    chi2_old, _, _ = compute_chisq(sys, plan, a)
    chi2_new, _, _ = compute_chisq(dataclasses.replace(sys, F=F_new), plan,
                                   a)
    ln_r = -0.5 * (chi2_new - chi2_old) - 0.5 * (
        (prop / prior_std_hz) ** 2 - (deltas[band] / prior_std_hz) ** 2)
    accept = torch.log(torch.as_tensor(draws["u"], dtype=torch.float64,
                                       device=dev).to(rdt)) < ln_r
    return (torch.where(accept, ds, deltas),
            torch.where(accept, F_new, sys.F), accept)


def accept_bandpass_tod(chi2_cur, chi2_prop, delta_cur, delta_prop,
                        prior_std_hz: float = 1.0e9,
                        generator: torch.Generator | None = None, u=None):
    """The accept step of a bandpass-shift proposal on the TOD chi^2 (the
    chi^2 at the current and the proposed shift), with a Gaussian prior of
    prior_std_hz on the shift; u: an optional U(0, 1) draw (float64, as the
    JAX package's). Returns (the new shift, accepted) as host values."""
    if u is None:
        u = rand((), generator, torch.float64, "cpu" if generator is None
                 else generator.device)
    lnp = -0.5 * ((float(delta_prop) / prior_std_hz) ** 2
                  - (float(delta_cur) / prior_std_hz) ** 2)
    ln_r = -0.5 * (float(chi2_prop) - float(chi2_cur)) + lnp
    accept = bool(torch.log(torch.as_tensor(u, dtype=torch.float64)) < ln_r)
    return (float(delta_prop) if accept else float(delta_cur)), accept
