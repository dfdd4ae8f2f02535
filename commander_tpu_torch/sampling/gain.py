"""Map-level calibration (gain) sampling per band (torch).

Counterpart of commander_tpu.sampling.gain (the reference's
comm_gain_mod.f90 sample_gain):

  * sample_gain      joint GLS draw of every band's gain (a batched
                     form);
  * cross_sigma_ell / estimate_gain_cross_cl
                     the ell-range cross-spectrum estimator of one band:
                     the mean over [lmin, lmax] of C_l^{sig,res} /
                     C_l^{sig,sig} (TT), deterministic;
  * sample_gain_gls  the pixel-space GLS draw of one band, mu = <res, N^-1
                     sig> / <sig, N^-1 sig>, sigma = <sig, N^-1 sig>^-1/2,
                     a Gaussian prior with rms > 0 folded into the normal
                     equations, the move clamped to +-MAX_DELTA_G of the
                     old gain.

Every draw takes a torch.Generator or its N(0, 1) variates ready-made
(`eps`), so that a run can be held to the reference's own draws. Nothing
is read back to the host: the gains stay tensors.
"""
from __future__ import annotations

import torch

from ..model.cl import sigma_ell
from ..sphere import sht
from ..utils.device import randn

MAX_DELTA_G = 0.01  # comm_gain_mod.f90:39


def _normal(shape, like: torch.Tensor, generator, eps):
    if eps is not None:
        return torch.as_tensor(eps, device=like.device).to(like.dtype)
    if generator is None:
        raise ValueError("pass a torch.Generator or the normal draws eps")
    return randn(shape, generator, like.dtype, like.device)


def sample_gain(d, s, inv_rms2, prior_mean=None, prior_std=None,
                generator: torch.Generator | None = None, eps=None):
    """Draw every band's gain jointly: d, s, inv_rms2 (B, S, P) -> (B,).
    eps: optional (B,) N(0, 1) draws."""
    num = torch.sum(s * d * inv_rms2, dim=(-1, -2))
    den = torch.sum(s * s * inv_rms2, dim=(-1, -2))
    if prior_mean is not None and prior_std is not None:
        num = num + prior_mean / prior_std**2
        den = den + 1.0 / prior_std**2
    mean = num / torch.clamp(den, min=1e-300)
    std = 1.0 / torch.sqrt(torch.clamp(den, min=1e-300))
    return mean + std * _normal(mean.shape, mean, generator, eps)


def cross_sigma_ell(a1: torch.Tensor, a2: torch.Tensor, lmax: int
                    ) -> torch.Tensor:
    """Empirical cross power sigma_l = 1/(2l+1) sum_m eps_m Re(a1 a2*) of
    rectangular alms (..., lmax+1, mmax+1) -> (..., lmax+1)."""
    nm = a1.shape[-1]
    rdt = a1.real.dtype
    eps = torch.full((nm,), 2.0, dtype=rdt, device=a1.device)
    eps[:1] = 1.0
    power = torch.sum(eps * (a1 * a2.conj()).real, dim=-1)
    ell = torch.arange(lmax + 1, dtype=power.dtype, device=power.device)
    return power / (2.0 * ell + 1.0)


def estimate_gain_cross_cl(plan, sig: torch.Tensor, res: torch.Tensor,
                           lmin: int, lmax: int, mask=None) -> torch.Tensor:
    """The ell-range cross-spectrum gain of ONE band (0-d tensor). sig, res:
    (S, P) maps, the unit-gain calibration signal and residual + signal;
    the TT spectra of their quadrature analyses (sht.map2alm) over [lmin,
    lmax], optionally inside `mask`."""
    if mask is not None:
        sig = sig * mask
        res = res * mask
    a_s = sht.map2alm(plan, sig[None])[0]          # (S, nl, nm)
    a_r = sht.map2alm(plan, res[None])[0]
    cls_ss = sigma_ell(a_s, plan.lmax)[0]          # TT
    cls_sr = cross_sigma_ell(a_s[0], a_r[0], plan.lmax)
    ell = torch.arange(plan.lmax + 1, device=sig.device)
    sel = (ell >= max(lmin, 0)) & (ell <= lmax)
    ratio = torch.where(sel, cls_sr / torch.clamp(torch.abs(cls_ss),
                                                  min=1e-300)
                        * torch.sign(cls_ss), torch.zeros_like(cls_sr))
    nsel = len(range(max(lmin, 0), min(lmax, plan.lmax) + 1))
    return torch.sum(ratio) / max(nsel, 1)


def sample_gain_gls(res: torch.Tensor, sig: torch.Tensor,
                    inv_rms2: torch.Tensor, old_gain, mask=None,
                    prior_mean=None, prior_rms: float = 0.0,
                    optimize: bool = False, max_delta_g: float = MAX_DELTA_G,
                    generator: torch.Generator | None = None, eps=None
                    ) -> torch.Tensor:
    """Pixel-space GLS gain draw of ONE band (0-d tensor). res: residual +
    old_gain * sig (the data with the other components taken out); sig:
    the unit-gain calibration signal; both (S, P). The mean with optimize,
    else mean + sd * eps (eps a 0-d N(0, 1) draw, or from the generator);
    clamped to +-max_delta_g of old_gain (a float or 0-d tensor); float64."""
    w = inv_rms2 if mask is None else inv_rms2 * mask
    # the sums over pixels accumulate in float64 (the gain is a float64
    # scalar whatever the maps' dtype)
    den = torch.sum(sig * sig * w, dtype=torch.float64)
    num = torch.sum(res * sig * w, dtype=torch.float64)
    if prior_mean is not None and prior_rms and prior_rms > 0:
        num = num + prior_mean / prior_rms**2
        den = den + 1.0 / prior_rms**2
    mu = num / torch.clamp(den, min=1e-300)
    sd = 1.0 / torch.sqrt(torch.clamp(den, min=1e-300))
    g = mu if optimize else mu + sd * _normal((), mu, generator, eps)
    old = torch.as_tensor(old_gain, dtype=g.dtype, device=g.device)
    return torch.clamp(g, old - max_delta_g, old + max_delta_g)
