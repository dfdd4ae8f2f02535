"""Amplitude prior constraints: the CMB monopole and dipole (torch).

Counterpart of commander_tpu.sampling.priors (apply_cmb_dipole_prior,
comm_cmb_comp_mod.f90:129-163, and the COMP_MONOPOLE_PRIOR machinery,
applyMonoDipolePrior, comm_diffuse_comp_mod.f90:5738): after an amplitude
draw the CMB component's l <= 1 modes are zeroed, or a map's monopole and
dipole are fitted outside a mask and removed. No driver path calls them, as
in the JAX package.
"""
from __future__ import annotations

import torch


def project_out_monodipole(alm: torch.Tensor, keep_l0: bool = False,
                           keep_l1: bool = False) -> torch.Tensor:
    """alm[..., l, m] with its l = 0 (and l = 1) rows zeroed."""
    a = alm.clone()
    if not keep_l0:
        a[..., 0, :] = 0.0
    if not keep_l1:
        a[..., 1, :] = 0.0
    return a


def _basis(pix_vec: torch.Tensor, dtype) -> torch.Tensor:
    """(4, P): the monopole and the x, y, z dipole."""
    return torch.cat([torch.ones((1, pix_vec.shape[0]), dtype=dtype,
                                 device=pix_vec.device),
                      pix_vec.T.to(dtype)], dim=0)


def masked_monodipole_fit(maps: torch.Tensor, mask: torch.Tensor,
                          pix_vec: torch.Tensor):
    """The least-squares monopole and dipole of maps (..., P) over the
    pixels where mask (P,) is 1; pix_vec (P, 3). Returns (coefficients
    (..., 4) on the basis [1, x, y, z], their map (..., P))."""
    T = _basis(pix_vec, maps.dtype)
    G = (T * mask) @ T.T
    b = torch.einsum("...p,kp->...k", maps * mask, T)
    coeff = torch.einsum("kl,...l->...k", torch.linalg.inv(G), b)
    return coeff, torch.einsum("...k,kp->...p", coeff, T)


def subtract_masked_monopole(maps: torch.Tensor, mask: torch.Tensor,
                             pix_vec: torch.Tensor, dipole: bool = True):
    """maps less the monopole (and dipole) fitted outside the mask; returns
    (maps, the fitted coefficients (..., 4), the dipole's zeroed when
    dipole is False)."""
    coeff, _ = masked_monodipole_fit(maps, mask, pix_vec)
    if not dipole:
        coeff = coeff.clone()
        coeff[..., 1:] = 0.0
    return maps - torch.einsum("...k,kp->...p", coeff,
                               _basis(pix_vec, maps.dtype)), coeff
