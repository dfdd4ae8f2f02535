"""Pixel-space noise models: diagonal rms (white) and QU-covariance noise.

Counterpart of commander_tpu.instrument.noise. Masked pixels carry
invN = 0 (infinite noise), by zeroing rather than inf so that every product
stays finite. Tensors in keep their dtype; `device` None is the CUDA card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device


def _t(a, device):
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                           else a, device=device)


def _to(obj, device):
    return type(obj)(**{f.name: getattr(obj, f.name).to(device)
                        for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class DiagonalNoise:
    """White noise with per-pixel rms, per Stokes component.

    rms: (nmaps, npix), 1 where masked; mask: (nmaps, npix) 0/1 (1 = use
    the pixel)."""
    rms: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def create(rms, mask=None, reg_noise: float = 0.0,
               device=None) -> "DiagonalNoise":
        """Entries of rms that are <= 0 or not finite count as masked."""
        device = resolve_device(device)
        rms = _t(rms, device)
        good = torch.isfinite(rms) & (rms > 0)
        if mask is not None:
            good = good & (_t(mask, device) > 0.5)
        if reg_noise > 0.0:
            rms = torch.sqrt(rms ** 2 + reg_noise ** 2)
        safe = torch.where(good, rms, torch.ones_like(rms))
        return DiagonalNoise(rms=safe, mask=good.to(rms.dtype))

    def to(self, device) -> "DiagonalNoise":
        return _to(self, device)

    def invN(self, m):
        """N^-1 m (zero on masked pixels)."""
        return m * self.mask / self.rms ** 2

    def sqrt_invN(self, m):
        """N^-1/2 m."""
        return m * self.mask / self.rms

    def N(self, m):
        return m * self.mask * self.rms ** 2

    def rms_map(self):
        return torch.where(self.mask > 0, self.rms,
                           torch.zeros_like(self.rms))


@dataclasses.dataclass
class QUCovNoise:
    """Per-pixel 2x2 QU covariance with diagonal T noise.

    rms_T: (npix,); inv_QU, sqrt_inv_QU: (npix, 2, 2), the inverse
    covariance and the transposed Cholesky factor of it (so that
    sqrt_inv_QU^T sqrt_inv_QU = inv_QU); mask: (3, npix)."""
    rms_T: torch.Tensor
    inv_QU: torch.Tensor
    sqrt_inv_QU: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def create(rms_T, cov_QU, mask=None, device=None) -> "QUCovNoise":
        device = resolve_device(device)
        rms_T = _t(rms_T, device)
        cov_QU = _t(cov_QU, device)
        if mask is None:
            mask = torch.ones((3, rms_T.shape[-1]), dtype=rms_T.dtype,
                              device=device)
        inv = torch.linalg.inv(cov_QU)
        chol = torch.linalg.cholesky(inv)
        return QUCovNoise(rms_T=rms_T, inv_QU=inv,
                          sqrt_inv_QU=chol.transpose(-1, -2).contiguous(),
                          mask=_t(mask, device))

    def to(self, device) -> "QUCovNoise":
        return _to(self, device)

    def _apply(self, blocks, t, m):
        qu = torch.einsum("pij,jp->ip", blocks, m[1:] * self.mask[1:])
        return torch.cat([t[None], qu * self.mask[1:]], dim=0)

    def invN(self, m):
        """m: (3, npix) -> N^-1 m with the 2x2 coupling in QU."""
        return self._apply(self.inv_QU, m[0] * self.mask[0] / self.rms_T ** 2,
                           m)

    def sqrt_invN(self, m):
        return self._apply(self.sqrt_inv_QU,
                           m[0] * self.mask[0] / self.rms_T, m)
