"""alm-layout utilities: metric inner products, white draws, masks.

The rectangular complex layout a[..., l, m] (m >= 0) carries the real-field
inner product <a,b> = sum_l [a_l0 b_l0 + 2 sum_{m>0} Re(a conj(b))]
(commander_tpu.sphere.alm).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import randn


def eps_weights(nm: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """(nm,): 1 for m=0, 2 for m>0."""
    w = torch.full((nm,), 2.0, dtype=dtype, device=device)
    w[:1] = 1.0     # (a slice: w[0] = 1.0 copies a host scalar and waits)
    return w


def triangle_mask(nl: int, nm: int) -> np.ndarray:
    """(nl, nm) float64: 1 on m <= l."""
    return np.tril(np.ones((nl, nm)))


def alm_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Epsilon-weighted real inner product over ALL axes (0-d tensor)."""
    eps = eps_weights(a.shape[-1], a.real.dtype, a.device)
    return torch.sum(eps * (a * b.conj()).real)


def random_alm_white(generator: torch.Generator, shape, dtype=torch.float64,
                     device=None) -> torch.Tensor:
    """Unit Gaussian alm under the eps metric: m=0 real N(0,1); m>0 re, im
    ~ N(0, 1/2). shape ends with (nl, nm); the caller applies triangle
    masks. The draws lie on `device` (None: the generator's device)."""
    if device is None:
        device = generator.device
    re = randn(shape, generator, dtype, device)
    im = randn(shape, generator, dtype, device)
    nm = shape[-1]
    sig = torch.full((nm,), 1.0 / np.sqrt(2.0), dtype=dtype, device=device)
    sig[:1] = 1.0
    re = re * sig
    im = im * sig
    im[..., 0] = 0.0
    return torch.complex(re, im)


def real_m0(alm: torch.Tensor) -> torch.Tensor:
    """Project m=0 coefficients onto the real axis (one real dof per
    (l, m=0) of a real field)."""
    out = alm.clone()
    out[..., 0] = alm[..., 0].real.to(alm.dtype)
    return out
