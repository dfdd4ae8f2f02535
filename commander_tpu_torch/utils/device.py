"""The port's default device: the CUDA card.

Entry points take `device=None` and resolve it here. There is no fallback:
where no card is present the caller must ask for the CPU by name
(device="cpu"), as the CPU tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card, and raises
    where torch.cuda.is_available() is false."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "commander_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def randn(shape, generator: torch.Generator | None, dtype, device):
    """N(0, 1) draws of `shape` on `device`, made on the generator's own
    device and moved: a seeded generator gives the same numbers whatever
    device the work runs on (a CUDA generator drives a CPU run, as a
    card-against-CPU check needs). No copy where the two agree."""
    gdev = device if generator is None else generator.device
    return torch.randn(_shape(shape), generator=generator, dtype=dtype,
                       device=gdev).to(device)


def rand(shape, generator: torch.Generator | None, dtype, device):
    """U(0, 1) draws, as randn."""
    gdev = device if generator is None else generator.device
    return torch.rand(_shape(shape), generator=generator, dtype=dtype,
                      device=gdev).to(device)


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)
