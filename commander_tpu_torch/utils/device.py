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
