"""The device an entry point runs on: the card unless the caller asks for
the CPU. The JAX package has no counterpart (its arrays go to JAX's default
backend)."""

from __future__ import annotations

import torch

#: every entry point's default device
DEFAULT = "cuda"


def as_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device is touched here, so a
    machine without a card raises torch's own error at construction instead
    of at the first kernel; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.empty(0, device=dev)
    return dev
