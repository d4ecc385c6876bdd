"""The device rule of the port's entry points: the card unless the caller
names another device.  There is no CPU fallback: without a card, a call
that asks for one raises."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is available (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev
