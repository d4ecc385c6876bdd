"""Device scalars and f32 division that round like the JAX package's on
every device, with no host wait."""

from __future__ import annotations

import torch


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` in IEEE f32 division.  The divisor goes in as a tensor on
    ``x``'s device: PyTorch's CUDA division by a python (CPU) scalar
    multiplies by its reciprocal, which rounds differently from XLA's
    division (and from this division on the CPU)."""
    return x / scalar(d, x.device)


def scalar(value, device, dtype=torch.float32) -> torch.Tensor:
    """A 0-d tensor on ``device`` filled on the device: ``torch.tensor``
    of a python number copies it from the host, and that copy waits for
    the device's queue to drain."""
    return torch.full((), value, dtype=dtype, device=device)
