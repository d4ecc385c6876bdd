"""Device scalars and f32 division that round like the JAX package's on
every device, with no host wait, and a cumsum that sums in one order on
every device and run."""

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


# the row length of ``cumsum``'s fixed association
SCAN_ROW = 1024


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of the 1-D ``x`` in one fixed association on every
    device and in every run: rows of SCAN_ROW scanned along the row, then
    each row's total, scanned the same way, added to the rows after it.
    PyTorch's CUDA cumsum of a 1-D tensor (CUB's decoupled look-back scan)
    associates as its blocks happen to finish, so two runs on the same
    weights can differ by an ulp, and a resampling bound by one slot; its
    scan along the last dimension of a 2-D tensor sums in a fixed order."""
    n = x.shape[0]
    if n <= SCAN_ROW:  # two rows: a single one would take the 1-D scan
        pad = torch.nn.functional.pad(x, (0, 2 * SCAN_ROW - n))
        return pad.view(2, SCAN_ROW).cumsum(dim=1)[0, :n]
    rows = -(-n // SCAN_ROW)
    inner = torch.nn.functional.pad(x, (0, rows * SCAN_ROW - n)).view(
        rows, SCAN_ROW).cumsum(dim=1)
    before = torch.nn.functional.pad(cumsum(inner[:, -1])[:-1], (1, 0))
    return (inner + before[:, None]).reshape(-1)[:n]
