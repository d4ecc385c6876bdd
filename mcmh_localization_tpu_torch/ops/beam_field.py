"""Beam score-field build: ``out[b, c] = sum_g s[b, g, qt[g, c]]``.

Port of ``mcmh_localization_tpu/ops/beam_field_pallas.py``; the CUDA kernel
is ``csrc/beam_field.cu``.  The TPU kernel's one-hot MXU products over int8
hi/lo planes of ``s`` are TPU mechanics: here each output is a sum of K
reads from a table in shared memory, in ascending ``g`` from 0.0 with f32
adds, so the plain version and the kernel agree bitwise and neither
quantizes ``s``.
"""

from __future__ import annotations

import torch

from mcmh_localization_tpu_torch.ops import _cuda

# the dynamic shared memory one block can hold on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448


def lut_field_plain(qt: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one table read per bin, bins in ascending
    order (the kernel's summation order)."""
    b, k, _ = s.shape
    q = qt.to(torch.int64)
    acc = torch.zeros((b, qt.shape[1]), dtype=torch.float32, device=s.device)
    for g in range(k):
        acc += s[:, g, :].index_select(1, q[g])
    return acc


def lut_field(qt: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(B, C) float32 field.  ``qt`` (K, C) int8 with values in [0, nq)
    (``models/range_table.py::quantize_table`` guarantees the range);
    ``s`` (B, K, nq) float32.  CPU tensors take the plain version."""
    if qt.device.type == "cpu":
        return lut_field_plain(qt, s)
    _cuda.require_cuda("lut_field", qt, s)
    if qt.dtype != torch.int8 or qt.dim() != 2:
        raise ValueError("lut_field: qt must be 2-D int8")
    if s.dtype != torch.float32 or s.dim() != 3 or s.shape[1] != qt.shape[0]:
        raise ValueError("lut_field: s must be (B, K, nq) float32 with qt's K")
    b, k, nq = s.shape
    if k * nq * 4 > MAX_SMEM_BYTES:
        raise ValueError(
            f"lut_field: s[b] takes {k * nq * 4} bytes, above the "
            f"{MAX_SMEM_BYTES} bytes of shared memory a block can hold")
    c = qt.shape[1]
    out = torch.empty((b, c), dtype=torch.float32, device=qt.device)
    code = _cuda.library().mcmh_lut_field(
        qt.data_ptr(), s.data_ptr(), b, k, nq, c, out.data_ptr(),
        _cuda.stream_of(qt),
    )
    _cuda.check_launch("lut_field", code)
    return out
