"""Monotone row take, ``src[idx]`` for nondecreasing ``idx``.

Port of ``mcmh_localization_tpu/ops/take_pallas.py``; the CUDA kernel is
``csrc/take.cu``.  It is the take-only variant of the resampling expansion
(``ops/rank.py::expand_sorted``), reached through
``ops/resampling.py::systematic_resample_particles(impl="mxu")``.  The TPU
kernel's DMA window and its gather fallback are TPU mechanics: the kernel
copies element by element and is bitwise equal to ``src[idx]`` for any
in-range indices.
"""

from __future__ import annotations

import torch

from mcmh_localization_tpu_torch.ops import _cuda


def take_rows_monotone_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return src[idx.to(torch.int64)]


def take_rows_monotone(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, C) ``src[idx]``: ``src`` (N, C) float32, ``idx`` (M,) int32 in
    [0, N).  CPU tensors take the plain version."""
    if src.device.type == "cpu":
        return take_rows_monotone_plain(src, idx)
    _cuda.require_cuda("take_rows_monotone", src, idx)
    if src.dtype != torch.float32 or src.dim() != 2:
        raise ValueError("take_rows_monotone: src must be 2-D float32")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("take_rows_monotone: idx must be 1-D int32")
    n, c = src.shape
    m = idx.shape[0]
    out = torch.empty((m, c), dtype=torch.float32, device=src.device)
    code = _cuda.library().mcmh_take_rows(
        src.data_ptr(), n, c, idx.data_ptr(), m, out.data_ptr(),
        _cuda.stream_of(src),
    )
    _cuda.check_launch("take_rows_monotone", code)
    return out
