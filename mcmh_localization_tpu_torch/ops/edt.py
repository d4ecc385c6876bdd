"""Exact squared Euclidean distance transform of a 2-D occupancy grid.

Port of ``mcmh_localization_tpu/maps/edt.py::squared_edt_device``, which
the JAX package computes in XLA (two separable 1-D min-plus passes in f32,
chunked over columns).  The CUDA kernel is ``csrc/edt.cu``; the plain
version below is the same two passes as chunked min-plus products in
int64.  Both are exact integers, so they agree bitwise at every size, and
agree with JAX wherever JAX's f32 passes are exact (squared distances below
2^24).  A map with no occupied cell reads 1e12 in every cell, as in JAX.
"""

from __future__ import annotations

import torch

from mcmh_localization_tpu_torch.ops import _cuda

# the kernel's int32 arithmetic holds up to this side (csrc/edt.cu)
MAX_SIDE = 32767
EMPTY = 1e12      # every cell's value on a map with no occupied cell
_NONE = 1 << 40   # the plain version's "no occupied cell": above any sum


def _minplus_axis0(f: torch.Tensor, chunk: int) -> torch.Tensor:
    """``g[i, x] = min_j f[j, x] + (i - j)^2`` in int64, over chunks of at
    most ``chunk`` columns: (n, n, min(chunk, columns)) values at a time."""
    n, w = f.shape
    idx = torch.arange(n, dtype=torch.int64, device=f.device)
    d2 = (idx[:, None] - idx[None, :]) ** 2
    out = torch.empty_like(f)
    for c0 in range(0, w, chunk):
        fc = f[:, c0:c0 + chunk]
        out[:, c0:c0 + chunk] = (fc[None, :, :] + d2[:, :, None]).amin(dim=1)
    return out


def squared_edt_plain(occupied: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """(H, W) f32 squared distances in cells to the nearest True cell of
    ``occupied`` (H, W) bool: the column pass, then the row pass, each in
    column chunks of ``chunk``."""
    f = torch.where(occupied, 0, _NONE).to(torch.int64)
    g = _minplus_axis0(f, chunk)
    d2 = _minplus_axis0(g.T.contiguous(), chunk).T
    return torch.where(d2 >= _NONE, EMPTY, d2.to(torch.float32))


def squared_edt(occupied: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """(H, W) f32 exact squared distances in cells to the nearest occupied
    cell, ``occupied`` (H, W) bool.  CPU tensors take the plain version in
    column chunks of ``chunk``; CUDA tensors launch the kernel, which
    ignores ``chunk`` and raises past a side of ``MAX_SIDE``."""
    if occupied.dim() != 2 or occupied.dtype != torch.bool:
        raise ValueError("squared_edt: occupied must be a 2-D bool tensor")
    if occupied.device.type == "cpu":
        return squared_edt_plain(occupied, chunk)
    _cuda.require_cuda("squared_edt", occupied)
    h, w = occupied.shape
    if max(h, w) > MAX_SIDE:
        raise ValueError(
            f"squared_edt: a side of {max(h, w)} cells exceeds the kernel's "
            f"int32 limit of {MAX_SIDE}")
    out = torch.empty((h, w), dtype=torch.float32, device=occupied.device)
    if out.numel() == 0:
        return out
    scratch = torch.empty((h, w), dtype=torch.int32, device=occupied.device)
    code = _cuda.library().mcmh_squared_edt(
        occupied.data_ptr(), h, w, scratch.data_ptr(), out.data_ptr(),
        _cuda.stream_of(occupied))
    # the column pass and the row pass
    _cuda.check_launch("squared_edt", code, kernels=2)
    return out
