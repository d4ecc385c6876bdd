"""Beam score-field build: ``out[b, c] = sum_g s[b, g, qt[g, c]]``.

Port of ``mcmh_localization_tpu/ops/beam_field_pallas.py``; the CUDA kernel
is ``csrc/beam_field.cu``.  The TPU kernel's one-hot MXU products over int8
hi/lo planes of ``s`` are TPU mechanics: here each output is a sum of K
reads from a table in shared memory, in ascending ``g`` from 0.0 with f32
adds, so the plain version and the kernel agree bitwise and neither
quantizes ``s``.  A block of the kernel owns a tile of cells and a group
of consecutive ``b``; ``lut_tiles`` picks the layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmh_localization_tpu_torch.ops import _cuda

# the dynamic shared memory one block can hold on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448


class LutTile(NamedTuple):
    """One launch's layout: a block of ``threads`` threads owns ``threads``
    cells (one a thread) and ``bpar`` consecutive b, summed in one pass."""

    threads: int
    bpar: int


def lut_tiles(b: int, c: int) -> LutTile:
    """The kernel's layout for B LUTs over C cells.  A block sums four b
    over 256 cells where the grid still has 1.5 blocks for each of the
    card's ``_cuda.SM_COUNT`` SMs (one index read serves four LUTs), else
    two b over 128 cells: the beam path's coarse and fine builds, each the
    fastest of the layouts timed there on an H100 (PERF.md §6)."""
    blocks = -(-c // 256) * -(-b // 4)
    if 2 * blocks >= 3 * _cuda.SM_COUNT:
        return LutTile(threads=256, bpar=4)
    return LutTile(threads=128, bpar=2)


def lut_smem_bytes(k: int, nq: int, tile: LutTile) -> int:
    """A block's shared memory: ``bpar`` LUT slots of K * nq floats, each
    rounded up to 16 bytes, and its ``qt`` tile (K rows of its cells'
    bytes)."""
    return -(-k * nq // 4) * 16 * tile.bpar + k * tile.threads


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
    c = qt.shape[1]
    tile = lut_tiles(b, c)
    smem = lut_smem_bytes(k, nq, tile)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"lut_field: a block needs {smem} bytes of shared memory for "
            f"K={k}, nq={nq}, above the {MAX_SMEM_BYTES} bytes it can hold")
    out = torch.empty((b, c), dtype=torch.float32, device=qt.device)
    code = _cuda.library().mcmh_lut_field(
        qt.data_ptr(), s.data_ptr(), b, k, nq, c, *tile, out.data_ptr(),
        _cuda.stream_of(qt),
    )
    _cuda.check_launch("lut_field", code)
    return out
