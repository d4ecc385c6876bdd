"""Beam score-field build: ``out[b, c] = sum_g s[b, g, qt[g, c]]``.

Port of ``mcmh_localization_tpu/ops/beam_field_pallas.py``; the CUDA kernel
is ``csrc/beam_field.cu``.  The TPU kernel's one-hot MXU products over int8
hi/lo planes of ``s`` are TPU mechanics: here each output is a sum of K
reads from a table in shared memory, in ascending ``g`` from 0.0 with f32
adds, so the plain version and the kernel agree bitwise and neither
quantizes ``s``.  A block of the kernel owns a tile of cells and a group
of consecutive ``b``; ``lut_tiles`` picks the layout, and ``lut_plan`` the
bins a block stages at once: all K where they fit its shared memory, else
chunks of them, each output's sum carried across the chunks in ascending
``g`` (the TPU kernel chunks over K too).

``lut_field_at`` builds the fine field over a window of the whole (K, H,
W) table at a window origin held in device memory
(``mcmh_lut_field_at``, whose launches count as ``lut_field_at``): the
corner is never read on the host, so a captured step replays with each
scan's own window.  ``lut_field`` takes its (K, C) cells as given.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mcmh_localization_tpu_torch.ops import _cuda
from mcmh_localization_tpu_torch.ops.fused_score import window_cells

# the dynamic shared memory one block can hold on Hopper (227 KB), and
# one SM's (228 KB; the card keeps 1 KB of it a block)
MAX_SMEM_BYTES = 232_448
SM_SMEM_BYTES = 233_472
# A plan that chunks the bins sizes its chunks for this many blocks an SM:
# the fine build at 360 bins took 0.79 ms at one block an SM (two chunks
# of 180), 0.52 at three (six of 60), 0.50 at four (eight of 48) and 0.51
# at six (twelve of 32) (chip_kernel_ab.py --kernels 7k on an H100,
# PERF.md §6).
LUT_CHUNK_BLOCKS = 4


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
    """A block's shared memory for a chunk of ``k`` bins: ``bpar`` LUT
    slots of k * nq floats, each rounded up to 16 bytes, and its ``qt``
    tile (k rows of its cells' bytes)."""
    return -(-k * nq // 4) * 16 * tile.bpar + k * tile.threads


class LutPlan(NamedTuple):
    """One ``lut_field`` call: the layout, and ``chunk`` bins staged at a
    time (K where all of them fit)."""

    tile: LutTile
    chunk: int


@functools.lru_cache(maxsize=64)
def lut_plan(b: int, k: int, nq: int, c: int) -> LutPlan:
    """The launch plan for B LUTs of K bins and nq levels over C cells:
    ``lut_tiles``' layout, and all K bins at once where their LUT slots and
    qt tile fit ``MAX_SMEM_BYTES``.  Else chunks of bins small enough that
    ``LUT_CHUNK_BLOCKS`` blocks share an SM (where one bin allows that; else
    as many bins as one block holds): the fewest such chunks, of equal
    size rounded up to a multiple of 4 bins where that still fits (so every
    chunk's LUT rows start on 16 bytes).  Raises where one bin does not fit
    a block."""
    tile = lut_tiles(b, c)
    if lut_smem_bytes(k, nq, tile) <= MAX_SMEM_BYTES:
        return LutPlan(tile, k)
    fit = _most_bins(nq, tile, SM_SMEM_BYTES // LUT_CHUNK_BLOCKS - 1024)
    if fit == 0:
        fit = _most_bins(nq, tile, MAX_SMEM_BYTES)
    if fit == 0:
        raise ValueError(
            f"lut_field: one bin needs {lut_smem_bytes(1, nq, tile)} bytes of "
            f"shared memory (nq={nq}, {tile.bpar} LUTs and {tile.threads} "
            f"cells a block), above the {MAX_SMEM_BYTES} bytes a block can "
            "hold")
    n = -(-k // fit)
    chunk = -(-k // n)
    round4 = -(-chunk // 4) * 4
    return LutPlan(tile, round4 if round4 <= fit else chunk)


def _most_bins(nq: int, tile: LutTile, budget: int) -> int:
    """The most bins whose LUT slots and qt tile fit ``budget`` bytes
    (``lut_smem_bytes`` grows with the bins)."""
    fit = budget // (4 * nq * tile.bpar + tile.threads)
    while lut_smem_bytes(fit + 1, nq, tile) <= budget:
        fit += 1
    while fit > 0 and lut_smem_bytes(fit, nq, tile) > budget:
        fit -= 1
    return fit


def lut_chunks(k: int, chunk: int) -> list[tuple[int, int]]:
    """The bin ranges [g0, g1) a block sums, in its order."""
    return [(g0, min(g0 + chunk, k)) for g0 in range(0, k, chunk)]


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
    tile, chunk = lut_plan(b, k, nq, c)
    out = torch.empty((b, c), dtype=torch.float32, device=qt.device)
    code = _cuda.library().mcmh_lut_field(
        qt.data_ptr(), s.data_ptr(), b, k, nq, c, *tile, chunk,
        out.data_ptr(), _cuda.stream_of(qt),
    )
    _cuda.check_launch("lut_field", code)
    return out


def lut_field_at_plain(qt: torch.Tensor, s: torch.Tensor,
                       origin: torch.Tensor, win: int) -> torch.Tensor:
    """Plain PyTorch version: the window gathered out, then
    ``lut_field_plain`` on it."""
    k = qt.shape[0]
    return lut_field_plain(
        window_cells(qt, origin, win, win).reshape(k, win * win), s)


def lut_field_at(qt: torch.Tensor, s: torch.Tensor, origin: torch.Tensor,
                 win: int) -> torch.Tensor:
    """(B, win * win) float32 field over the ``win`` x ``win`` window of
    ``qt`` (K, H, W) int8 whose corner (oy0, ox0) the int32 tensor
    ``origin`` holds (its first two entries, inside ``[0, H - win]`` x
    ``[0, W - win]``: the caller clamps them); ``s`` (B, K, nq) float32.
    Bitwise ``lut_field`` of the window copied out.  CPU tensors take the
    plain version."""
    if qt.device.type == "cpu":
        return lut_field_at_plain(qt, s, origin, win)
    _cuda.require_cuda("lut_field_at", qt, s, origin)
    if qt.dtype != torch.int8 or qt.dim() != 3:
        raise ValueError("lut_field_at: qt must be (K, H, W) int8")
    if s.dtype != torch.float32 or s.dim() != 3 or s.shape[1] != qt.shape[0]:
        raise ValueError("lut_field_at: s must be (B, K, nq) float32 with "
                         "qt's K")
    if origin.dtype != torch.int32 or origin.dim() != 1 or origin.shape[0] < 2:
        raise ValueError("lut_field_at: origin must be int32 (oy0, ox0[, ...])")
    k, h, w = qt.shape
    if not 0 < win <= min(h, w):
        raise ValueError(f"lut_field_at: a {win}-cell window does not fit the "
                         f"({h}, {w}) table")
    b, _, nq = s.shape
    tile, chunk = lut_plan(b, k, nq, win * win)
    out = torch.empty((b, win * win), dtype=torch.float32, device=qt.device)
    code = _cuda.library().mcmh_lut_field_at(
        qt.data_ptr(), s.data_ptr(), b, k, nq, h, w, win, origin.data_ptr(),
        *tile, chunk, out.data_ptr(), _cuda.stream_of(qt))
    _cuda.check_launch("lut_field_at", code)
    return out
