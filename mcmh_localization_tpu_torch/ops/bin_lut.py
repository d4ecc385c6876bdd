"""The beam score field's bin-sum LUT matrix: ``S[r, g, q] = sum of
lp[j, q] over the beams j with idx[r, j] == g``.

The JAX package computes it with a one-hot einsum
(``mcmh_localization_tpu/models/range_table.py:233-246``), an XLA
contraction rather than a Pallas kernel; the CUDA kernel is
``csrc/bin_lut.cu``.  Both versions add each bin's beams in ascending j
with f32 adds, starting from the first beam's value (the order of a loop
over the beams, on every device), so the kernel and the plain version
agree bitwise.  A scatter-add (CUDA float atomics) or a matmul (the TF32
flag) would not fix that order.  Neither version sizes anything by the
data (the most beams in one bin), so a step that builds the LUT reads
nothing on the host and can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch

from mcmh_localization_tpu_torch.ops import _cuda

# the dynamic shared memory one block can hold on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448


def bin_lut_plain(idx: torch.Tensor, lp: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version, the kernel's arithmetic: one pass a beam in
    ascending j, each adding its LUT row into its bin of every r (no two
    r share a sum, so each add is one f32 add in that order); the sums
    start at -0.0 (which adds to any x as x) and a bin no beam reached is
    +0.0.  It reads nothing on the host, so a CPU step holds no host read
    either."""
    r_, m = idx.shape
    dev = lp.device
    idx = idx.to(torch.int64)
    rows = torch.arange(r_, device=dev)
    acc = torch.full((r_, k, lp.shape[1]), -0.0, dtype=torch.float32,
                     device=dev)
    for j in range(m):
        g = idx[:, j]
        acc[rows, g] = acc[rows, g] + lp[j]
    seen = torch.zeros((r_, k), dtype=torch.bool, device=dev)
    seen.scatter_(1, idx, True)
    return torch.where(seen[..., None], acc, 0.0)


def bin_lut_tile(k: int, nq: int) -> tuple[int, int]:
    """(qw, threads): the q columns a block owns, all nq where their (K,
    qw) sums fit a block's shared memory, and its threads (one a column,
    rounded up to whole warps).  Raises where one column does not fit."""
    qw = min(nq, (MAX_SMEM_BYTES - k) // (4 * k))
    if qw < 1:
        raise ValueError(f"bin_lut: K={k} bins do not fit a block's shared "
                         f"memory ({MAX_SMEM_BYTES} bytes)")
    return qw, -(-qw // 32) * 32


def bin_lut(idx: torch.Tensor, lp: torch.Tensor, k: int) -> torch.Tensor:
    """(R, K, nq) float32 ``S``: ``idx`` (R, M) integer table bins in [0,
    K) (a bin outside that range adds nothing on the card), ``lp`` (M, nq)
    float32.  CPU tensors take the plain version."""
    if lp.device.type == "cpu":
        return bin_lut_plain(idx, lp, k)
    idx = idx.to(torch.int32).contiguous()
    _cuda.require_cuda("bin_lut", idx, lp)
    if lp.dtype != torch.float32 or lp.dim() != 2:
        raise ValueError("bin_lut: lp must be (M, nq) float32")
    if idx.dim() != 2 or idx.shape[1] != lp.shape[0]:
        raise ValueError("bin_lut: idx must be (R, M) with lp's M")
    r_, m = idx.shape
    nq = lp.shape[1]
    qw, threads = bin_lut_tile(k, nq)
    out = torch.empty((r_, k, nq), dtype=torch.float32, device=lp.device)
    code = _cuda.library().mcmh_bin_lut(
        idx.data_ptr(), lp.data_ptr(), r_, m, k, nq, qw, threads,
        out.data_ptr(), _cuda.stream_of(lp))
    _cuda.check_launch("bin_lut", code)
    return out
