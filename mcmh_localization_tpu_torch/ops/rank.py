"""Sorted-rank resampling expansion: ``rank_in_sorted`` and ``expand_sorted``.

Port of ``mcmh_localization_tpu/ops/rank_pallas.py``; the CUDA kernels are
``csrc/rank.cu``.  Output slot ``m`` belongs to the particle whose segment
``[bound[j-1], bound[j])`` covers it, i.e. ``#{j : bound[j] <= m}`` clipped
to ``[0, R-1]``; with ``count`` given, slots at or past ``count`` repeat
slot ``count - 1`` (the TPU kernel's tail rule).  The TPU kernel's windowed
merge, its DMA windows and its ``lax.cond`` scatter fallback are TPU
mechanics: a binary search per slot is exact for any weights.
"""

from __future__ import annotations

import torch

from mcmh_localization_tpu_torch.ops import _cuda


def _slot_values(num_out: int, count, device) -> torch.Tensor:
    m = torch.arange(num_out, dtype=torch.int64, device=device)
    cap = torch.as_tensor(num_out - 1, dtype=torch.int64, device=device)
    if count is not None:
        cap = torch.minimum(torch.as_tensor(count, device=device).to(torch.int64) - 1, cap)
    return torch.minimum(m, cap)


def rank_in_sorted_plain(bound: torch.Tensor, num_out: int,
                         count=None) -> torch.Tensor:
    v = _slot_values(num_out, count, bound.device)
    idx = torch.searchsorted(bound.to(torch.int64), v, right=True)
    return idx.clamp(max=bound.shape[0] - 1).to(torch.int32)


def expand_sorted_plain(bound: torch.Tensor, particles: torch.Tensor,
                        num_out: int, count=None) -> torch.Tensor:
    return particles[rank_in_sorted_plain(bound, num_out, count).to(torch.int64)]


def _count_arg(count, device) -> torch.Tensor | None:
    if count is None:
        return None
    return torch.as_tensor(count, device=device).to(torch.int32).reshape(())


def rank_in_sorted(bound: torch.Tensor, num_out: int,
                   count=None) -> torch.Tensor:
    """(num_out,) int32 ranks of the output slots in the nondecreasing
    int32 ``bound`` (R,).  ``count``: optional int or 0-d tensor."""
    if bound.device.type == "cpu":
        return rank_in_sorted_plain(bound, num_out, count)
    cnt = _count_arg(count, bound.device)
    _cuda.require_cuda("rank_in_sorted", bound,
                       *(() if cnt is None else (cnt,)))
    if bound.dtype != torch.int32 or bound.dim() != 1:
        raise ValueError("rank_in_sorted: bound must be 1-D int32")
    out = torch.empty(num_out, dtype=torch.int32, device=bound.device)
    code = _cuda.library().mcmh_rank_in_sorted(
        bound.data_ptr(), bound.shape[0], num_out,
        None if cnt is None else cnt.data_ptr(), out.data_ptr(),
        _cuda.stream_of(bound),
    )
    _cuda.check_launch("rank_in_sorted", code)
    return out


def expand_sorted(bound: torch.Tensor, particles: torch.Tensor, num_out: int,
                  count=None) -> torch.Tensor:
    """(num_out, C) ``particles[rank_in_sorted(bound, num_out, count)]`` in
    one pass, bitwise equal to the two-step form."""
    if bound.device.type == "cpu":
        return expand_sorted_plain(bound, particles, num_out, count)
    cnt = _count_arg(count, bound.device)
    _cuda.require_cuda("expand_sorted", bound, particles,
                       *(() if cnt is None else (cnt,)))
    if bound.dtype != torch.int32 or bound.dim() != 1:
        raise ValueError("expand_sorted: bound must be 1-D int32")
    if particles.dtype != torch.float32 or particles.dim() != 2:
        raise ValueError("expand_sorted: particles must be 2-D float32")
    if particles.shape[0] != bound.shape[0]:
        raise ValueError("expand_sorted: one bound per particle row")
    c = particles.shape[1]
    out = torch.empty((num_out, c), dtype=torch.float32, device=bound.device)
    code = _cuda.library().mcmh_expand_sorted(
        bound.data_ptr(), bound.shape[0], particles.data_ptr(), c, num_out,
        None if cnt is None else cnt.data_ptr(), out.data_ptr(),
        _cuda.stream_of(bound),
    )
    _cuda.check_launch("expand_sorted", code)
    return out
