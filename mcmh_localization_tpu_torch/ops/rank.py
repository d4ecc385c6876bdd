"""Sorted-rank resampling expansion: ``rank_in_sorted`` and ``expand_sorted``.

Port of ``mcmh_localization_tpu/ops/rank_pallas.py`` together with the
running max that the JAX package's ``_segment_bounds`` applies first; the
CUDA kernels are ``csrc/rank.cu``.  ``bound`` is the raw int32 segment
bound, which may dip where a parallel cumsum lost an ulp: both functions
rank against its running max ``M``.  Output slot ``m`` belongs to the
particle whose segment ``[M[j-1], M[j])`` covers it, i.e.
``#{j : M[j] <= m}`` clipped to ``[0, R-1]``; with ``count`` given, slots at
or past ``count`` repeat slot ``count - 1`` (the TPU kernel's tail rule).
That rank is the index of the first raw ``bound[j] > m``, so the result is
bitwise the JAX function's on ``jax.lax.cummax(bound)``.  The TPU kernel's
windowed merge, its DMA windows and its ``lax.cond`` scatter fallback are
TPU mechanics: the CUDA versions scan the bound once and expand, exact for
any weights.  ``rank_in_sorted`` is one launch that keeps a small
workspace across calls (``_Workspace``, tagged with a host epoch, so it
raises under a CUDA graph capture); ``expand_sorted`` launches the scan
and the expansion after a memset of its look-back words, which a captured
step replays as a memset node, so it is replay-safe.
"""

from __future__ import annotations

import torch

from mcmh_localization_tpu_torch.ops import _cuda

MAX_COLS = 4  # csrc/rank.cu's kMaxCols: particle columns staged per slot
# expand_sorted launches the scan and the expansion (after a memset of the
# look-back words); the launch count counts both kernels
_EXPAND_KERNELS = 2


def _slot_values(num_out: int, count, device) -> torch.Tensor:
    m = torch.arange(num_out, dtype=torch.int64, device=device)
    cap = torch.as_tensor(num_out - 1, dtype=torch.int64, device=device)
    if count is not None:
        cap = torch.minimum(torch.as_tensor(count, device=device).to(torch.int64) - 1, cap)
    return torch.minimum(m, cap)


def rank_in_sorted_plain(bound: torch.Tensor, num_out: int,
                         count=None) -> torch.Tensor:
    """Plain version: ``torch.cummax`` of the bound, then a search."""
    mono = torch.cummax(bound.to(torch.int64), dim=0).values
    v = _slot_values(num_out, count, bound.device)
    idx = torch.searchsorted(mono, v, right=True)
    return idx.clamp(max=bound.shape[0] - 1).to(torch.int32)


def expand_sorted_plain(bound: torch.Tensor, particles: torch.Tensor,
                        num_out: int, count=None) -> torch.Tensor:
    return particles[rank_in_sorted_plain(bound, num_out, count).to(torch.int64)]


def _count_arg(count, device) -> torch.Tensor | None:
    if count is None:
        return None
    return torch.as_tensor(count, device=device).to(torch.int32).reshape(())


def _scan_buffers(bound: torch.Tensor):
    """The running max (R,) int32 and the look-back status words the scan
    kernel writes (it zeroes them itself, on the stream)."""
    r = bound.shape[0]
    words = _cuda.library().mcmh_rank_scratch_words(r)
    return (torch.empty(r, dtype=torch.int32, device=bound.device),
            torch.empty(words, dtype=torch.int64, device=bound.device))


def _check_bound(name: str, bound: torch.Tensor) -> None:
    if bound.dtype != torch.int32 or bound.dim() != 1 or bound.shape[0] == 0:
        raise ValueError(f"{name}: bound must be 1-D int32, not empty")


class _Workspace:
    """csrc/rank.cu's kernel-4 workspace on one stream: the ticket and
    finished-tile counters (each call leaves them at 0), the go word, the
    piece count and the look-back status words (tagged with the call's
    epoch), zeroed once when made, so no call zeroes them.  Calls on one
    stream run in order; each stream has its own workspace."""

    _by_stream: dict = {}

    def __init__(self, words: int, device):
        self.words = torch.zeros(words, dtype=torch.int64, device=device)
        self.epoch = 0

    @classmethod
    def next_epoch(cls, bound: torch.Tensor):
        """(words tensor, epoch) for the next call on ``bound``'s stream."""
        lib = _cuda.library()
        need = lib.mcmh_rank_workspace_words(bound.shape[0])
        key = (bound.device, _cuda.stream_of(bound))
        ws = cls._by_stream.get(key)
        if ws is None or ws.words.numel() < need:
            ws = cls._by_stream[key] = cls(need, bound.device)
        ws.epoch += 1
        if ws.epoch >= lib.mcmh_rank_epoch_limit():
            ws.words.zero_()
            ws.epoch = 1
        return ws.words, ws.epoch


def rank_in_sorted(bound: torch.Tensor, num_out: int,
                   count=None) -> torch.Tensor:
    """(num_out,) int32 ranks of the output slots in the running max of
    the int32 ``bound`` (R,).  ``count``: optional int or 0-d tensor."""
    if bound.device.type == "cpu":
        return rank_in_sorted_plain(bound, num_out, count)
    if torch.cuda.is_current_stream_capturing():
        # the call's epoch is a host counter: a replay would repeat it
        raise RuntimeError("rank_in_sorted: its workspace epochs are not "
                           "replay-safe; it cannot be captured in a graph")
    cnt = _count_arg(count, bound.device)
    _cuda.require_cuda("rank_in_sorted", bound,
                       *(() if cnt is None else (cnt,)))
    _check_bound("rank_in_sorted", bound)
    lib = _cuda.library()
    r = bound.shape[0]
    words, epoch = _Workspace.next_epoch(bound)
    # scratch for heavy tiles only: their running max and their pieces
    mono = torch.empty(r, dtype=torch.int32, device=bound.device)
    pieces = torch.empty((lib.mcmh_rank_piece_capacity(r, num_out), 4),
                         dtype=torch.int32, device=bound.device)
    out = torch.empty(num_out, dtype=torch.int32, device=bound.device)
    code = lib.mcmh_rank_in_sorted(
        bound.data_ptr(), r, num_out,
        None if cnt is None else cnt.data_ptr(), epoch, words.data_ptr(),
        mono.data_ptr(), pieces.data_ptr(), out.data_ptr(),
        _cuda.stream_of(bound),
    )
    _cuda.check_launch("rank_in_sorted", code)
    return out


def expand_sorted(bound: torch.Tensor, particles: torch.Tensor, num_out: int,
                  count=None) -> torch.Tensor:
    """(num_out, C) ``particles[rank_in_sorted(bound, num_out, count)]`` in
    one call (the scan and the expansion), bitwise equal to the two-step
    form."""
    if bound.device.type == "cpu":
        return expand_sorted_plain(bound, particles, num_out, count)
    cnt = _count_arg(count, bound.device)
    _cuda.require_cuda("expand_sorted", bound, particles,
                       *(() if cnt is None else (cnt,)))
    _check_bound("expand_sorted", bound)
    if particles.dtype != torch.float32 or particles.dim() != 2:
        raise ValueError("expand_sorted: particles must be 2-D float32")
    if particles.shape[0] != bound.shape[0]:
        raise ValueError("expand_sorted: one bound per particle row")
    c = particles.shape[1]
    if not 1 <= c <= MAX_COLS:
        raise ValueError(f"expand_sorted: 1 to {MAX_COLS} columns, got {c}")
    mono, scratch = _scan_buffers(bound)
    out = torch.empty((num_out, c), dtype=torch.float32, device=bound.device)
    code = _cuda.library().mcmh_expand_sorted(
        bound.data_ptr(), bound.shape[0], particles.data_ptr(), c, num_out,
        None if cnt is None else cnt.data_ptr(), mono.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), _cuda.stream_of(bound),
    )
    _cuda.check_launch("expand_sorted", code, kernels=_EXPAND_KERNELS)
    return out
