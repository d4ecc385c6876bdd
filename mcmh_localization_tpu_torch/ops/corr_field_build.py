"""Correlation-field build: ``F[k, y, x] = sum_j padded[y + oy[k, j], x + ox[k, j]]``.

Port of ``mcmh_localization_tpu/ops/corr_field_pallas.py``; the CUDA kernel
is ``csrc/corr_field_build.cu``.  One kernel builds both staged programs'
fields: BIG's full-map field (all theta bins), SMALL's windowed field
(read in place at the window origin the step computes on the card,
models/corr_field.py) and the coarse fallback field.  The sum runs over
the beams in the order given (``models/corr_field.py::_bin_offsets``
orders each bin's beams by (oy, ox)); the kernel skips the invalid beams
(those at or past the zero-band row), which add +0.0, so it stays bitwise
equal to the plain version.
"""

from __future__ import annotations

import torch

from mcmh_localization_tpu_torch.ops import _cuda


def _base_index(padded: torch.Tensor, h: int, w: int,
                origin: torch.Tensor | None) -> torch.Tensor:
    """(h, w) flat index of each output cell's first read: the window's
    (oy0, ox0) corner (from ``origin``, on ``padded``'s device) plus the
    cell."""
    wp = padded.shape[1]
    dev = padded.device
    base = (torch.arange(h, device=dev)[:, None] * wp
            + torch.arange(w, device=dev)[None, :])
    if origin is not None:
        origin = origin.to(torch.int64)
        base = base + (origin[0] * wp + origin[1])
    return base


def corr_field_build_plain(padded: torch.Tensor, ox: torch.Tensor,
                           oy: torch.Tensor, h: int, w: int,
                           origin: torch.Tensor | None = None,
                           zero_row: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: one shifted-slab add per beam, every beam, in
    the order given (the kernel's summation order); a beam at or past
    ``zero_row`` adds +0.0."""
    k, m = ox.shape
    wp = padded.shape[1]
    if zero_row is None:
        zero_row = padded.shape[0] - h
    flat = padded.reshape(-1)
    base = _base_index(padded, h, w, origin)
    live = oy < zero_row                                     # (K, M)
    off = torch.where(live, oy.to(torch.int64) * wp + ox.to(torch.int64), 0)
    out = torch.zeros((k, h, w), dtype=torch.float32, device=padded.device)
    for j in range(m):
        vals = flat[base[None] + off[:, j, None, None]]
        out += torch.where(live[:, j, None, None], vals, 0.0)
    return out


def corr_field_build(padded: torch.Tensor, ox: torch.Tensor,
                     oy: torch.Tensor, h: int, w: int,
                     origin: torch.Tensor | None = None,
                     zero_row: int | None = None) -> torch.Tensor:
    """(K, h, w) float32 field.  ``padded`` (Hp, Wp) f32; ``ox``/``oy``
    (K, M) int32 slice starts.  Beams with ``oy >= zero_row`` are invalid
    and add nothing; ``zero_row`` defaults to ``Hp - h``, the row where the
    all-zero band the invalid beams point at starts (the last ``h`` rows).

    ``origin``: a window's (oy0, ox0) corner in ``padded``, an int32
    tensor on ``padded``'s device (the step's window origin, read by the
    kernel from device memory), with ``oy0 + max(oy) + h <= Hp`` and
    ``ox0 + max(ox) + w <= Wp`` over the valid beams; None reads from
    (0, 0).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if padded.device.type == "cpu":
        return corr_field_build_plain(padded, ox, oy, h, w, origin, zero_row)
    _cuda.require_cuda("corr_field_build", padded, ox, oy,
                       *(() if origin is None else (origin,)))
    if padded.dtype != torch.float32 or padded.dim() != 2:
        raise ValueError("corr_field_build: padded must be 2-D float32")
    if ox.dtype != torch.int32 or oy.dtype != torch.int32:
        raise ValueError("corr_field_build: ox/oy must be int32")
    if ox.shape != oy.shape or ox.dim() != 2:
        raise ValueError("corr_field_build: ox/oy must be (K, M) alike")
    if origin is not None and (origin.dtype != torch.int32
                               or origin.numel() < 2):
        raise ValueError("corr_field_build: origin must be int32 (oy0, ox0)")
    k, m = ox.shape
    hp, wp = padded.shape
    out = torch.empty((k, h, w), dtype=torch.float32, device=padded.device)
    code = _cuda.library().mcmh_corr_field_build(
        padded.data_ptr(), hp, wp, ox.data_ptr(), oy.data_ptr(), k, m,
        out.data_ptr(), h, w, hp - h if zero_row is None else zero_row,
        None if origin is None else origin.data_ptr(),
        _cuda.stream_of(padded),
    )
    _cuda.check_launch("corr_field_build", code)
    return out
