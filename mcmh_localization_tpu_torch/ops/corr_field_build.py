"""Correlation-field build: ``F[k, y, x] = sum_j padded[y + oy[k, j], x + ox[k, j]]``.

Port of ``mcmh_localization_tpu/ops/corr_field_pallas.py``; the CUDA kernel
is ``csrc/corr_field_build.cu``.  One kernel builds both staged programs'
fields: BIG's full-map field (all theta bins) and SMALL's windowed field
(the caller slices the window region first, models/corr_field.py), and the
coarse fallback field.  The sum runs over the beams in the order given
(``models/corr_field.py::_bin_offsets`` orders each bin's beams by
(oy, ox)); the kernel skips the beams that point at the all-zero band
(the last ``h`` rows of ``padded``), which add +0.0, so it stays bitwise
equal to the plain version.
"""

from __future__ import annotations

import torch

from mcmh_localization_tpu_torch.ops import _cuda


def corr_field_build_plain(padded: torch.Tensor, ox: torch.Tensor,
                           oy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch version: one shifted-slab add per beam, every beam, in
    the order given (the kernel's summation order)."""
    k, m = ox.shape
    wp = padded.shape[1]
    flat = padded.reshape(-1)
    dev = padded.device
    base = (torch.arange(h, device=dev)[:, None] * wp
            + torch.arange(w, device=dev)[None, :])
    off = oy.to(torch.int64) * wp + ox.to(torch.int64)      # (K, M)
    out = torch.zeros((k, h, w), dtype=torch.float32, device=dev)
    for j in range(m):
        out += flat[base[None] + off[:, j, None, None]]
    return out


def corr_field_build(padded: torch.Tensor, ox: torch.Tensor,
                     oy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(K, h, w) float32 field.  ``padded`` (Hp, Wp) f32; ``ox``/``oy``
    (K, M) int32 slice starts with ``max(oy) + h <= Hp`` and
    ``max(ox) + w <= Wp``; the last ``h`` rows of ``padded`` are zero, and
    invalid beams point there (``oy = Hp - h``).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if padded.device.type == "cpu":
        return corr_field_build_plain(padded, ox, oy, h, w)
    _cuda.require_cuda("corr_field_build", padded, ox, oy)
    if padded.dtype != torch.float32 or padded.dim() != 2:
        raise ValueError("corr_field_build: padded must be 2-D float32")
    if ox.dtype != torch.int32 or oy.dtype != torch.int32:
        raise ValueError("corr_field_build: ox/oy must be int32")
    if ox.shape != oy.shape or ox.dim() != 2:
        raise ValueError("corr_field_build: ox/oy must be (K, M) alike")
    k, m = ox.shape
    hp, wp = padded.shape
    out = torch.empty((k, h, w), dtype=torch.float32, device=padded.device)
    code = _cuda.library().mcmh_corr_field_build(
        padded.data_ptr(), hp, wp, ox.data_ptr(), oy.data_ptr(), k, m,
        out.data_ptr(), h, w, _cuda.stream_of(padded),
    )
    _cuda.check_launch("corr_field_build", code)
    return out
