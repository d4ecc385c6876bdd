"""Per-particle table lookups: ``gather_2d`` and the corr scorer's fused
``corr_lookup``.

Port of ``mcmh_localization_tpu/ops/gather_pallas.py``; the CUDA kernels
are ``csrc/gather.cu``.  The TPU kernel's bf16 hi/lo planes, chunk windows
and VMEM budget are TPU mechanics: here every lookup is an exact f32 read.

``corr_lookup`` fuses the per-particle index math and the masks and fills
of ``models/corr_field.py::correlation_field_scores`` (JAX :466-490 and
:641-665) into the read.  Its plain version is built on
``corr_lookup_indices``, which copies each JAX op form (``(p - origin) *
inv_res`` truncated to int32; floor-mod theta bins) so the index triples
equal the JAX package's bitwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mcmh_localization_tpu_torch.models.sensor import BLIND_SCORE, INVALID_SCORE
from mcmh_localization_tpu_torch.ops import _cuda

PI_F32 = float(np.float32(np.pi))  # jnp.pi as a weak f32 operand


def theta_scale(n_theta: int) -> float:
    """``n_theta / (2 pi)`` rounded to f32, as a weak python scalar is."""
    return float(np.float32(n_theta / (2.0 * math.pi)))


def gather_2d_plain(table: torch.Tensor, y: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    w = table.shape[1]
    return table.reshape(-1)[y.to(torch.int64) * w + x.to(torch.int64)]


def gather_2d(table: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[y[i], x[i]]`` for a (H, W) f32 table and (N,) int32
    indices, assumed in bounds (clip upstream, as in the JAX package).  The
    kernel takes ``_cuda.poses_per_thread(N)`` index pairs a thread and any
    contiguous ``y`` and ``x``, aligned or not."""
    if table.device.type == "cpu":
        return gather_2d_plain(table, y, x)
    _cuda.require_cuda("gather_2d", table, y, x)
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError("gather_2d: table must be 2-D float32")
    if y.dtype != torch.int32 or x.dtype != torch.int32 or y.shape != x.shape:
        raise ValueError("gather_2d: y/x must be int32 of one shape")
    n = y.numel()
    out = torch.empty(n, dtype=torch.float32, device=table.device)
    h, w = table.shape
    code = _cuda.library().mcmh_gather_2d(
        table.data_ptr(), h, w, y.data_ptr(), x.data_ptr(), n,
        _cuda.poses_per_thread(n), out.data_ptr(), _cuda.stream_of(table),
    )
    _cuda.check_launch("gather_2d", code)
    return out


class LookupGeometry(NamedTuple):
    """Static description of one scan's field for the per-particle lookup.

    ``origin_x``/``origin_y``/``inv_res`` are the map's f32 values as
    python floats.  ``theta_window`` / ``space_window``: the field covers
    ``nbins`` theta bins from the first bin kstart / an (fh, fw) window at
    the cell corner (oy0, ox0), values the lookup reads from its (3,)
    int32 ``origin`` (oy0, ox0, kstart) (the step's window origin, computed
    on the card); neither, all ``n_theta`` bins over the full map."""

    origin_x: float
    origin_y: float
    inv_res: float
    n_theta: int
    nbins: int
    fh: int
    fw: int
    map_h: int
    map_w: int
    theta_window: bool = False
    space_window: bool = False


def _windows(g: LookupGeometry, origin):
    """(kstart, (ox0, oy0)) of ``g``, 0-d tensors of ``origin``; None
    where the window is off."""
    if (g.theta_window or g.space_window) and origin is None:
        raise ValueError("corr_lookup: the geometry's windows need the "
                         "origin tensor")
    kstart = origin[2] if g.theta_window else None
    window = (origin[1], origin[0]) if g.space_window else None
    return kstart, window


def corr_lookup_indices(particles: torch.Tensor, g: LookupGeometry,
                        origin: torch.Tensor | None = None):
    """(tbin, myc, mxc, in_map, covered): the field index of each particle
    and its masks (JAX corr_field.py:466-490)."""
    kstart, window = _windows(g, origin)
    px, py, pth = particles[:, 0], particles[:, 1], particles[:, 2]
    mx = ((px - g.origin_x) * g.inv_res).to(torch.int32)
    my = ((py - g.origin_y) * g.inv_res).to(torch.int32)
    tbin = ((pth + PI_F32) * theta_scale(g.n_theta)).to(torch.int32) % g.n_theta
    if kstart is not None:
        k_rel = (tbin - kstart) % g.n_theta
        in_theta = k_rel < g.nbins
        tbin = torch.where(in_theta, k_rel, 0)
    else:
        in_theta = torch.ones_like(mx, dtype=torch.bool)
    in_map = (mx >= 0) & (mx < g.map_w) & (my >= 0) & (my < g.map_h)
    if window is not None:
        ox0, oy0 = window
        mxw = mx - ox0
        myw = my - oy0
        in_window = (mxw >= 0) & (mxw < g.fw) & (myw >= 0) & (myw < g.fh)
        mxc = mxw.clamp(0, g.fw - 1)
        myc = myw.clamp(0, g.fh - 1)
    else:
        in_window = torch.ones_like(in_map)
        mxc = mx.clamp(0, g.fw - 1)
        myc = my.clamp(0, g.fh - 1)
    return tbin, myc, mxc, in_map, in_window & in_theta


def corr_lookup_plain(field: torch.Tensor, particles: torch.Tensor,
                      n_valid: torch.Tensor, g: LookupGeometry,
                      aggregation: str, score_validity: bool,
                      origin: torch.Tensor | None = None) -> torch.Tensor:
    tbin, myc, mxc, in_map, covered = corr_lookup_indices(particles, g,
                                                          origin)
    flat = (tbin.to(torch.int64) * g.fh + myc) * g.fw + mxc
    totals = field.reshape(-1)[flat]
    totals = torch.where(in_map & covered, totals, 0.0)
    cnt = n_valid.clamp(min=1).to(torch.float32)
    score = totals if aggregation == "sum" else totals / cnt
    score = torch.where(in_map & ~covered, BLIND_SCORE, score)
    if score_validity:
        pen = INVALID_SCORE * cnt if aggregation == "sum" else INVALID_SCORE
        score = torch.where(in_map, score, pen)
    return torch.where(n_valid > 0, score, BLIND_SCORE).to(torch.float32)


def corr_lookup(field: torch.Tensor, particles: torch.Tensor,
                n_valid: torch.Tensor, g: LookupGeometry,
                aggregation: str, score_validity: bool,
                origin: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) per-particle corr scores read from ``field`` (nbins, fh, fw).

    ``n_valid`` is the scan's valid-beam count (0-d int32 tensor): the
    "mean" divisor, the "sum" invalid penalty scale, and the no-beam
    blind fill.  ``origin``: the (3,) int32 (oy0, ox0, kstart) of a
    geometry with ``theta_window`` / ``space_window``, which the kernel
    reads from device memory.  The kernel takes
    ``_cuda.poses_per_thread(N)`` poses a thread and any contiguous (N, 3)
    pose array, aligned or not."""
    if field.device.type == "cpu":
        return corr_lookup_plain(field, particles, n_valid, g, aggregation,
                                 score_validity, origin)
    n_valid = n_valid.to(torch.int32).reshape(())
    device_form = g.theta_window or g.space_window
    if device_form:
        if origin is None:
            raise ValueError("corr_lookup: the geometry's windows need the "
                             "origin tensor")
        if origin.dtype != torch.int32 or origin.shape != (3,):
            raise ValueError("corr_lookup: origin must be (3,) int32")
    _cuda.require_cuda("corr_lookup", field, particles, n_valid,
                       *((origin,) if device_form else ()))
    if field.dtype != torch.float32 or particles.dtype != torch.float32:
        raise ValueError("corr_lookup: field and particles must be float32")
    if field.shape != (g.nbins, g.fh, g.fw) or particles.shape[1:] != (3,):
        raise ValueError("corr_lookup: field/particles shape mismatch")
    n = particles.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=field.device)
    code = _cuda.library().mcmh_corr_lookup_at(
        field.data_ptr(), g.nbins, g.fh, g.fw, particles.data_ptr(), n,
        n_valid.data_ptr(), g.origin_x, g.origin_y, g.inv_res, PI_F32,
        theta_scale(g.n_theta), g.n_theta, int(g.theta_window),
        int(g.space_window), origin.data_ptr() if device_form else None,
        g.map_h, g.map_w, int(aggregation == "sum"), int(score_validity),
        BLIND_SCORE, INVALID_SCORE, _cuda.poses_per_thread(n),
        out.data_ptr(), _cuda.stream_of(field))
    _cuda.check_launch("corr_lookup", code)
    return out
