"""Windowed field score with the coarse out-of-window fallback.

Port of ``mcmh_localization_tpu/ops/fused_score_pallas.py``; the CUDA
kernels are ``csrc/fused_score.cu``.  Per particle: the pose's fine
(row, lane) in the theta-minor window table when the pose lies inside the
spatial and theta windows, else its coarse (row, lane); one read; then
``in_map ? value / denom : fill``.  The op-form flags (``fine_div``,
``theta_div``, ``clip_before_window``) select the forms of the two callers
(the corr scorer: all False; the beam score field: all True).  The TPU
kernel's one-hot MXU reads over bf16 planes are TPU mechanics: the read
here is exact, so the plain version and the kernel agree bitwise.  The
kernels take any contiguous (N, 3) pose array and any N: a view whose base
is not 16-byte aligned (``parts[1:]``) and an N that is not a multiple of
their poses a thread (``poses_per_thread``) are handled inside them.

The window's corner and first theta bin come from ``origin``, a (3,)
int32 device tensor (oy0, ox0, kstart), kstart 0 without a theta window,
which the ``_at`` kernels read (the step computes it on the card): their
launches count as ``window_score_at`` and ``window_escapees_at``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmh_localization_tpu_torch.models.sensor import BLIND_SCORE
from mcmh_localization_tpu_torch.ops import _cuda
from mcmh_localization_tpu_torch.ops._cuda import poses_per_thread
from mcmh_localization_tpu_torch.ops.gather import PI_F32
from mcmh_localization_tpu_torch.utils.f32 import divide, scalar


class WindowGeometry(NamedTuple):
    """One scan's fine window and coarse table for the lookup.

    Float fields are the f32 values as python floats: ``fine_scale`` is
    ``inv_res`` (multiply form) or ``res`` (``fine_div``); ``theta_scale``
    is ``n_theta / 2pi`` (or ``2pi / n_theta`` with ``theta_div``);
    ``res_c`` the coarse cell size; ``kc_scale`` is ``kc / 2pi``."""

    origin_x: float
    origin_y: float
    fine_scale: float
    theta_scale: float
    n_theta: int
    nbins: int
    fh: int
    fw: int
    h: int
    w: int
    kc: int
    hc: int
    wc: int
    res_c: float
    kc_scale: float
    fine_div: bool = False
    theta_div: bool = False
    clip_before_window: bool = False




def window_cells(table: torch.Tensor, origin: torch.Tensor, fh: int,
                 fw: int) -> torch.Tensor:
    """``table[..., oy0:oy0 + fh, ox0:ox0 + fw]`` at the (oy0, ox0) that
    ``origin`` holds: a gather on the table's device, so the corner is
    never read on the host."""
    dev = table.device
    o = origin.to(torch.int64)
    rows = o[0] + torch.arange(fh, device=dev)
    cols = o[1] + torch.arange(fw, device=dev)
    return table[..., rows[:, None], cols[None, :]]


def window_indices(particles: torch.Tensor, g: WindowGeometry,
                   origin: torch.Tensor):
    """(covered, row, lane, in_map) per particle: a fine-table index where
    ``covered``, else a coarse-table one (fused_score_pallas.py:71-115);
    with ``kc = 0`` (no coarse table) the clamped fine index throughout.
    ``origin``: the window's (oy0, ox0, kstart), read on the tensor's
    device as 0-d tensors, never on the host."""
    oy0, ox0, kstart = origin[0], origin[1], origin[2]
    px, py, pth = particles[:, 0], particles[:, 1], particles[:, 2]
    dx = px - g.origin_x
    dy = py - g.origin_y
    if g.fine_div:
        fx, fy = divide(dx, g.fine_scale), divide(dy, g.fine_scale)
    else:
        fx, fy = dx * g.fine_scale, dy * g.fine_scale
    mx, my = fx.to(torch.int32), fy.to(torch.int32)
    tpi = pth + PI_F32
    tb = divide(tpi, g.theta_scale) if g.theta_div else tpi * g.theta_scale
    tbin = tb.to(torch.int32) % g.n_theta
    k_rel = (tbin - kstart) % g.n_theta
    in_theta = k_rel < g.nbins
    tbin_w = torch.where(in_theta, k_rel, 0)
    in_map = (mx >= 0) & (mx < g.w) & (my >= 0) & (my < g.h)
    if g.clip_before_window:
        mxw = mx.clamp(0, g.w - 1) - ox0
        myw = my.clamp(0, g.h - 1) - oy0
    else:
        mxw, myw = mx - ox0, my - oy0
    covered = in_theta & (mxw >= 0) & (mxw < g.fw) & (myw >= 0) & (myw < g.fh)
    row_a = myw.clamp(0, g.fh - 1) * g.nbins + tbin_w
    lane_a = mxw.clamp(0, g.fw - 1)
    if not g.kc:  # no coarse table: every index is the clamped fine one
        return covered, row_a, lane_a, in_map
    cx = divide(dx, g.res_c).to(torch.int32).clamp(0, g.wc - 1)
    cy = divide(dy, g.res_c).to(torch.int32).clamp(0, g.hc - 1)
    ck = (tpi * g.kc_scale).to(torch.int32) % g.kc
    row_b = cy * g.kc + ck
    return (covered, torch.where(covered, row_a, row_b),
            torch.where(covered, lane_a, cx), in_map)


def _as_scalar(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return scalar(x, device)


def window_score_plain(fine: torch.Tensor, coarse: torch.Tensor,
                       particles: torch.Tensor, g: WindowGeometry, denom,
                       fill, count=None, *, origin: torch.Tensor
                       ) -> torch.Tensor:
    covered, row, lane, in_map = window_indices(particles, g, origin)
    row, lane = row.to(torch.int64), lane.to(torch.int64)
    v_fine = fine.reshape(-1)[torch.where(covered, row * g.fw + lane, 0)]
    v_coarse = coarse.reshape(-1)[torch.where(covered, 0, row * g.wc + lane)]
    v = torch.where(covered, v_fine, v_coarse)
    dev = particles.device
    out = torch.where(in_map, v / _as_scalar(denom, dev), _as_scalar(fill, dev))
    if count is not None:
        out = torch.where(torch.as_tensor(count, device=dev) > 0, out,
                          BLIND_SCORE)
    return out.to(torch.float32)


def window_args(g: WindowGeometry) -> _cuda.WindowArgs:
    """The geometry as the kernels' by-value C struct."""
    return _cuda.WindowArgs(
        g.origin_x, g.origin_y, g.fine_scale, g.theta_scale, PI_F32, g.res_c,
        g.kc_scale, BLIND_SCORE, g.n_theta, g.nbins, g.fh, g.fw, g.h, g.w,
        g.kc, g.hc, g.wc, int(g.fine_div), int(g.theta_div),
        int(g.clip_before_window))


def _check_origin(name: str, origin: torch.Tensor) -> None:
    if origin.dtype != torch.int32 or origin.shape != (3,):
        raise ValueError(f"{name}: origin must be a (3,) int32 tensor "
                         "(oy0, ox0, kstart)")


def window_score(fine: torch.Tensor, coarse: torch.Tensor,
                 particles: torch.Tensor, g: WindowGeometry, denom, fill,
                 count=None, *, origin: torch.Tensor) -> torch.Tensor:
    """(N,) scores: ``fine`` (fh * nbins, fw) and ``coarse`` (hc * kc, wc)
    f32 theta-minor tables, ``particles`` (N, 3); ``denom`` and ``fill``
    floats or 0-d tensors; with ``count`` (the 0-d int valid-beam count),
    the blind penalty where ``count <= 0``.  ``origin``: the (3,) int32
    window origin (oy0, ox0, kstart) that the kernel reads from device
    memory (``mcmh_window_score_at``).  CPU tensors take the plain
    version."""
    if particles.device.type == "cpu":
        return window_score_plain(fine, coarse, particles, g, denom, fill,
                                  count, origin=origin)
    dev = particles.device
    cnt = None if count is None else torch.as_tensor(
        count, device=dev).to(torch.int32).reshape(())
    # a 0-d tensor goes to the kernel by pointer, a python number by value
    denom, fill = (_as_scalar(x, dev) if isinstance(x, torch.Tensor)
                   else float(x) for x in (denom, fill))
    _cuda.require_cuda("window_score", fine, coarse, particles, origin,
                       *(x for x in (denom, fill, cnt)
                         if isinstance(x, torch.Tensor)))
    _check_origin("window_score", origin)
    if (fine.dtype != torch.float32 or coarse.dtype != torch.float32
            or particles.dtype != torch.float32):
        raise ValueError("window_score: tables and particles must be float32")
    if (fine.shape != (g.fh * g.nbins, g.fw)
            or coarse.shape != (g.hc * g.kc, g.wc)
            or particles.dim() != 2 or particles.shape[1] != 3):
        raise ValueError("window_score: table/particle shapes do not match "
                         "the geometry")
    n = particles.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    (denom_p, denom_v), (fill_p, fill_v) = (
        (x.data_ptr(), 0.0) if isinstance(x, torch.Tensor) else (None, x)
        for x in (denom, fill))
    cnt_p = None if cnt is None else cnt.data_ptr()
    code = _cuda.library().mcmh_window_score_at(
        fine.data_ptr(), coarse.data_ptr(), particles.data_ptr(), n, denom_p,
        denom_v, fill_p, fill_v, cnt_p, origin.data_ptr(), window_args(g),
        poses_per_thread(n), out.data_ptr(), _cuda.stream_of(particles))
    _cuda.check_launch("window_score_at", code)
    return out


def window_escapees_plain(particles: torch.Tensor, g: WindowGeometry,
                          origin: torch.Tensor) -> torch.Tensor:
    covered, _, _, in_map = window_indices(particles, g, origin)
    return (in_map & ~covered).sum().to(torch.int32)


def window_escapees(particles: torch.Tensor, g: WindowGeometry,
                    origin: torch.Tensor) -> torch.Tensor:
    """0-d int32 count of in-map particles the window does not cover: the
    coarse-build gate's count (JAX corr_field.py:553).  ``origin``: as
    ``window_score`` takes it (``mcmh_window_escapees_at``)."""
    if particles.device.type == "cpu":
        return window_escapees_plain(particles, g, origin)
    _cuda.require_cuda("window_escapees", particles, origin)
    _check_origin("window_escapees", origin)
    if particles.dtype != torch.float32 or particles.shape[1:] != (3,):
        raise ValueError("window_escapees: particles must be (N, 3) float32")
    n = particles.shape[0]
    out = torch.zeros(1, dtype=torch.int32, device=particles.device)
    code = _cuda.library().mcmh_window_escapees_at(
        particles.data_ptr(), n, origin.data_ptr(), window_args(g),
        poses_per_thread(n), out.data_ptr(), _cuda.stream_of(particles))
    _cuda.check_launch("window_escapees_at", code)
    return out.reshape(())
