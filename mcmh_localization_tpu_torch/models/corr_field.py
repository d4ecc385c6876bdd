"""Correlation-field likelihood scorer (port of
``mcmh_localization_tpu/models/corr_field.py``).

Per scan, ``F[k, cy, cx]`` is the summed per-beam log-likelihood a pose in
cell (cy, cx) with heading in theta bin k would get; each particle then
scores with one read of F.  Three modes:

* full map, all ``n_theta`` bins (the staged BIG program: no window);
* a spatial + theta window at ``window_origin`` with no coarse fallback
  (the staged SMALL program): out-of-window particles take the blind
  penalty;
* the window with the coarse fallback (``corr_coarse_factor > 0``, the
  single-program configurations): out-of-window particles read a coarse
  full-map field built on the block-max-pooled log field.

The field builds (``ops/corr_field_build.py``), the fused per-particle
lookup (``ops/gather.py::corr_lookup``) and the windowed lookup with the
coarse fallback (``ops/fused_score.py::window_score``) are CUDA kernels on
the card.  One build serves every particle passed in, so the step scores
the proposed and previous sets in one call.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mcmh_localization_tpu_torch.models.sensor import (
    BLIND_SCORE,
    INVALID_SCORE,
    log_likelihood_field,
)
from mcmh_localization_tpu_torch.models.range_table import (
    _sharded_bin_stack,
    field_origin,
)
from mcmh_localization_tpu_torch.ops.corr_field_build import corr_field_build
from mcmh_localization_tpu_torch.ops.fused_score import (
    WindowGeometry,
    window_cells,
    window_escapees,
    window_score,
)
from mcmh_localization_tpu_torch.ops.gather import (
    LookupGeometry,
    corr_lookup,
    theta_scale,
)
from mcmh_localization_tpu_torch.ops.graph import run_if
from mcmh_localization_tpu_torch.utils.f32 import scalar

LOG_FLOOR_LOG = -13.815511  # log(1e-6), the coarse max-pool's pad value


def _bin_offsets(u, v, valid, inv_res, n_theta, pad_cells, zero_band_row,
                 bin_start=0, nbins=None):
    """(nbins, M) int32 slice-start offsets per theta bin, each bin's beams
    ordered by (oy, ox) (``_order_beams``): the field build's summation
    order, which reads neighbouring table rows one after another; the
    invalid beams come last."""
    return _order_beams(*_beam_offsets(u, v, valid, inv_res, n_theta,
                                       pad_cells, zero_band_row, bin_start,
                                       nbins), pad_cells)


def _order_beams(ox, oy, pad_cells):
    """Each row's beams sorted by (oy, ox), ties in beam order.  Valid
    offsets lie in [0, 2 * pad_cells]; an invalid beam's oy is the zero
    band's row, past every valid one."""
    key = oy.to(torch.int64) * (2 * pad_cells + 1) + ox
    order = torch.sort(key, dim=1, stable=True).indices
    return ox.gather(1, order), oy.gather(1, order)


def _beam_offsets(u, v, valid, inv_res, n_theta, pad_cells, zero_band_row,
                  bin_start=0, nbins=None):
    """(nbins, M) int32 slice-start offsets per theta bin (bin centers), in
    beam order as the JAX package computes them; invalid beams point at the
    all-zero band.  ``bin_start`` selects a circular window of ``nbins`` of
    the ``n_theta`` global bins."""
    if nbins is None:
        nbins = n_theta
    thetas = (
        (bin_start + torch.arange(nbins, dtype=torch.float32, device=u.device)
         + 0.5) * (2.0 * math.pi / n_theta) - math.pi
    )
    c = torch.cos(thetas)[:, None]
    s = torch.sin(thetas)[:, None]
    ox = ((c * u[None, :] - s * v[None, :]) * inv_res).to(torch.int32) + pad_cells
    oy = ((s * u[None, :] + c * v[None, :]) * inv_res).to(torch.int32) + pad_cells
    ox = ox.clamp(0, 2 * pad_cells)
    oy = oy.clamp(0, 2 * pad_cells)
    ox = torch.where(valid[None, :], ox, 0)
    oy = torch.where(valid[None, :], oy, zero_band_row)
    return ox.to(torch.int32).contiguous(), oy.to(torch.int32).contiguous()


def pad_cells_for(config, grid_map) -> int:
    return int(-(-config.max_range // grid_map.res)) + 2


def coarse_shape(config, h: int, w: int) -> tuple[int, int, int]:
    """(kc, hc, wc) of the coarse fallback field for an (h, w) map."""
    f = config.corr_coarse_factor
    return config.corr_coarse_n_theta, -(-h // f), -(-w // f)


def coarse_build_inputs(u, v, valid, log_field, grid_map, config,
                        offsets=None):
    """(padded, ox, oy): the coarse field build's table and bin offsets
    (JAX :152-175).  The table is the f x f block MAX of the log field (an
    optimistic bound, so out-of-window hypotheses are not handicapped
    against fine scores), zero-padded, with the all-zero band below it that
    invalid beams point at.  ``offsets``: optional (ox, oy) computed
    elsewhere."""
    f = config.corr_coarse_factor
    kc, hc, wc = coarse_shape(config, *log_field.shape)
    h, w = log_field.shape
    lf = F.pad(log_field.to(torch.float32), (0, wc * f - w, 0, hc * f - h),
               value=LOG_FLOOR_LOG)
    coarse_lf = lf.reshape(hc, f, wc, f).amax(dim=(1, 3))
    # res_c and 1 / res_c in python double, rounded to f32 once where they
    # meet f32 data (JAX :163-167; the fine path's inv_res is f32 math)
    res_c = f * grid_map.res
    pad_c = int(-(-config.max_range // res_c)) + 2
    padded = F.pad(coarse_lf, (pad_c, pad_c, pad_c, pad_c))
    zero_band_row = padded.shape[0]
    if offsets is None:
        ox, oy = _bin_offsets(u, v, valid, 1.0 / res_c, kc, pad_c,
                              zero_band_row)
    else:
        ox, oy = (o.to(torch.int32).contiguous() for o in offsets)
    padded = torch.cat([padded, torch.zeros((hc, padded.shape[1]),
                                            device=padded.device)])
    return padded.contiguous(), ox, oy


def _coarse_field(u, v, valid, log_field, grid_map, config, offsets=None):
    """(kc, hc, wc) coarse full-map fallback field (JAX :127-190), built by
    the field-build kernel at ``corr_coarse_n_theta`` bins; with
    motion_validity="score", blocks without a free cell take the invalid
    penalty."""
    f = config.corr_coarse_factor
    _, hc, wc = coarse_shape(config, *log_field.shape)
    h, w = log_field.shape
    padded, ox, oy = coarse_build_inputs(u, v, valid, log_field, grid_map,
                                         config, offsets)
    field = corr_field_build(padded, ox, oy, hc, wc)
    if config.motion_validity == "score":
        free = F.pad((grid_map.occupancy == 0).to(torch.uint8),
                     (0, wc * f - w, 0, hc * f - h))
        any_free = free.reshape(hc, f, wc, f).amax(dim=(1, 3)) > 0
        count = valid.sum().to(torch.float32)
        field = field + (INVALID_SCORE * count.clamp(min=1.0)) * torch.where(
            any_free, 0.0, 1.0)[None]
    return field.to(torch.float32)


def correlation_field_scores(
    particles: torch.Tensor,
    ranges: torch.Tensor,
    angles: torch.Tensor,
    grid_map,
    config,
    log_field: torch.Tensor | None = None,
    n_theta: int = 180,
    window_origin=None,  # (3,) int32 tensor, or (oy0, ox0[, kstart]) ints
    offsets: tuple | None = None,
    coarse_offsets: tuple | None = None,
    shard_bins_axis=None,  # a process group: the theta-sharded build
) -> torch.Tensor:
    """(N,) per-particle scores via one field read each; the same
    normalization, blind penalty, coarse fallback and motion-validity fold
    as the JAX scorer.

    ``window_origin``: the window's (oy0, ox0, kstart), the step's int32
    tensor on the card, clamped there (``filter/step.py::
    window_origin_at``), which the field build and the lookups read from
    device memory as it is; or a sequence (oy0, ox0[, kstart]) of ints,
    clamped by ``models/range_table.py::field_origin``.

    ``offsets``: optional (ox, oy) from ``_bin_offsets`` (global zero-band
    row), and ``coarse_offsets`` the coarse field's, to score with offsets
    computed elsewhere.

    ``shard_bins_axis``: a process group over whose ranks the field builds
    its theta bins (``models/range_table.py::_sharded_bin_stack``: rank r
    builds its bins from its rows of ``ox``/``oy``, one all_gather
    assembles the stack; JAX :299-309).  The coarse fallback stays a local
    build, as in JAX, so its escapee gate stays the rank's own: the gated
    build holds no collective."""
    if log_field is None:
        log_field = log_likelihood_field(grid_map, config)
    if config.step > 1:
        ranges = ranges[:: config.step]
        angles = angles[:: config.step]
    valid = torch.isfinite(ranges) & (ranges < config.max_range)

    h, w = log_field.shape
    pad = pad_cells_for(config, grid_map)
    safe_r = torch.where(valid, ranges, 0.0)
    u = (safe_r * torch.cos(angles)).to(torch.float32)
    v = (safe_r * torch.sin(angles)).to(torch.float32)
    padded0 = F.pad(log_field, (pad, pad, pad, pad)).contiguous()
    zero_band_row = padded0.shape[0]

    win = config.corr_window_cells
    use_window = bool(win) and win < min(h, w) and window_origin is not None
    use_coarse = use_window and bool(config.corr_coarse_factor)
    tw = config.corr_theta_window_bins
    dev = log_field.device
    use_theta_win = bool(tw) and use_window and len(window_origin) == 3
    origin = None
    if use_window:
        origin = (window_origin if isinstance(window_origin, torch.Tensor)
                  else field_origin(window_origin, h, w, win, use_theta_win,
                                    dev))
    nbins = tw if use_theta_win else n_theta
    if offsets is None:
        ox, oy = _bin_offsets(u, v, valid, grid_map.inv_res, n_theta, pad,
                              zero_band_row,
                              bin_start=origin[2] if use_theta_win else 0,
                              nbins=nbins)
    else:
        ox, oy = (o.to(torch.int32) for o in offsets)

    # the build reads the window in place at the device-held origin; the
    # beams at the zero-band row are the invalid ones
    fh, fw = (win, win) if use_window else (h, w)
    oy = oy.to(torch.int32)
    field = _sharded_bin_stack(
        lambda b, n: corr_field_build(padded0, ox[b:b + n].contiguous(),
                                      oy[b:b + n].contiguous(), fh, fw,
                                      origin=origin, zero_row=zero_band_row),
        nbins, shard_bins_axis)

    n_valid = valid.sum().to(torch.int32)
    score_validity = config.motion_validity == "score"
    if score_validity:
        # non-free cells score INVALID_SCORE per valid beam (JAX :445-461)
        occ_win = (window_cells(grid_map.occupancy, origin, fh, fw)
                   if use_window else grid_map.occupancy)
        pen_total = INVALID_SCORE * n_valid.clamp(min=1).to(torch.float32)
        field = field + pen_total * torch.where(occ_win == 0, 0.0, 1.0)[None]

    if use_coarse:
        # the window-score kernel reads the corner and the first bin from
        # the device-held origin
        return _window_scores_with_coarse(
            field, particles, u, v, valid, n_valid, log_field, grid_map,
            config, n_theta, origin, coarse_offsets)

    geo = LookupGeometry(
        origin_x=grid_map.origin_xy[0], origin_y=grid_map.origin_xy[1],
        inv_res=grid_map.inv_res, n_theta=n_theta, nbins=nbins, fh=fh, fw=fw,
        map_h=h, map_w=w, theta_window=use_theta_win, space_window=use_window,
    )
    return corr_lookup(field.contiguous(), particles.contiguous(), n_valid,
                       geo, config.score_aggregation, score_validity,
                       origin=origin)


def build_correlation_field(log_field, u, v, valid, inv_res, n_theta: int,
                            pad_cells: int) -> torch.Tensor:
    """(n_theta, H, W) full-map correlation field of one scan's beam
    endpoints ``u``, ``v`` (M,) f32 and ``valid`` (M,) bool on the (H, W)
    ``log_field`` (JAX :670-679, kept there for API compatibility): the
    field-build kernel over the log field zero-padded by ``pad_cells``,
    its invalid beams at the zero band's row.  On CPU tensors, the
    kernel's plain version."""
    h, w = log_field.shape
    padded = F.pad(log_field.to(torch.float32),
                   (pad_cells, pad_cells, pad_cells, pad_cells)).contiguous()
    zero_band_row = padded.shape[0]
    ox, oy = _bin_offsets(u, v, valid, inv_res, n_theta, pad_cells,
                          zero_band_row)
    return corr_field_build(padded, ox, oy, h, w, zero_row=zero_band_row)


def window_geometry(grid_map, config, n_theta, nbins, fh,
                    fw) -> WindowGeometry:
    """The corr scorer's lookup geometry for the window-score kernel: the
    multiply forms (``(p - origin) * inv_res``, ``(pth + pi) * n_theta /
    2pi``) and the coarse cell ``f32(f * res)`` divided (JAX :193-208).
    The window's corner and first bin are the origin's, which the kernel
    reads from device memory (``window_score(..., origin=)``)."""
    h, w = grid_map.height, grid_map.width
    kc, hc, wc = coarse_shape(config, h, w)
    return WindowGeometry(
        origin_x=grid_map.origin_xy[0], origin_y=grid_map.origin_xy[1],
        fine_scale=grid_map.inv_res, theta_scale=theta_scale(n_theta),
        n_theta=n_theta, nbins=nbins, fh=fh, fw=fw, h=h, w=w, kc=kc, hc=hc,
        wc=wc,
        res_c=float(np.float32(config.corr_coarse_factor * grid_map.res)),
        kc_scale=theta_scale(kc))


def _window_scores_with_coarse(field, particles, u, v, valid, n_valid,
                               log_field, grid_map, config, n_theta, origin,
                               coarse_offsets):
    """The windowed lookup with the coarse fallback (JAX :515-616): covered
    particles read the (nbins, fh, fw) fine ``field``, in-map escapees the
    coarse one, through the window-score kernel at the device-held
    ``origin`` (oy0, ox0, kstart).

    With ``coarse_gate_escapees`` the coarse build is ``run_if`` on the
    escapee count reaching the gate (JAX's 0-or-1-iteration while_loop,
    :553-565), its carry the blind fill: a conditional node in a captured
    step, so a skipped build costs nothing; a host if in an eager one."""
    nbins, fh, fw = field.shape
    kc, hc, wc = coarse_shape(config, *log_field.shape)
    geo = window_geometry(grid_map, config, n_theta, nbins, fh, fw)
    particles = particles.contiguous()
    mean = config.score_aggregation == "mean"
    cnt = n_valid.clamp(min=1).to(torch.float32)

    def coarse_build():
        cfield = _coarse_field(u, v, valid, log_field, grid_map, config,
                               offsets=coarse_offsets)
        return [cfield.transpose(0, 1).reshape(hc * kc, wc).contiguous()]

    if config.coarse_gate_escapees:
        # below the gate the escapees take the blind fill (:539-544):
        # BLIND_SCORE after the "mean" divide
        fill = BLIND_SCORE * cnt if mean else scalar(BLIND_SCORE, field.device)
        escaped = window_escapees(particles, geo, origin=origin)
        (cfield_t,) = run_if(escaped >= config.coarse_gate_escapees,
                             coarse_build,
                             [fill.expand(hc * kc, wc).contiguous()],
                             donate=True)
    else:
        (cfield_t,) = coarse_build()
    fine_t = field.transpose(0, 1).reshape(fh * nbins, fw).contiguous()
    denom = cnt if mean else 1.0
    if config.motion_validity == "score":
        fill_oom = INVALID_SCORE if mean else INVALID_SCORE * cnt
    else:
        fill_oom = 0.0
    return window_score(fine_t, cfield_t, particles, geo, denom, fill_oom,
                        count=n_valid, origin=origin)
