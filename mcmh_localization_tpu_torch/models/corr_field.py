"""Correlation-field likelihood scorer (port of
``mcmh_localization_tpu/models/corr_field.py``, the two modes the staged
runner uses).

Per scan, ``F[k, cy, cx]`` is the summed per-beam log-likelihood a pose in
cell (cy, cx) with heading in theta bin k would get; each particle then
scores with one read of F.  Two modes:

* full map, all ``n_theta`` bins (the BIG program: no window);
* a spatial + theta window at ``window_origin`` with no coarse fallback
  (the SMALL program): out-of-window particles take the blind penalty.

The field build (``ops/corr_field_build.py``) and the fused per-particle
lookup (``ops/gather.py::corr_lookup``) are CUDA kernels on the card.  One
build serves every particle passed in, so the step scores the proposed and
previous sets in one call.  The coarse out-of-window fallback is ROADMAP
item 11.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mcmh_localization_tpu_torch.models.sensor import (
    INVALID_SCORE,
    log_likelihood_field,
)
from mcmh_localization_tpu_torch.ops.corr_field_build import corr_field_build
from mcmh_localization_tpu_torch.ops.gather import LookupGeometry, corr_lookup


def _bin_offsets(u, v, valid, inv_res, n_theta, pad_cells, zero_band_row,
                 bin_start=0, nbins=None):
    """(nbins, M) int32 slice-start offsets per theta bin (bin centers);
    invalid beams point at the all-zero band.  ``bin_start`` selects a
    circular window of ``nbins`` of the ``n_theta`` global bins."""
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


def correlation_field_scores(
    particles: torch.Tensor,
    ranges: torch.Tensor,
    angles: torch.Tensor,
    grid_map,
    config,
    log_field: torch.Tensor | None = None,
    n_theta: int = 180,
    window_origin: tuple | None = None,  # (oy0, ox0[, kstart]) python ints
    offsets: tuple | None = None,
) -> torch.Tensor:
    """(N,) per-particle scores via one field read each; the same
    normalization, blind penalty and motion-validity fold as the JAX scorer.

    ``offsets``: optional (ox, oy) from ``_bin_offsets`` (global zero-band
    row), to score with offsets computed elsewhere."""
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
    padded0 = F.pad(log_field, (pad, pad, pad, pad))
    zero_band_row = padded0.shape[0]

    win = config.corr_window_cells
    use_window = bool(win) and win < min(h, w) and window_origin is not None
    if use_window and config.corr_coarse_factor:
        raise NotImplementedError(
            "the coarse out-of-window fallback is ROADMAP item 11")
    tw = config.corr_theta_window_bins
    use_theta_win = bool(tw) and use_window and len(window_origin) == 3
    nbins = tw if use_theta_win else n_theta
    kstart = int(window_origin[2]) if use_theta_win else 0
    if offsets is None:
        ox, oy = _bin_offsets(u, v, valid, grid_map.inv_res, n_theta, pad,
                              zero_band_row, bin_start=kstart, nbins=nbins)
    else:
        ox, oy = (o.to(torch.int32) for o in offsets)

    dev = log_field.device
    if use_window:
        oy0 = min(max(int(window_origin[0]), 0), h - win)
        ox0 = min(max(int(window_origin[1]), 0), w - win)
        fh = fw = win
        side = win + 2 * pad
        region = padded0[oy0:oy0 + side, ox0:ox0 + side]
        padded = torch.cat([region, torch.zeros((win, side), device=dev)])
        oy = torch.where(oy >= zero_band_row, side, oy)
        occ_win = grid_map.occupancy[oy0:oy0 + fh, ox0:ox0 + fw]
    else:
        fh, fw = h, w
        padded = torch.cat([padded0,
                            torch.zeros((h, padded0.shape[1]), device=dev)])
        occ_win = grid_map.occupancy
    field = corr_field_build(padded.contiguous(), ox.contiguous(),
                             oy.to(torch.int32).contiguous(), fh, fw)

    n_valid = valid.sum().to(torch.int32)
    score_validity = config.motion_validity == "score"
    if score_validity:
        # non-free cells score INVALID_SCORE per valid beam (JAX :445-461)
        pen_total = INVALID_SCORE * n_valid.clamp(min=1).to(torch.float32)
        field = field + pen_total * torch.where(occ_win == 0, 0.0, 1.0)[None]

    geo = LookupGeometry(
        origin_x=grid_map.origin_xy[0], origin_y=grid_map.origin_xy[1],
        inv_res=grid_map.inv_res, n_theta=n_theta, nbins=nbins, fh=fh, fw=fw,
        map_h=h, map_w=w,
        kstart=kstart if use_theta_win else None,
        window=(ox0, oy0) if use_window else None,
    )
    return corr_lookup(field.contiguous(), particles.contiguous(), n_valid,
                       geo, config.score_aggregation, score_validity)
