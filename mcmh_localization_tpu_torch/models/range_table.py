"""Ray-cast range table and the beam score field (port of
``mcmh_localization_tpu/models/range_table.py``).

Once per map, ``build_range_table`` marches every theta bin's ray from
every cell centre: step i of bin k visits the cell at a fixed offset, so a
step is one shifted slice of the padded hit grid.  The table holds only
``nq = max_range / RAY_STEP + 1`` distinct values, so ``quantize_table``
stores it as int8 indices into those values.

Per scan the beam model's log-mixture collapses to an (M, nq) LUT, and the
score of a pose in (cell, theta bin) becomes a sum of K LUT reads through
the quantized table: ``field[b, c] = sum_g S[b, g, qt[g, c]]`` with
``S[b, g] = sum of the LUT rows of the beams whose ray falls in table bin
g`` (``ops/bin_lut.py::bin_lut`` builds S, ``ops/beam_field.py::
lut_field_at`` the field, CUDA kernels on the card).  The field covers a
spatial and theta window; out-of-window poses read a coarse full-map field
evaluated at block centres (built behind an escapee gate,
``ops/graph.py::run_if``), or take the blind penalty.  The windowed lookup
is ``ops/fused_score.py::window_score`` in the beam op forms (divide by the
resolution and the bin width, clip before the window).  The window's
origin stays on the device from the step to the lookup: the field build
and every read take it from device memory, so a step reads nothing on the
host and runs captured in a CUDA graph (``filter/captured.py``).

``raycast_table_scores`` reads the cell-major table once per (particle,
beam), with the bin math, the mixture and the beam sum fused around the
read (``ops/scan_scores.py::table_scores``, a CUDA kernel on the card; its
plain version takes a chunk of particles at a time): exact f32 values,
where the TPU read bf16.  The filter's sensor table holds it in its level
form (``ops/scan_scores.py::table_levels``: a byte a value, indexing the
table's distinct ranges), so the mixture is a per-scan LUT over the valid
beams x levels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mcmh_localization_tpu_torch.models.sensor import (
    BLIND_SCORE,
    INVALID_SCORE,
    LOG_FLOOR,
    RAY_STEP,
    hit_norm,
)
from mcmh_localization_tpu_torch.ops.beam_field import lut_field, lut_field_at
from mcmh_localization_tpu_torch.ops.bin_lut import bin_lut
from mcmh_localization_tpu_torch.ops.fused_score import (
    WindowGeometry,
    window_cells,
    window_escapees,
    window_indices,
    window_score,
)
from mcmh_localization_tpu_torch.ops.gather import PI_F32, gather_2d, theta_scale
from mcmh_localization_tpu_torch.ops.graph import run_always, run_if
from mcmh_localization_tpu_torch.ops.scan_scores import (
    Mixture,
    TableGeometry,
    TableLevels,
    table_scores,
)
from mcmh_localization_tpu_torch.utils import profiling
from mcmh_localization_tpu_torch.utils.f32 import divide, scalar


class BeamTables(NamedTuple):
    """Per-(map, config) precompute of the beam score field: the f32 range
    table, its int8 value-index form ``qt`` with the ``dvals`` it indexes,
    and ``qtc``, the block-centre subsample of ``qt`` for the coarse
    fallback (None when the fallback is off)."""

    table: torch.Tensor        # (K, H, W) float32
    qt: torch.Tensor           # (K, H, W) int8
    dvals: torch.Tensor        # (nq,) float32
    qtc: torch.Tensor | None   # (K, Hc, Wc) int8


def quantize_table(table: torch.Tensor, max_range: float,
                   step: float = RAY_STEP):
    """(K, H, W) f32 range table -> (int8 value-index table, (nq,) values);
    ``dvals[qt]`` gives the table back bit for bit (JAX :69-90)."""
    n_steps = int(max_range / step)
    # float64 products rounded once to f32, the values build_range_table
    # stores
    dvals = torch.from_numpy(np.concatenate(
        [np.arange(1, n_steps + 1) * step, [max_range]]).astype(np.float32)
    ).to(table.device)
    if n_steps + 1 > 127:
        raise ValueError("the int8 quantized table needs max_range / step "
                         "<= 126")
    qi = (divide(table, step) + 0.5).to(torch.int32) - 1
    qi = qi.clamp(0, n_steps - 1)
    qi = torch.where(table >= scalar(max_range, table.device), n_steps, qi)
    return qi.to(torch.int8), dvals


def make_beam_tables(grid_map, config) -> BeamTables:
    """The beam score field's precompute for a map (JAX :93-103): the
    range table's build and quantization, the span ``setup.beam_tables``
    under tracing (its host time: the launches, not their end)."""
    with profiling.span("setup.beam_tables"):
        table = build_range_table(grid_map, config.beam_table_n_theta,
                                  config.max_range)
        return as_beam_tables(table, config)


def as_beam_tables(table, config) -> BeamTables:
    """A BeamTables as it is, or one quantized from a (K, H, W) f32 range
    table (JAX ``_as_beam_tables``, :106-114)."""
    if isinstance(table, BeamTables):
        return table
    qt, dvals = quantize_table(table, config.max_range)
    f = config.corr_coarse_factor
    qtc = qt[:, f // 2::f, f // 2::f].contiguous() if f > 0 else None
    return BeamTables(table=table, qt=qt, dvals=dvals, qtc=qtc)


def build_range_table(grid_map, n_theta: int, max_range: float,
                      step: float = RAY_STEP,
                      hit_unknown: bool = False) -> torch.Tensor:
    """(n_theta, H, W) f32 ray-cast ranges from every cell centre at the
    bin-centre headings (JAX :117-180; ``models.sensor.raycast`` at cell
    centres): the first event of the march wins, a hit giving ``i * step``
    and a map exit ``max_range``.  The (K, S) cell offsets are numpy
    float64 from the f32 resolution, as JAX computes them, so the table is
    bitwise equal to JAX's."""
    occ = grid_map.occupancy
    h, w = occ.shape
    dev = occ.device
    res = grid_map.res
    n_steps = int(max_range / step)
    pad = int(np.ceil(max_range / res)) + 2
    thetas = -np.pi + (np.arange(n_theta) + 0.5) * (2.0 * np.pi / n_theta)
    dists = np.arange(1, n_steps + 1) * step
    dx = np.floor(0.5 + np.outer(np.cos(thetas), dists) / res).astype(np.int32)
    dy = np.floor(0.5 + np.outer(np.sin(thetas), dists) / res).astype(np.int32)
    dx, dy = ([[int(v) for v in row] for row in a + pad] for a in (dx, dy))
    d_steps = [float(v) for v in dists.astype(np.float32)]

    hit = occ > 50
    if hit_unknown:
        hit = hit | (occ != 0)
    # event codes on the padded grid: 0 nothing, 1 a hit, 2 off the map
    event = torch.full((h + 2 * pad, w + 2 * pad), 2, dtype=torch.int8,
                       device=dev)
    event[pad:pad + h, pad:pad + w] = hit.to(torch.int8)
    table = torch.empty((n_theta, h, w), dtype=torch.float32, device=dev)
    for k in range(n_theta):
        result = torch.full((h, w), max_range, dtype=torch.float32, device=dev)
        # walk the steps from the last: an earlier event overwrites a later
        # one, so the first event wins (JAX's done-mask march)
        for i in reversed(range(n_steps)):
            e = event[dy[k][i]:dy[k][i] + h, dx[k][i]:dx[k][i] + w]
            result = torch.where(e == 1, d_steps[i],
                                 torch.where(e == 2, max_range, result))
        table[k] = result
    return table


def table_cell_major(table: torch.Tensor) -> torch.Tensor:
    """(K, H, W) -> (H*W, K): one row per cell, theta bins on the fast axis
    (JAX :183-191)."""
    k, h, w = table.shape
    return table.permute(1, 2, 0).reshape(h * w, k).contiguous()


def _sharded_bin_stack(build_bins, nbins: int, group) -> torch.Tensor:
    """A (nbins, ...) per-theta-bin stack from ``build_bins(start, n)``
    (bins [start, start + n)), theta-sharded over the process ``group``
    when one is given (JAX :194-210): rank r builds bins [r * nbins / D,
    (r + 1) * nbins / D) and one tiled all_gather puts the stack back
    together.  Each bin is built on its own, so the stack is the local
    build's, bit for bit.  Where D does not divide the bin count, every
    rank builds the whole stack, as JAX does."""
    if group is None:
        return build_bins(0, nbins)
    from mcmh_localization_tpu_torch.parallel.distributed import (
        all_gather_tiled,
        axis_index,
        axis_size,
    )

    n_dev = axis_size(group)
    if nbins % n_dev or nbins < n_dev:
        return build_bins(0, nbins)
    kd = nbins // n_dev
    return all_gather_tiled(build_bins(axis_index(group) * kd, kd), group)


def _beam_lut(safe_r, valid, dvals, config) -> torch.Tensor:
    """(M, nq) per-beam log mixture at each quantized range value (JAX
    :213-230); invalid beams carry 0."""
    sigma = config.sigma_hit
    z = divide(safe_r[:, None] - dvals[None, :], sigma)
    ph = hit_norm(sigma) * torch.exp(-0.5 * z ** 2)
    lp = torch.log(torch.clamp(
        config.z_hit * ph + config.z_rand / config.max_range, min=LOG_FLOOR))
    return torch.where(valid[:, None], lp, 0.0)


def _bin_lut_matrix(idx: torch.Tensor, lp: torch.Tensor,
                    k: int) -> torch.Tensor:
    """(R, K, nq): ``S[r, d] = sum of lp[j] over the beams j with
    idx[r, j] == d`` (JAX :233-246), f32 adds in ascending j
    (``ops/bin_lut.py::bin_lut``: a CUDA kernel on the card, which sizes
    nothing on the host)."""
    return bin_lut(idx, lp, k)


def _rolled_bin_lut_matrix(lp, angles, n_theta: int, starts, use_half: bool):
    """S[b, g, q] = T[(g - starts[b]) % K, q] with T the beams' offset-bin
    sums (JAX :249-281): the circulant form of the bin-sum matrix for
    theta-window bins (``starts = kstart + b``, ``use_half``) and for coarse
    bins at an integer width ratio.  ``starts`` is a (B,) int64 tensor on
    ``lp``'s device (the window's from the device-held kstart), so the
    rows are a gather.  T is a one-row ``_bin_lut_matrix``, so the two agree
    bitwise where the bins agree."""
    k = n_theta
    dev = lp.device
    shift = 0.5 if use_half else 0.0
    d = torch.floor(divide(angles, 2.0 * math.pi / k) + shift).to(torch.int64) % k
    t = _bin_lut_matrix(d[None, :], lp, k)[0]
    rows = ((k - starts % k) % k)[:, None] + torch.arange(k, device=dev)[None, :]
    return torch.cat([t, t])[rows]


def _field_bins(kstart: int, nbins: int, angles, n_theta: int) -> torch.Tensor:
    """(nbins, M) global table bin of each beam at each field bin's centre
    heading (JAX :479-485)."""
    dev = angles.device
    dtheta = 2.0 * math.pi / n_theta
    centers = ((torch.arange(nbins, dtype=torch.int32, device=dev) + kstart)
               .to(torch.float32) + 0.5) * dtheta - math.pi
    return torch.floor(divide(centers[:, None] + angles[None, :] + PI_F32,
                              dtheta)).to(torch.int64) % n_theta


def fine_lut_matrix(lp, angles, n_theta: int, kstart, nbins: int,
                    theta_window: bool) -> torch.Tensor:
    """(nbins, K, nq) fine-field LUT matrix of the bins from ``kstart`` (an
    int or a 0-d int tensor on ``lp``'s device), rolled under a theta
    window (JAX :505-519)."""
    if theta_window:
        starts = kstart + torch.arange(nbins, device=lp.device)
        return _rolled_bin_lut_matrix(lp, angles, n_theta, starts,
                                      use_half=True)
    return _bin_lut_matrix(_field_bins(kstart, nbins, angles, n_theta), lp,
                           n_theta)


def fine_lut_inputs(tables: BeamTables, lp, angles, n_theta: int,
                    window: tuple, win: int, nbins: int, theta_window: bool):
    """(qw, S): the fine field's (K, win^2) int8 window of ``qt`` copied out
    at ``window`` = (oy0, ox0, kstart) ints and its LUT matrix: the
    launch-argument form's inputs (``lut_field``), which the chip scripts
    hold ``lut_field_at`` to."""
    oy0, ox0, kstart = window
    k_tab = tables.qt.shape[0]
    qw = tables.qt[:, oy0:oy0 + win, ox0:ox0 + win].reshape(k_tab, win * win)
    return qw.contiguous(), fine_lut_matrix(lp, angles, n_theta, kstart,
                                            nbins, theta_window)


def coarse_lut_inputs(lp, angles, tables: BeamTables, config, n_theta: int):
    """(qtc, Sc): the coarse field's (K, hc*wc) int8 block centres and its
    (kc, K, nq) LUT matrix on the one-slot optimistic LUT ``lpc[j, q] =
    max(lp[j, q-1..q+1])`` (edge-mode at the q ends, not zero padding),
    headings at ``corr_coarse_n_theta`` bin centres (JAX :315-352)."""
    kc = config.corr_coarse_n_theta
    k_tab, hc, wc = tables.qtc.shape
    lpc = torch.maximum(lp, torch.cat([lp[:, :1], lp[:, :-1]], dim=1))
    lpc = torch.maximum(lpc, torch.cat([lp[:, 1:], lp[:, -1:]], dim=1))
    if n_theta % kc == 0:
        r = n_theta // kc
        starts = (r * torch.arange(kc, device=lp.device)
                  + (r // 2 if r % 2 == 0 else (r - 1) // 2))
        sc = _rolled_bin_lut_matrix(lpc, angles, n_theta, starts,
                                    use_half=r % 2 == 1)
    else:
        dev = lp.device
        centers_c = ((torch.arange(kc, dtype=torch.float32, device=dev) + 0.5)
                     * (2.0 * math.pi / kc) - math.pi)
        gc = torch.floor(divide(centers_c[:, None] + angles[None, :] + PI_F32,
                                2.0 * math.pi / n_theta)).to(torch.int64) % n_theta
        sc = _bin_lut_matrix(gc, lpc, n_theta)
    return tables.qtc.reshape(k_tab, hc * wc), sc


def _beam_coarse_field(lp, count, angles, grid_map, tables: BeamTables,
                       config, n_theta: int, shard_group=None) -> torch.Tensor:
    """(kc, hc, wc) coarse full-map fallback field (JAX :284-374): the
    block-centre cells of ``qtc`` evaluated by the LUT kernel with no block
    max, its bins sharded over ``shard_group`` when given; blocks without a
    free cell take the invalid penalty under motion_validity="score"."""
    f = config.corr_coarse_factor
    kc = config.corr_coarse_n_theta
    _, hc, wc = tables.qtc.shape
    qc, sc = coarse_lut_inputs(lp, angles, tables, config, n_theta)
    cfield = _sharded_bin_stack(lambda b, n: lut_field(qc, sc[b:b + n]), kc,
                                shard_group).reshape(kc, hc, wc)
    if config.motion_validity == "score":
        occ = grid_map.occupancy
        h, w = occ.shape
        free = F.pad((occ == 0).to(torch.uint8), (0, wc * f - w, 0, hc * f - h))
        any_free = free.reshape(hc, f, wc, f).amax(dim=(1, 3)) > 0
        cfield = cfield + (INVALID_SCORE * count.clamp(min=1).to(torch.float32)
                           ) * torch.where(any_free, 0.0, 1.0)[None]
    return cfield


def _beam_geometry(grid_map, n_theta, nbins, win, coarse) -> WindowGeometry:
    """The window-score geometry in the beam field's op forms: the pose's
    cell by ``/ res``, its bin by ``/ (2 pi / n_theta)``, window coords
    clipped to the map first; the coarse cell by ``/ f32(f * res)`` and bin
    by ``* f32(kc / 2 pi)`` (JAX :559-572, :377-394).  The window's corner
    and first bin are the origin's (``field_origin``), which the lookups
    read from device memory; ``coarse`` is (f, kc, hc, wc), or None for no
    coarse table."""
    f, kc, hc, wc = coarse if coarse is not None else (0, 0, 0, 0)
    return WindowGeometry(
        origin_x=grid_map.origin_xy[0], origin_y=grid_map.origin_xy[1],
        fine_scale=grid_map.res,
        theta_scale=float(np.float32(2.0 * math.pi / n_theta)),
        n_theta=n_theta, nbins=nbins, fh=win, fw=win, h=grid_map.height,
        w=grid_map.width, kc=kc, hc=hc, wc=wc,
        res_c=float(np.float32(f * grid_map.res)),
        kc_scale=theta_scale(kc) if kc else 0.0,
        fine_div=True, theta_div=True, clip_before_window=True)


def field_origin(window_origin, h: int, w: int, win: int,
                 theta_window: bool, device) -> torch.Tensor:
    """The window origin as the kernels and their plain versions read it:
    a (3,) int32 tensor (oy0, ox0, kstart) on ``device``, the corner
    clamped to ``[0, h - win]`` x ``[0, w - win]`` as JAX clips it
    (:443-449), kstart the theta window's first bin.

    ``window_origin``: a sequence (oy0, ox0[, kstart]) of ints, clamped
    here, kstart 0 without ``theta_window`` (a 2-long one has none, as in
    JAX); or an int32 tensor of that form, clamped on its device (the
    step's, ``filter/step.py::window_origin_at``, holds kstart 0 without a
    theta window)."""
    if not isinstance(window_origin, torch.Tensor):
        oy0, ox0 = (int(x) for x in window_origin[:2])
        kstart = int(window_origin[2]) if theta_window else 0
        return torch.tensor([min(max(oy0, 0), h - win),
                             min(max(ox0, 0), w - win), kstart],
                            dtype=torch.int32, device=device)
    o = window_origin.to(device=device, dtype=torch.int32)
    kstart = o[2] if o.shape[0] > 2 else torch.zeros_like(o[0])
    return torch.stack([o[0].clamp(0, h - win), o[1].clamp(0, w - win),
                        kstart])


def beam_field_scores(
    particles: torch.Tensor,
    ranges: torch.Tensor,
    angles: torch.Tensor,
    grid_map,
    config,
    table,                  # (K, H, W) range table or BeamTables
    n_theta: int,
    window_origin,          # (3,) int32 tensor, or (oy0, ox0[, kstart]) ints
    impl: str = "auto",     # "auto" | "lut" | "dense"
    shard_bins_axis=None,   # a process group: theta-sharded builds
) -> torch.Tensor:
    """(N,) beam-model scores through a per-scan score field (JAX
    :397-750): the field over the window (``corr_window_cells``, and the
    ``corr_theta_window_bins`` theta window when the origin carries a
    first bin), one read per particle.

    ``window_origin``: the window's (oy0, ox0[, kstart]), the step's int32
    tensor on the card or a sequence of ints, clamped into the map by
    ``field_origin``; the field build (``lut_field_at``) and the lookups
    (kernel 5) read it from device memory, so the step reads nothing on
    the host.

    ``impl``: "lut" (and "auto", on every device) builds the field with
    the LUT kernel (its plain version on the CPU); "dense" evaluates each
    beam's mixture on the range-table window, the JAX CPU form.  In-map
    window escapees read the coarse fallback field when
    ``corr_coarse_factor > 0``, its build ``run_if`` on
    ``coarse_gate_escapees`` in-map escapees (JAX's 0-or-1-iteration
    while_loop, :629-646: a conditional node in a captured step), else
    take BLIND_SCORE.  With the gate at 0 the build runs on every scan
    (``ops/graph.py::run_always``: under tracing its runs are counted as
    the gated body's are).

    ``shard_bins_axis``: a process group over whose ranks the fine and
    coarse fields build their theta bins (``_sharded_bin_stack``).  Under
    sharding the coarse build is never gated: it holds an all_gather, and
    the escapee count is each rank's own, so a rank skipping the build
    while another enters it would hang the group (JAX :621-627)."""
    tables = as_beam_tables(table, config)
    dev = particles.device
    if config.step > 1:
        ranges = ranges[:: config.step]
        angles = angles[:: config.step]
    valid = torch.isfinite(ranges) & (ranges < config.max_range)
    count = valid.sum()
    safe_r = torch.where(valid, ranges, 0.0)

    _, h, w = tables.table.shape
    win = min(config.corr_window_cells, h, w)
    tw = config.corr_theta_window_bins
    use_theta_win = bool(tw) and len(window_origin) == 3
    nbins = min(tw, n_theta) if use_theta_win else n_theta
    origin = field_origin(window_origin, h, w, win, use_theta_win, dev)
    kstart = origin[2] if use_theta_win else 0

    lp = _beam_lut(safe_r, valid, tables.dvals, config)
    if impl in ("auto", "lut"):
        s_mat = fine_lut_matrix(lp, angles, n_theta, kstart, nbins,
                                use_theta_win)

        def build_bins(b0, n):
            return lut_field_at(tables.qt, s_mat[b0:b0 + n], origin, win)
    elif impl == "dense":
        rw = window_cells(tables.table, origin, win, win)
        g = _field_bins(kstart, nbins, angles, n_theta)
        inv_sqrt = hit_norm(config.sigma_hit)
        z_floor = config.z_rand / config.max_range

        def build_bins(b0, n):
            bins = []
            for b in range(b0, b0 + n):
                z = divide(safe_r[:, None, None] - rw[g[b]], config.sigma_hit)
                lpd = torch.log(torch.clamp(
                    config.z_hit * (inv_sqrt * torch.exp(-0.5 * z ** 2))
                    + z_floor, min=LOG_FLOOR))
                bins.append(torch.where(valid[:, None, None], lpd,
                                        0.0).sum(dim=0))
            return torch.stack(bins)
    else:
        raise ValueError(f"unknown beam field impl {impl!r}")
    field = _sharded_bin_stack(build_bins, nbins, shard_bins_axis).reshape(
        nbins, win, win)

    score_validity = config.motion_validity == "score"
    cnt = count.clamp(min=1).to(torch.float32)
    if score_validity:
        # non-free window cells score INVALID_SCORE per valid beam (:547-556)
        occ_win = window_cells(grid_map.occupancy, origin, win, win)
        field = field + (INVALID_SCORE * cnt) * torch.where(occ_win == 0, 0.0,
                                                            1.0)[None]
    fine_t = field.transpose(0, 1).reshape(win * nbins, win).contiguous()
    mean = config.score_aggregation == "mean"
    particles = particles.contiguous()

    if config.corr_coarse_factor > 0 and tables.qtc is not None:
        _, hc, wc = tables.qtc.shape
        kc = config.corr_coarse_n_theta
        geo = _beam_geometry(grid_map, n_theta, nbins, win,
                             (config.corr_coarse_factor, kc, hc, wc))

        def coarse_build():
            cfield = _beam_coarse_field(lp, count, angles, grid_map, tables,
                                        config, n_theta, shard_bins_axis)
            return [cfield.transpose(0, 1).reshape(hc * kc, wc).contiguous()]

        if config.coarse_gate_escapees and shard_bins_axis is None:
            # below the gate the escapees take the blind fill (:613-619):
            # BLIND_SCORE after the "mean" divide
            fill = BLIND_SCORE * cnt if mean else scalar(BLIND_SCORE, dev)
            escaped = window_escapees(particles, geo, origin=origin)
            (coarse_t,) = run_if(escaped >= config.coarse_gate_escapees,
                                 coarse_build,
                                 [fill.expand(hc * kc, wc).contiguous()],
                                 donate=True)
        elif shard_bins_axis is None:
            # built on every scan, and counted as the gated body is
            (coarse_t,) = run_always(coarse_build, lambda: [torch.empty(
                (hc * kc, wc), dtype=torch.float32, device=dev)])
        else:
            (coarse_t,) = coarse_build()
        if score_validity:
            fill_oom = INVALID_SCORE if mean else INVALID_SCORE * cnt
        else:
            fill_oom = 0.0
        return window_score(fine_t, coarse_t, particles, geo,
                            cnt if mean else 1.0, fill_oom, count=count,
                            origin=origin)

    geo = _beam_geometry(grid_map, n_theta, nbins, win, None)
    covered, row, lane, in_map = window_indices(particles, geo, origin=origin)
    totals = gather_2d(fine_t, row.to(torch.int32).contiguous(),
                       lane.to(torch.int32).contiguous())
    totals = torch.where(in_map & covered, totals, 0.0)
    score = totals / cnt if mean else totals
    score = torch.where(in_map & ~covered, BLIND_SCORE, score)
    if score_validity:
        pen = INVALID_SCORE if mean else INVALID_SCORE * cnt
        score = torch.where(in_map, score, pen)
    return torch.where(count > 0, score, BLIND_SCORE).to(torch.float32)


def raycast_table_scores(
    particles: torch.Tensor,
    ranges: torch.Tensor,
    angles: torch.Tensor,
    grid_map,
    config,
    table_cm: torch.Tensor | TableLevels,  # (H*W, K) cell-major range table
    n_theta: int,
) -> torch.Tensor:
    """(N,) beam-model scores with one range-table read per (particle,
    beam) (JAX :753-826): the mixture and aggregation of
    ``sensor.raycast_beam_scores`` on the heading quantized to the table
    bin and the origin to the particle's cell; ``config.step`` subsamples
    the beams; out-of-map particles score 0 (before the validity wrap).
    The reads, the mixture and the beam sum are one fused kernel on the
    card (``ops/scan_scores.py::table_scores``).  ``table_cm`` is the f32
    table, read a value a pair, or its ``table_levels`` form (the sensor
    table's, built once per (map, config): the same scores)."""
    if not isinstance(table_cm, TableLevels):
        table_cm = TableLevels(None, None, table_cm.contiguous())
    if config.step > 1:
        ranges = ranges[:: config.step]
        angles = angles[:: config.step]
    valid = torch.isfinite(ranges) & (ranges < config.max_range)
    geo = TableGeometry(
        origin_x=grid_map.origin_xy[0], origin_y=grid_map.origin_xy[1],
        res=grid_map.res, h=grid_map.height, w=grid_map.width,
        n_theta=n_theta)
    return table_scores(
        particles.contiguous(), ranges.contiguous(), angles.contiguous(),
        valid.contiguous(), table_cm, geo, beam_mixture(config),
        valid.sum(), config.score_aggregation)


def beam_mixture(config) -> Mixture:
    """The beam model's mixture constants of ``config``."""
    return Mixture(sigma=config.sigma_hit, z_hit=config.z_hit,
                   hit_norm=hit_norm(config.sigma_hit),
                   z_floor=config.z_rand / config.max_range)
