"""The ray-cast beam sensor (``sensor_model="beam"``) as the windowed beam
score field: a 2-D lidar scored beam by beam against the ranges that a ray
march from the pose would see, each beam adding ``log(max(z_hit N(r - r^;
sigma_hit) + z_rand / max_range, 1e-6))``, the mean over the valid beams.

This module is the plain reference of that scorer (``program``) and of its
range table (``reference_map``); the world, the scan and the program's map
are the likelihood-field module's (``sensors/likelihood_field.py``: the
house, the LDS sweep, ``build_grid_map``), loaded through ``world.sensor``.
It imports nothing of the program under test but where
``likelihood_field.program_maps`` builds the program's own map.

Upstream's model (``compute_likelihoods_raycast``, parallel_utils.py:
151-201) marches every beam from every particle at the particle's own
continuous heading.  The score field departs from it, and this reference
with it, in four ways, each the program's documented semantics:

* **quantised headings**: ranges come from a table of ``beam_table_n_theta``
  bins, each marched once from every cell centre at the bin's centre
  heading; a pose reads its cell (``(x - origin) / res`` truncated) and its
  bin (``(theta + pi) / (2 pi / K)`` truncated, both in float32 division),
  and each beam the table bin that holds its heading from that bin's
  centre: ``floor(u + a / (2 pi / K))`` for a bin centred ``u`` bins past
  -pi, the beam's offset ``a / (2 pi / K)`` in float32 division;
* **the table's levels**: the march takes ``RAY_STEP`` steps; the first
  event wins, a hit at step i giving ``i * RAY_STEP`` (rounded once to
  float32), leaving the map or no hit ``max_range``.  Each range is one of
  the levels ``[RAY_STEP, 2 RAY_STEP, ..., n RAY_STEP, max_range]``, a
  range at ``max_range`` the last;
* **the window**: only a ``corr_window_cells`` square of cells over
  ``corr_theta_window_bins`` bins is scored in full, centred on the window
  anchor after the scan's odometry, its heading backed off half the
  scan's rotation, its corner clamped to the map;
* **the coarse field**: a pose on the map outside the window reads a
  field at the centres of ``corr_coarse_factor`` square blocks (its block
  by ``(x - origin) / f32(f res)``, its bin by ``(theta + pi) f32(kc / 2
  pi)``), over ``corr_coarse_n_theta`` bins, with each beam's term the
  largest at its level and the levels beside it (the ends repeated): an
  optimistic score, so a hypothesis far from the window can win.

Validity under ``motion_validity="score"``: a pose off the map reads
INVALID; a window cell that is not free adds INVALID per valid beam to its
sum (INVALID more after the mean), and a coarse block with no free cell the
same.  A scan with no valid beam reads BLIND.  The coarse field is built
on every scan: the program's escapee gate counts the proposal and the
previous set together, which the reference scores apart, so a gated
configuration (``coarse_gate_escapees`` above 0) has no reference here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark import world
from benchmark.reference import filter as ref

RAY_STEP = 0.1       # parallel_utils.py:10
LOG_FLOOR = 1e-6     # parallel_utils.py:141
PI_F32 = float(np.float32(np.pi))
# the FilterConfig defaults of the keys a configuration file may leave out
DEFAULTS = {"beam_table_n_theta": 360, "corr_theta_window_bins": 0,
            "corr_coarse_factor": 4, "corr_coarse_n_theta": 36,
            "coarse_gate_escapees": 8, "window_center": "anchor",
            "beam_impl": "auto", "motion_validity": "reject",
            "score_aggregation": "mean", "step": 1}

_field = world.sensor("likelihood_field")
build_world = _field.build_world
program_maps = _field.program_maps
scanner = _field.scanner
reference_angles = _field.reference_angles


def _key(f: dict, name: str):
    return f.get(name, DEFAULTS[name])


# -- the reference map: the range table

class Table(NamedTuple):
    """The range table as levels: ``level[k, y, x]`` indexes ``levels``
    (float32, or the control's bfloat16)."""

    level: torch.Tensor    # (K, H, W) int64
    levels: torch.Tensor   # (n + 1,)


def level_table(occ: np.ndarray, res: float, n_theta: int, max_range: float,
                device, step: float = RAY_STEP) -> torch.Tensor:
    """(K, H, W) int64 level of the first event of the march from each cell
    centre at each bin's centre heading: step i (1-based) of bin k visits
    the cell ``round-half-up(i step (cos, sin)(theta_k) / res)`` cells
    away, an occupied cell (above 50) is a hit at level i - 1 (the last
    level where ``i step`` reaches ``max_range``), leaving the map is the
    last level, and so is a march with no event."""
    h, w = occ.shape
    n = int(max_range / step)
    last = n
    theta = -math.pi + (np.arange(n_theta) + 0.5) * (2.0 * math.pi / n_theta)
    d = np.arange(1, n + 1) * step
    off_x = np.floor(0.5 + np.outer(np.cos(theta), d) / res).astype(np.int64)
    off_y = np.floor(0.5 + np.outer(np.sin(theta), d) / res).astype(np.int64)
    hit_level = [i - 1 if np.float32(d[i - 1]) < np.float32(max_range)
                 else last for i in range(1, n + 1)]
    hit = torch.from_numpy(occ > 50).to(device)
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    out = torch.empty((n_theta, h, w), dtype=torch.int64, device=device)
    for k in range(n_theta):
        level = torch.full((h, w), last, dtype=torch.int64, device=device)
        done = torch.zeros((h, w), dtype=torch.bool, device=device)
        for i in range(n):
            y = ys + int(off_y[k, i])
            x = xs + int(off_x[k, i])
            inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
            on_hit = inside & hit[y.clamp(0, h - 1), x.clamp(0, w - 1)]
            event = ~done & (on_hit | ~inside)
            level = torch.where(event & on_hit, hit_level[i], level)
            done = done | event
        out[k] = level
    return out


def levels_of(max_range: float, step: float = RAY_STEP) -> np.ndarray:
    """The float32 ranges a level stands for: ``i step`` for i = 1..n (each
    a float64 product rounded once), then ``max_range``."""
    n = int(max_range / step)
    return np.concatenate([np.arange(1, n + 1) * step,
                           [max_range]]).astype(np.float32)


def reference_map(w: world.World, f: dict, device,
                  dtype=torch.float32) -> ref.Map:
    """The reference's range table on the grid: its levels in float32, or
    in bfloat16 for the control."""
    level = level_table(w.occ, float(np.float32(w.res)),
                        _key(f, "beam_table_n_theta"), f["max_range"], device)
    levels = torch.from_numpy(levels_of(f["max_range"])).to(device, dtype)
    return ref.make_map(w.occ, w.res, w.origin, device, Table(level, levels))


# -- the reference's scorer

def program(prog: ref.Program) -> ref.Program:
    """The windowed beam score field of a single program; the module has
    no reference for another beam scorer, a staged beam program, a window
    centred otherwise than on the anchor, or a gated coarse build."""
    f = prog.cfg
    if f.get("sensor_model") != "beam" or _key(f, "beam_impl") != "field" \
            or not f.get("corr_window_cells"):
        raise NotImplementedError("only the windowed beam score field "
                                  "(beam_impl='field') has a reference")
    if prog.role != "single":
        raise NotImplementedError("a staged beam program has no reference")
    if _key(f, "window_center") != "anchor":
        raise NotImplementedError("only the anchor-centred window")
    if _key(f, "corr_coarse_factor") and _key(f, "coarse_gate_escapees"):
        raise NotImplementedError(
            "a gated coarse build: the gate counts the proposal and the "
            "previous set together, which the reference scores apart")
    return prog._replace(scorer=field_scorer)


def _offsets(angles: torch.Tensor, n_theta: int) -> torch.Tensor:
    """Each beam's heading in table bins, float32 division, as float64."""
    width = torch.full((), 2.0 * math.pi / n_theta, dtype=torch.float32,
                       device=angles.device)
    return (angles.float() / width).double()


def _bins(u: torch.Tensor, q: torch.Tensor, n_theta: int) -> torch.Tensor:
    """(B, M) table bin of each beam ``q`` from bins centred ``u``."""
    return torch.floor(u[:, None] + q[None, :]).to(torch.int64) % n_theta


def _lut(r: torch.Tensor, levels: torch.Tensor, f: dict,
         dtype) -> torch.Tensor:
    """(M, n + 1) each beam's term at each level."""
    s = f["sigma_hit"]
    x = (r[:, None].to(dtype) - levels[None, :].to(dtype)) / s
    p_hit = torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi * s * s)
    p = f["z_hit"] * p_hit + f["z_rand"] / f["max_range"]
    return torch.log(torch.clamp(p, min=LOG_FLOOR)).to(dtype)


def _sum_beams(lut: torch.Tensor, level: torch.Tensor, bins: torch.Tensor,
               rows: slice, cols: slice, dtype) -> torch.Tensor:
    """(B, h, w) sum over the beams of ``lut[j, level[bins[b, j], rows,
    cols]]``."""
    beams = torch.arange(lut.shape[0], device=lut.device)[:, None, None]
    out = []
    for b in range(bins.shape[0]):
        lv = level[bins[b]][:, rows, cols]
        out.append(lut[beams, lv].sum(dim=0, dtype=dtype))
    return torch.stack(out)


def field_scorer(ranges, angles, m: ref.Map, prog: ref.Program, anchor, delta,
                 dtype):
    """Beam score-field scores (see the module's docstring): the window's
    fine field and the coarse field, built once a scan; then one read per
    pose.  Returns the scorer of (N, 3) poses."""
    f = prog.cfg
    tab: Table = m.field
    k_all, h, w = tab.level.shape
    dev = ranges.device
    step = _key(f, "step")
    if step > 1:
        ranges, angles = ranges[::step], angles[::step]
    valid = torch.isfinite(ranges) & (ranges < f["max_range"])
    n_valid = int(valid.sum())
    cnt = max(n_valid, 1)
    r, q = ranges[valid], _offsets(angles[valid], k_all)
    lut = _lut(r, tab.levels, f, dtype)
    score_validity = _key(f, "motion_validity") == "score"
    mean = _key(f, "score_aggregation") == "mean"

    # the window, centred on the anchor, its heading backed off half the
    # scan's rotation
    win = min(f["corr_window_cells"], h, w)
    half = win // 2
    inv_res = float(np.float32(1.0) / np.float32(m.res))
    ox0 = int(((anchor[0] - m.origin[0]) * inv_res).to(torch.int32)) - half
    oy0 = int(((anchor[1] - m.origin[1]) * inv_res).to(torch.int32)) - half
    ox0, oy0 = min(max(ox0, 0), w - win), min(max(oy0, 0), h - win)
    tw = _key(f, "corr_theta_window_bins")
    if tw:
        mt = ref.wrap(anchor[2] - 0.5 * (delta[0].to(anchor.device)
                                         + delta[2].to(anchor.device)))
        kmid = int(((mt + math.pi) * (k_all / (2.0 * math.pi)))
                   .to(torch.int32)) % k_all
        kstart, nbins = (kmid - tw // 2) % k_all, min(tw, k_all)
    else:
        kstart, nbins = 0, k_all
    u = kstart + torch.arange(nbins, dtype=torch.float64, device=dev) + 0.5
    fine = _sum_beams(lut, tab.level, _bins(u, q, k_all),
                      slice(oy0, oy0 + win), slice(ox0, ox0 + win), dtype)
    if score_validity:
        occ = m.occ[oy0:oy0 + win, ox0:ox0 + win]
        fine = fine + torch.where(occ == 0, 0.0, ref.INVALID * cnt).to(dtype)

    # the coarse field at the block centres, on the optimistic terms
    cf = _key(f, "corr_coarse_factor")
    if cf:
        kc = _key(f, "corr_coarse_n_theta")
        opt = torch.maximum(lut, torch.cat([lut[:, :1], lut[:, :-1]], 1))
        opt = torch.maximum(opt, torch.cat([lut[:, 1:], lut[:, -1:]], 1))
        uc = (torch.arange(kc, dtype=torch.float64, device=dev) + 0.5) \
            * (k_all / kc)
        centres = slice(cf // 2, None, cf)
        coarse = _sum_beams(opt, tab.level, _bins(uc, q, k_all), centres,
                            centres, dtype)
        hc, wc = coarse.shape[1:]
        if score_validity:
            free = torch.zeros((hc * cf, wc * cf), dtype=torch.bool,
                               device=dev)
            free[:min(h, hc * cf), :min(w, wc * cf)] = \
                (m.occ == 0)[:hc * cf, :wc * cf]
            any_free = free.reshape(hc, cf, wc, cf).any(3).any(1)
            coarse = coarse + torch.where(any_free, 0.0,
                                          ref.INVALID * cnt).to(dtype)
        res_c = float(np.float32(cf * m.res))
        kc_scale = float(np.float32(kc / (2.0 * math.pi)))
    bin_width = float(np.float32(2.0 * math.pi / k_all))

    def score(poses):
        px, py, pth = poses.float().unbind(1)
        mx = ref.cell_of(px, m.origin[0], m.res)
        my = ref.cell_of(py, m.origin[1], m.res)
        tpi = pth + PI_F32
        kb = (tpi / torch.full((), bin_width, device=dev)).to(torch.int32) \
            % k_all
        k_rel = (kb - kstart) % k_all
        mxw, myw = mx - ox0, my - oy0
        covered = (k_rel < nbins) & (mxw >= 0) & (mxw < win) & (myw >= 0) \
            & (myw < win)
        in_map = (mx >= 0) & (mx < w) & (my >= 0) & (my < h)
        total = fine[k_rel.clamp(0, nbins - 1).long(),
                     myw.clamp(0, win - 1).long(), mxw.clamp(0, win - 1).long()]
        if cf:
            cx = ref.cell_of(px, m.origin[0], res_c).clamp(0, wc - 1)
            cy = ref.cell_of(py, m.origin[1], res_c).clamp(0, hc - 1)
            ck = (tpi * kc_scale).to(torch.int32) % kc
            total = torch.where(covered, total,
                                coarse[ck.long(), cy.long(), cx.long()])
        out = total / cnt if mean else total
        if not cf:
            out = torch.where(covered, out, ref.BLIND)
        off = (ref.INVALID if mean else ref.INVALID * cnt) if score_validity \
            else 0.0
        out = torch.where(in_map, out, off)
        if n_valid == 0:
            out = torch.full_like(out, ref.BLIND)
        return out.to(dtype)

    return score
