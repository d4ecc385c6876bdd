"""The likelihood-field sensor (``sensor_model="likelihood_field"``, the
sensor of a configuration file that names none): a 2-D lidar scored on the
map's likelihood field, by the corr scorer or the exact one.

A sensor module is everything of the benchmark that depends on the sensor
model and its map; ``world.sensor(name)`` loads ``sensors/<name>.py`` for
a configuration's ``"sensor"``.  It defines:

* the world: ``build_world(conf, map_spec)``, the map as the benchmark
  makes it from the configuration and its map file (``world.World``: the
  2-D navigation grid, its distance, and what the module adds), and
  ``program_maps(world, conf, device)``, the maps ``OnlineLocalizer``
  takes as keywords, built in the timed set-up;
* the scan: ``scanner(world, traffic, device)``, the clean ranges of a
  batch of poses and the angles a driver hands with each scan
  (``generate.Scanner``), and ``reference_angles(world, traffic, device)``,
  the angles the reference scores them at;
* the reference's scorer: ``program(prog)``, the reference's program with
  its ``scorer`` set, which raises for a program the module has no
  reference for;
* the reference map: ``reference_map(world, filter_keys, device, dtype)``,
  float32 for the reference and bfloat16 for the control.

Only ``program_maps`` imports the program under test; the rest is the plain
reference.  This module's map file is ``maps/<name>.json``'s rectangles."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import world
from benchmark.reference import filter as ref
from benchmark.traffic import generate

LOG_FLOOR = 1e-6     # parallel_utils.py:141
AUTO_CORR_MIN_STATE = 8192


# -- the world

def build_world(conf: dict, map_spec: dict) -> world.World:
    """The occupancy grid painted from the map file's rectangles and its
    distance transform."""
    res = map_spec["resolution"]
    occ = world.occupancy(map_spec)
    return world.World(occ, world.distance(occ, res), res,
                       tuple(map_spec["origin"]))


def program_maps(w: world.World, conf: dict, device) -> dict:
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map

    return {"grid_map": build_grid_map(w.occ, w.res, w.origin, device=device)}


# -- the scan

def _sweep(p: dict, device) -> torch.Tensor:
    """The LDS sweep: ``n_beams`` angles over [-pi, pi], the localizer's
    default."""
    return torch.linspace(-math.pi, math.pi, p["n_beams"],
                          dtype=torch.float32, device=device)


def raycast(poses: torch.Tensor, angles: torch.Tensor, occ: torch.Tensor,
            res: float, origin, max_range: float,
            ray_step: float) -> torch.Tensor:
    """(N, M) ranges: march each beam in ``ray_step`` steps; the first
    non-free cell (occupied or unknown) returns its distance, leaving the
    map or no hit returns ``max_range`` (``sim/simulator.py``'s ray cast,
    unknown cells as obstacles)."""
    h, w = occ.shape
    n_steps = int(max_range / ray_step)
    d = torch.arange(1, n_steps + 1, dtype=torch.float32,
                     device=poses.device) * ray_step
    a = poses[:, 2:3] + angles[None, :]
    x = poses[:, 0, None, None] + torch.cos(a)[..., None] * d
    y = poses[:, 1, None, None] + torch.sin(a)[..., None] * d
    mx = ((x - origin[0]) / res).to(torch.int32)
    my = ((y - origin[1]) / res).to(torch.int32)
    out = ~((mx >= 0) & (mx < w) & (my >= 0) & (my < h))
    cell = occ[my.clamp(0, h - 1).long(), mx.clamp(0, w - 1).long()]
    hit = ~out & (cell != 0)
    event = out | hit
    first = event.to(torch.uint8).argmax(dim=-1)
    first_hit = hit.gather(-1, first[..., None])[..., 0]
    return torch.where(event.any(dim=-1) & first_hit, d[first],
                       max_range).to(torch.float32)


def scanner(w: world.World, p: dict, device) -> generate.Scanner:
    """The sweep ray cast on the navigation grid; the driver hands the
    ranges alone (the localizer's default sweep)."""
    occ = torch.from_numpy(w.occ).to(device)
    angles = _sweep(p, device)
    return generate.Scanner(
        clean=lambda poses: raycast(poses, angles, occ, w.res, w.origin,
                                    p["max_range_m"], p["ray_step_m"]),
        angles=None)


def reference_angles(w: world.World, p: dict, device) -> torch.Tensor:
    return _sweep(p, device)


# -- the reference map

def reference_map(w: world.World, f: dict, device,
                  dtype=torch.float32) -> ref.Map:
    """The likelihood field ``log(max(z_hit N(d; sigma_hit) + z_rand /
    max_range, 1e-6))`` (no hit term past max_range) on the grid."""
    d = torch.from_numpy(w.dist).to(device=device, dtype=torch.float64)
    s = f["sigma_hit"]
    p_hit = torch.exp(-0.5 * d * d / (s * s)) / math.sqrt(2 * math.pi * s * s)
    p_hit = torch.where(d <= f["max_range"], p_hit, 0.0)
    p = f["z_hit"] * p_hit + f["z_rand"] / f["max_range"]
    log_field = torch.log(torch.clamp(p, min=LOG_FLOOR)).to(dtype)
    return ref.make_map(w.occ, w.res, w.origin, device, log_field)


# -- the reference's scorers

def program(prog: ref.Program) -> ref.Program:
    """The corr scorer where ``likelihood_impl`` is "corr" (or "auto" at
    8192 slots or more), else the exact one."""
    f = prog.cfg
    impl = f.get("likelihood_impl", "auto")
    if impl == "auto":
        corr = f["max_particles"] >= AUTO_CORR_MIN_STATE
    else:
        corr = {"corr": True, "jnp": False}[impl]
    if corr and prog.role == "single" and f.get("corr_window_cells"):
        raise NotImplementedError("the single corr program's coarse "
                                  "fallback has no reference yet")
    return prog._replace(scorer=corr_scorer if corr else exact_scorer)


def _window(prog: ref.Program) -> tuple[int, int]:
    """(cells, theta bins) of the program's window, 0 for the whole map
    and every bin: staged BIG scores the whole map."""
    if prog.role == "big":
        return 0, 0
    f = prog.cfg
    return f.get("corr_window_cells", 0), f.get("corr_theta_window_bins", 0)


def _beams(ranges, angles, f, dtype):
    valid = torch.isfinite(ranges) & (ranges < f["max_range"])
    r = torch.where(valid, ranges, 0.0)
    return (r * torch.cos(angles)).to(dtype), (r * torch.sin(angles)).to(dtype), valid


def corr_scorer(ranges, angles, m: ref.Map, prog: ref.Program, anchor, delta,
                dtype):
    """Correlation-field scores: the field ``F[k, y, x]``, the summed log
    field at every valid beam's endpoint from cell (y, x) at the centre
    heading of theta bin k (endpoint offsets truncated to cells, off-map
    endpoints add 0), built once a scan; then one read per pose.  Occupied
    or unknown cells score INVALID per beam under motion_validity="score",
    poses off the map INVALID, poses in the map but outside the window
    BLIND.  The window is centred on the anchor, its heading backed off
    half the scan's rotation.  Returns the scorer of (N, 3) poses."""
    f = prog.cfg
    k_all = f.get("corr_n_theta", 120)
    h, w = m.occ.shape
    dev = ranges.device
    inv_res = float(np.float32(1.0) / np.float32(m.res))
    u, v, valid = _beams(ranges, angles, f, torch.float32)
    n_valid = int(valid.sum())
    cnt = max(n_valid, 1)
    pad = int(-(-f["max_range"] // m.res)) + 2
    window, theta_bins = _window(prog)
    if window:
        half = window // 2
        ox0 = int(((anchor[0] - m.origin[0]) * inv_res).to(torch.int32)) - half
        oy0 = int(((anchor[1] - m.origin[1]) * inv_res).to(torch.int32)) - half
        ox0, oy0 = min(max(ox0, 0), w - window), min(max(oy0, 0), h - window)
        mt = ref.wrap(anchor[2] - 0.5 * (delta[0].to(anchor.device)
                                         + delta[2].to(anchor.device)))
        kmid = int(((mt + math.pi) * (k_all / (2.0 * math.pi))).to(torch.int32)) % k_all
        kstart = (kmid - theta_bins // 2) % k_all
        fh = fw = window
        nbins = theta_bins or k_all
    else:
        oy0 = ox0 = kstart = 0
        fh, fw, nbins = h, w, k_all
    thetas = ((kstart + torch.arange(nbins, dtype=torch.float32, device=dev)
               + 0.5) * (2.0 * math.pi / k_all) - math.pi)
    c, s = torch.cos(thetas)[:, None], torch.sin(thetas)[:, None]
    ox = ((c * u - s * v) * inv_res).to(torch.int64)
    oy = ((s * u + c * v) * inv_res).to(torch.int64)
    padded = torch.nn.functional.pad(m.field, (pad, pad, pad, pad))
    wp = padded.shape[1]
    flat = padded.reshape(-1)
    base = ((oy0 + pad + torch.arange(fh, device=dev))[:, None] * wp
            + (ox0 + pad + torch.arange(fw, device=dev))[None, :])
    field = torch.zeros((nbins, fh, fw), dtype=dtype, device=dev)
    for j in torch.nonzero(valid).flatten().tolist():
        field += flat[base[None] + (oy[:, j] * wp + ox[:, j])[:, None, None]]
    if f.get("motion_validity") == "score":
        occ = m.occ[oy0:oy0 + fh, ox0:ox0 + fw]
        field = field + torch.where(occ == 0, 0.0, ref.INVALID * cnt).to(dtype)
    pi32 = float(np.float32(np.pi))
    tscale = float(np.float32(k_all / (2 * math.pi)))

    def score(poses):
        px, py, pth = poses.float().unbind(1)
        mx = ((px - m.origin[0]) * inv_res).to(torch.int32)
        my = ((py - m.origin[1]) * inv_res).to(torch.int32)
        k_rel = (((pth + pi32) * tscale).to(torch.int32) % k_all - kstart) % k_all
        mxw, myw = mx - ox0, my - oy0
        covered = (k_rel < nbins) & (mxw >= 0) & (mxw < fw) & (myw >= 0) \
            & (myw < fh)
        in_map = (mx >= 0) & (mx < w) & (my >= 0) & (my < h)
        total = field[k_rel.clamp(0, nbins - 1).long(),
                      myw.clamp(0, fh - 1).long(), mxw.clamp(0, fw - 1).long()]
        total = torch.where(in_map & covered, total, 0.0)
        out = total if prog.aggregation == "sum" else total / cnt
        out = torch.where(in_map & ~covered, ref.BLIND, out)
        if f.get("motion_validity") == "score":
            out = torch.where(in_map, out, ref.INVALID * cnt
                              if prog.aggregation == "sum" else ref.INVALID)
        if n_valid == 0:
            out = torch.full_like(out, ref.BLIND)
        return out.to(dtype)

    return score


def exact_scorer(ranges, angles, m: ref.Map, prog: ref.Program, anchor, delta,
                 dtype):
    """Likelihood-field scores beam by beam (parallel_utils.py:85-149):
    each valid beam's endpoint cell by ``(l - origin) / res`` truncated,
    off-map endpoints add 0, the mean over the valid beams.  Returns the
    scorer of (N, 3) poses."""
    f = prog.cfg
    if f.get("motion_validity") == "score":
        raise NotImplementedError("the exact scorer's validity wrap")
    u, v, valid = _beams(ranges, angles, f, dtype)
    h, w = m.occ.shape
    return lambda poses: _exact(poses.to(dtype), u, v, valid, m, prog, h, w)


def _exact(p, u, v, valid, m, prog, h, w):
    c, s = torch.cos(p[:, 2:3]), torch.sin(p[:, 2:3])
    lx = p[:, 0:1] + c * u[valid] - s * v[valid]
    ly = p[:, 1:2] + s * u[valid] + c * v[valid]
    mx = ref.cell_of(lx.float(), m.origin[0], m.res)
    my = ref.cell_of(ly.float(), m.origin[1], m.res)
    in_map = (mx >= 0) & (mx < w) & (my >= 0) & (my < h)
    vals = m.field[my.clamp(0, h - 1).long(), mx.clamp(0, w - 1).long()]
    total = torch.where(in_map, vals, 0.0).sum(dim=1)
    n_valid = int(valid.sum())
    if n_valid == 0:
        return torch.full_like(total, ref.BLIND)
    return total if prog.aggregation == "sum" else total / n_valid
