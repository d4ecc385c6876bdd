"""The 3-D lidar (``sensor_model="lidar3d"``): a planar pose (x, y, theta)
and a multi-ring scan, beam j with range r_j, body-frame azimuth a_j and
elevation e_j, scored against a voxel building's 3-D distance volume.  The
beam's endpoint is

    (x, y, z0) + r_j [cos e_j cos(theta + a_j), cos e_j sin(theta + a_j),
                      sin e_j]

with z0 the sensor's height above the pose plane, and a valid beam (finite,
below ``max_range``) adds ``log(max(z_hit N(d; sigma_hit) + z_rand /
max_range, 1e-6))`` at the distance d from its endpoint's voxel to the
nearest occupied voxel; the score is the mean over the valid beams (the JAX
package's ``models/sensor3d.py``).

This module is the benchmark's world, scanner and plain reference of that
scorer.  Its map file (``maps/<name>.json``) paints the (D, H, W) voxel
occupancy from boxes ``[kind, layer0, layer1, row0, row1, col0, col1]``
(half-open, in order, on a free volume); the distance is scipy's 3-D EDT
over the occupied voxels, in meters; the 2-D navigation grid that the
tour's placements, the motion checks and the injection read is the voxel
layer at the map's ``nav_z_m``.  The traffic file gives the scanner: its
``azimuths`` over [-pi, pi) and ``ring_elevations_deg``, azimuth-major (the
rings of one azimuth together), mounted ``sensor_z_m`` above the pose
plane.  The reference scores at that mount, whatever height the program's
configuration states.

It imports nothing of the program under test but in ``program_maps``.  The
program documents these departures from the equations above, and the
reference follows each:

* a valid beam whose endpoint leaves the volume counts in the mean's
  denominator and adds 0; a scan with no valid beam reads the blind
  penalty;
* ``step`` > 1 scores every step-th beam;
* the endpoint's voxel is ``floor((p - origin) / res)`` per axis (the
  program multiplies by a float32 ``1 / res`` and rotates the beam's
  sensor-frame (u, v) by the pose's heading, where the reference takes
  ``cos(theta + a)``: both round apart at a voxel's edge, in a few pairs
  a scan);
* under ``motion_validity="score"`` a pose whose navigation cell is not
  free reads INVALID (times the valid beams under "sum"), the wrap the
  program applies around the 3-D scorer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark import world
from benchmark.reference import filter as ref
from benchmark.traffic import generate

LOG_FLOOR = 1e-6     # parallel_utils.py:141
# (pose, beam) pairs a block of the reference's scorer and of the
# scanner's march: the temporaries stay near 64 MB a tensor
BLOCK_PAIRS = 1 << 24


class Volume(NamedTuple):
    """The building as the benchmark makes it (``World.own``)."""

    occupancy: np.ndarray    # (D, H, W) int8: 0 free, 100 occupied
    distance: np.ndarray     # (D, H, W) float64 m to the nearest occupied
    res: float
    origin: tuple            # (x, y, z) of voxel (0, 0, 0)'s corner
    nav_z: float


class Beams(NamedTuple):
    """The scanner's beams as the reference scores them."""

    directions: torch.Tensor  # (M, 2) float32 [azimuth, elevation]
    sensor_z: float


class Field(NamedTuple):
    """The reference map's own part: the per-voxel log mixture."""

    log: torch.Tensor        # (D, H, W) float32 (bfloat16 for the control)
    res: float
    origin: tuple


# -- the world

def occupancy(map_spec: dict) -> np.ndarray:
    """(D, H, W) int8 occupancy painted from the map file's boxes in order
    on a free volume (row 0 the bottom row, layer 0 the floor)."""
    d, n = int(map_spec["layers"]), int(map_spec["cells"])
    occ = np.full((d, n, n), world.FREE, dtype=np.int8)
    for kind, l0, l1, r0, r1, c0, c1 in map_spec["boxes"]:
        occ[l0:l1, r0:r1, c0:c1] = {"free": world.FREE,
                                    "occupied": world.OCCUPIED}[kind]
    return occ


def nav_layer(depth: int, res: float, origin_z: float, z: float) -> int:
    """The voxel layer holding height ``z``, clamped into the volume."""
    return int(np.clip(np.floor((z - origin_z) / res), 0, depth - 1))


def build_world(conf: dict, map_spec: dict) -> world.World:
    """The voxel building, its 3-D EDT, and the navigation grid at the
    map's ``nav_z_m`` with its 2-D distance."""
    from scipy.ndimage import distance_transform_edt

    res = float(map_spec["resolution"])
    origin = tuple(float(o) for o in map_spec["origin"])
    occ = occupancy(map_spec)
    dist = distance_transform_edt(~(occ > 50), sampling=res)
    nav = occ[nav_layer(occ.shape[0], res, origin[2], map_spec["nav_z_m"])]
    vol = Volume(occ, dist, res, origin, float(map_spec["nav_z_m"]))
    return world.World(nav, world.distance(nav, res), res, origin[:2], vol)


def program_maps(w: world.World, conf: dict, device) -> dict:
    """The program's voxel map (its EDT on the host) and its navigation
    slice at the map's height."""
    from mcmh_localization_tpu_torch.maps.voxel_map import (
        build_voxel_map,
        nav_slice,
    )

    v = w.own
    vm = build_voxel_map(v.occupancy, v.res, v.origin, device=device)
    return {"grid_map": nav_slice(vm, z=v.nav_z), "voxel_map": vm}


# -- the scan

def directions(p: dict) -> np.ndarray:
    """(M, 2) float32 [azimuth, elevation]: ``azimuths`` over [-pi, pi)
    with every ring of ``ring_elevations_deg`` at each."""
    az = np.linspace(-np.pi, np.pi, int(p["azimuths"]), endpoint=False)
    el = np.deg2rad(np.asarray(p["ring_elevations_deg"], dtype=np.float64))
    out = np.stack([np.repeat(az, el.size), np.tile(el, az.size)], 1)
    if out.shape[0] != p["n_beams"]:
        raise ValueError(f"{out.shape[0]} beams, the traffic says "
                         f"{p['n_beams']}")
    return out.astype(np.float32)


def _voxel(x, origin: float, res: float):
    """int64 voxel ``floor((x - origin) / res)`` in IEEE division (a CUDA
    division by a python scalar multiplies by its reciprocal)."""
    return torch.floor((x - origin) / torch.full((), res, device=x.device)) \
        .to(torch.int64)


def raycast(poses: torch.Tensor, dirs: torch.Tensor, occupied: torch.Tensor,
            res: float, origin, sensor_z: float, max_range: float,
            ray_step: float) -> torch.Tensor:
    """(N, M) ranges: each beam marched from the pose at ``sensor_z`` in
    ``ray_step`` steps; the first occupied voxel gives the step's
    distance, leaving the volume or no hit within ``max_range`` gives
    ``max_range``."""
    dz, h, w = occupied.shape
    dev = poses.device
    n_steps = int(max_range / ray_step)
    dist = torch.arange(1, n_steps + 1, dtype=torch.float32,
                        device=dev) * ray_step
    flat = occupied.reshape(-1)
    ce, se = torch.cos(dirs[:, 1]), torch.sin(dirs[:, 1])
    m = dirs.shape[0]
    out = torch.empty((poses.shape[0], m), dtype=torch.float32, device=dev)
    rows = max(1, BLOCK_PAIRS // m)
    for i0 in range(0, poses.shape[0], rows):
        p = poses[i0:i0 + rows]
        a = p[:, 2:3] + dirs[None, :, 0]
        hx, hy = ce[None] * torch.cos(a), ce[None] * torch.sin(a)
        rng = torch.full(a.shape, max_range, dtype=torch.float32, device=dev)
        done = torch.zeros(a.shape, dtype=torch.bool, device=dev)
        for i in range(n_steps):
            d = dist[i]
            vx = _voxel(p[:, 0:1] + d * hx, origin[0], res)
            vy = _voxel(p[:, 1:2] + d * hy, origin[1], res)
            vz = _voxel(sensor_z + d * se, origin[2], res)[None].expand_as(vx)
            inside = (vx >= 0) & (vx < w) & (vy >= 0) & (vy < h) \
                & (vz >= 0) & (vz < dz)
            idx = (vz.clamp(0, dz - 1) * h + vy.clamp(0, h - 1)) * w \
                + vx.clamp(0, w - 1)
            hit = inside & flat[idx]
            event = ~done & (hit | ~inside)
            rng = torch.where(event & hit, d, rng)
            done = done | event
            if i % 64 == 63 and bool(done.all()):
                break
        out[i0:i0 + rows] = rng
    return out


def scanner(w: world.World, p: dict, device) -> generate.Scanner:
    """The benchmark's 3-D ray march on the building; the sensor hands the
    (M, 2) angles with every scan."""
    v = w.own
    occupied = torch.from_numpy(v.occupancy > 50).to(device)
    dirs_np = directions(p)
    dirs = torch.from_numpy(dirs_np).to(device)
    return generate.Scanner(
        clean=lambda poses: raycast(poses, dirs, occupied, v.res, v.origin,
                                    p["sensor_z_m"], p["max_range_m"],
                                    p["ray_step_m"]),
        angles=dirs_np)


def reference_angles(w: world.World, p: dict, device) -> Beams:
    return Beams(torch.from_numpy(directions(p)).to(device),
                 float(p["sensor_z_m"]))


# -- the reference map

def reference_map(w: world.World, f: dict, device,
                  dtype=torch.float32) -> ref.Map:
    """The per-voxel log mixture of the building's distance, computed in
    float64 and stored in float32, or in bfloat16 for the control."""
    v = w.own
    d = torch.from_numpy(v.distance).to(device=device, dtype=torch.float64)
    s = f["sigma_hit"]
    p_hit = torch.exp(-0.5 * d * d / (s * s)) / math.sqrt(2 * math.pi * s * s)
    p = f["z_hit"] * p_hit + f["z_rand"] / f["max_range"]
    log = torch.log(torch.clamp(p, min=LOG_FLOOR)).to(dtype)
    return ref.make_map(w.occ, w.res, w.origin, device,
                        Field(log, v.res, v.origin))


# -- the reference's scorer

def program(prog: ref.Program) -> ref.Program:
    """The 3-D scorer of a single program; a staged 3-D program has no
    reference here."""
    if prog.cfg.get("sensor_model") != "lidar3d":
        raise NotImplementedError("only sensor_model='lidar3d' has a "
                                  "reference in this module")
    if prog.role != "single":
        raise NotImplementedError("a staged 3-D program has no reference")
    return prog._replace(scorer=volume_scorer)


def volume_scorer(ranges, beams: Beams, m: ref.Map, prog: ref.Program,
                  anchor, delta, dtype, outside: float = 0.0):
    """3-D lidar scores (see the module's docstring), the geometry in
    float32, the beam sums in ``dtype``, in blocks of poses; ``outside``:
    the term of a valid beam whose endpoint leaves the volume (0, the
    program's semantics).  Returns the scorer of (N, 3) poses."""
    f = prog.cfg
    vol: Field = m.field
    dz, h, w = vol.log.shape
    step = f.get("step", 1)
    az, el = beams.directions[:, 0], beams.directions[:, 1]
    if step > 1:
        ranges, az, el = ranges[::step], az[::step], el[::step]
    valid = torch.isfinite(ranges) & (ranges < f["max_range"])
    n_valid = int(valid.sum())
    cnt = max(n_valid, 1)
    r, az, el = ranges[valid].float(), az[valid], el[valid]
    reach = r * torch.cos(el)
    vz = _voxel(beams.sensor_z + r * torch.sin(el), vol.origin[2], vol.res)
    in_z = (vz >= 0) & (vz < dz)
    plane = vz.clamp(0, dz - 1) * h
    flat = vol.log.reshape(-1)
    mean = f.get("score_aggregation", "mean") == "mean"
    score_validity = f.get("motion_validity", "reject") == "score"
    rows = max(1, BLOCK_PAIRS // max(n_valid, 1))

    def score(poses):
        p = poses.float()
        total = torch.empty(p.shape[0], dtype=dtype, device=p.device)
        for i0 in range(0, p.shape[0], rows):
            b = p[i0:i0 + rows]
            a = b[:, 2:3] + az[None]
            vx = _voxel(b[:, 0:1] + reach * torch.cos(a), vol.origin[0],
                        vol.res)
            vy = _voxel(b[:, 1:2] + reach * torch.sin(a), vol.origin[1],
                        vol.res)
            inside = in_z & (vx >= 0) & (vx < w) & (vy >= 0) & (vy < h)
            val = flat[(plane + vy.clamp(0, h - 1)) * w + vx.clamp(0, w - 1)]
            total[i0:i0 + rows] = torch.where(inside, val, outside).sum(
                dim=1, dtype=dtype)
        out = total / cnt if mean else total
        if score_validity:
            out = torch.where(ref.is_free(m, p[:, 0], p[:, 1]), out,
                              ref.INVALID if mean else ref.INVALID * cnt)
        if n_valid == 0:
            out = torch.full_like(out, ref.BLIND)
        return out.to(dtype)

    return score
