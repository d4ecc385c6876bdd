"""Ground-truth trajectory generators for the four evaluation scenarios
(port of ``mcmh_localization_tpu/sim/trajectory.py``: the generators are
its numpy code as it is; the map fitting reads the map through
``_host_map``, one copy of its tensors to the host).

The reference evaluated against four recorded TurtleBot3 rosbags named
``static``, ``straight_line_spin``, ``square``, ``L_rest``
(.MISSING_LARGE_BLOBS:1-4; run_all_modes.sh:8) which were stripped from the
repository.  These generators recreate the same scenario *shapes* as
deterministic differential-drive trajectories on the shipped maps, so the
whole evaluation harness runs without any recorded data (SURVEY.md §4
"deterministic simulator becomes the fixture generator").

All trajectories are (T, 3) float32 [x, y, theta] sampled at ``rate`` Hz with
theta wrapped to [-pi, pi) (odometry yaw is quaternion-derived in ROS and
therefore always wrapped).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mcmh_localization_tpu_torch.utils.host import to_numpy


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _rollout(v_w_pairs, start, rate):
    """Integrate (v, w) command segments into poses at `rate` Hz."""
    dt = 1.0 / rate
    pose = np.array(start, dtype=np.float64)
    poses = [pose.copy()]
    for v, w, duration in v_w_pairs:
        for _ in range(int(round(duration * rate))):
            pose[0] += v * dt * np.cos(pose[2])
            pose[1] += v * dt * np.sin(pose[2])
            pose[2] = _wrap(pose[2] + w * dt)
            poses.append(pose.copy())
    out = np.asarray(poses, dtype=np.float32)
    out[:, 2] = _wrap(out[:, 2])
    return out


def static_trajectory(duration=20.0, rate=5.0, start=(0.0, 0.0, 0.0)):
    """Stationary robot (the reference's `static` bag)."""
    return _rollout([(0.0, 0.0, duration)], start, rate)


def straight_line_spin_trajectory(
    duration=24.0, rate=5.0, start=(-1.5, 0.0, 0.0), speed=0.15, spin=0.9
):
    """Drive straight, spin in place, drive back (`straight_line_spin`)."""
    t_line = duration * 0.4
    t_spin = duration * 0.2
    return _rollout(
        [
            (speed, 0.0, t_line),
            (0.0, spin, t_spin),
            (speed, 0.0, t_line),
        ],
        start,
        rate,
    )


def square_trajectory(
    duration=32.0, rate=5.0, start=(1.0, -1.0, np.pi / 2), side=1.5, speed=0.15
):
    """Closed square loop (`square`), repeated to fill the duration."""
    t_side = side / speed
    t_turn = (np.pi / 2) / 0.9
    cycle = [(speed, 0.0, t_side), (0.0, 0.9, t_turn)]
    t_total = 0.0
    segments = []
    while t_total < duration:
        segments.extend(cycle)
        t_total += t_side + t_turn
    return _rollout(segments, start, rate)


def l_rest_trajectory(
    duration=24.0, rate=5.0, start=(-1.5, -1.5, 0.0), speed=0.15
):
    """L-shaped path then rest (`L_rest`)."""
    t_leg = duration * 0.3
    t_turn = (np.pi / 2) / 0.9
    t_rest = max(duration - 2 * t_leg - t_turn, 0.0)
    return _rollout(
        [
            (speed, 0.0, t_leg),
            (0.0, 0.9, t_turn),
            (speed, 0.0, t_leg),
            (0.0, 0.0, t_rest),
        ],
        start,
        rate,
    )


class HostMap(NamedTuple):
    """The map fields trajectory fitting reads, as host arrays."""

    occupancy: np.ndarray   # (H, W) int8
    distance: np.ndarray    # (H, W) f32 meters
    resolution: float
    origin: np.ndarray      # (2,) float64


def _host_map(grid_map) -> HostMap:
    """``grid_map``'s occupancy, distance, resolution and origin on the
    host: one copy of each tensor, wherever the map lives."""
    if isinstance(grid_map, HostMap):
        return grid_map
    return HostMap(
        occupancy=to_numpy(grid_map.occupancy),
        distance=to_numpy(grid_map.distance),
        resolution=float(grid_map.res),
        origin=np.asarray(grid_map.origin_xy, dtype=np.float64),
    )


def _free_anchor_candidates(grid_map, min_clearance: float, stride: int):
    """(C, 2) world-frame anchor candidates: free cells with clearance."""
    hm = _host_map(grid_map)
    res, origin = hm.resolution, hm.origin
    free_r, free_c = np.nonzero((hm.occupancy == 0)
                                & (hm.distance >= min_clearance))
    if free_r.size == 0:
        raise ValueError("map has no free cell with the requested clearance")
    return np.stack(
        [origin[0] + (free_c[::stride] + 0.5) * res,
         origin[1] + (free_r[::stride] + 0.5) * res], axis=1
    )


def _placement_scores(grid_map, cand: np.ndarray, rel: np.ndarray):
    """Min path clearance for every candidate placement ``cand[i] + rel``
    ((C,) meters; -1 where any pose leaves the map or hits occupancy)."""
    hm = _host_map(grid_map)
    occupancy, distance = hm.occupancy, hm.distance
    res, origin = hm.resolution, hm.origin
    h, w = occupancy.shape
    pts = cand[:, None, :] + rel[None, :, :]  # (C, T, 2)
    cx = ((pts[..., 0] - origin[0]) / res).astype(np.int64)
    cy = ((pts[..., 1] - origin[1]) / res).astype(np.int64)
    inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    d = np.where(
        inb, distance[np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)], -1.0
    )
    free = np.where(
        inb, occupancy[np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)] == 0, False
    )
    return np.where(free, d, -1.0).min(axis=1)


def fit_trajectory_to_map(
    grid_map,
    poses: np.ndarray,
    min_clearance: float = 0.2,
    scales=(1.0, 0.8, 0.6, 0.45, 0.3),
    stride: int = 3,
) -> np.ndarray:
    """Translate (and if needed shrink) a trajectory so every pose sits in
    free space with at least ``min_clearance`` meters of obstacle clearance.

    The scenario generators draw canonical shapes; real maps (e.g. the
    furnished map_house, app/maps/map_house.pgm) have tight free space, so
    the harness anchors each shape at the best-fitting open region instead
    of assuming the origin is drivable.  Deterministic: picks the placement
    maximizing the minimum clearance along the path.
    """
    grid_map = _host_map(grid_map)
    cand = _free_anchor_candidates(grid_map, min_clearance, stride)
    xy = poses[:, :2].astype(np.float64)
    center = xy.mean(axis=0)
    for scale in scales:
        rel = (xy - center) * scale  # (T, 2)
        score = _placement_scores(grid_map, cand, rel)
        best = int(np.argmax(score))
        if score[best] >= min_clearance:
            out = poses.copy()
            out[:, :2] = (cand[best] + rel).astype(np.float32)
            return out
    raise ValueError(
        f"no placement found with clearance >= {min_clearance} at any scale"
    )


def second_placement(
    grid_map,
    poses: np.ndarray,
    min_clearance: float = 0.2,
    min_dist: float = 3.0,
    stride: int = 3,
) -> np.ndarray:
    """A second free placement of ``poses`` whose anchor is at least
    ``min_dist`` meters from the current one — the kidnapped-robot
    scenario constructor: run the filter on leg A, teleport the scans to
    the rigid translate leg B while odometry stays continuous (the
    evaluation pattern behind the reference's augmented-MCL recovery
    machinery, amcmh_localizer.py:447-467; used by the kidnap tests and
    scripts/kidnap_1m.py).

    Same deterministic candidate scoring as :func:`fit_trajectory_to_map`
    (no rescaling — the two legs must be congruent so odometry deltas fit
    both), restricted to anchors ``min_dist`` away.
    """
    grid_map = _host_map(grid_map)
    cand = _free_anchor_candidates(grid_map, min_clearance, stride)
    xy = poses[:, :2].astype(np.float64)
    center = xy.mean(axis=0)
    far = np.hypot(cand[:, 0] - center[0], cand[:, 1] - center[1]) >= min_dist
    cand = cand[far]
    if cand.shape[0] == 0:
        raise ValueError(f"no free anchor at least {min_dist} m away")
    rel = xy - center
    score = _placement_scores(grid_map, cand, rel)
    best = int(np.argmax(score))
    if score[best] < min_clearance:
        raise ValueError(
            f"no distant placement with clearance >= {min_clearance}"
        )
    out = poses.copy()
    out[:, :2] = (cand[best] + rel).astype(np.float32)
    return out


SCENARIOS = {
    "static": static_trajectory,
    "straight_line_spin": straight_line_spin_trajectory,
    "square": square_trajectory,
    "L_rest": l_rest_trajectory,
}
