"""The one traffic generator: a robot's odometry and lidar stream on a map,
made from a seed and a traffic file's parameters.

The benchmark's own plain-torch copies of the port's scenario code
(``sim/trajectory.py``: ``square_trajectory``, ``fit_trajectory_to_map``,
``second_placement``; ``sim/simulator.py``: the fixed-step ray cast with
unknown cells as obstacles, the range noise on returned beams, and
``_noisy_odometry``), so the yardstick does not move when the program's
copies do.  Two departures, both to make a tour that can run for any number
of scans:

* a lap of the square turns by exactly pi/2 at each corner (the turn rate
  is set so its ticks make a right angle; the port's 0.9 rad/s over
  round(1.745 s * 5 Hz) ticks turns 1.62 rad), so laps close and repeat;
* the odometry noise is drawn for all steps at once (one (T, 3) normal
  draw, integrated with cumulative sums), not step by step.

What varies with the seed: the range noise, the odometry noise and the
filter's own seed.  What does not: the map, the tour and its placements,
and so the work a scan asks for.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Traffic(NamedTuple):
    ranges: np.ndarray       # (T, M) float32 scans as a driver hands them
    odom: np.ndarray         # (T, 3) float32 odometry pose at each scan
    gt: np.ndarray           # (T, 3) float32 true pose at each scan
    placement: np.ndarray    # (T,) int8 which placement of the tour
    odom_per_scan: int
    max_range: float
    n_beams: int


def seeds(seed: int, n: int = 3) -> list[int]:
    """``n`` independent 63-bit seeds from the run's seed: the odometry
    noise, the range noise and the filter's generator."""
    return [int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for s in np.random.SeedSequence(int(seed)).spawn(n)]


def wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def square_lap(p: dict) -> np.ndarray:
    """(L, 3) float64 poses of one closed lap from (0, 0, pi/2): ``side``
    meters at ``speed``, then a left turn in place over ``turn_ticks``
    ticks, four times, at ``rate_hz``."""
    dt = 1.0 / p["rate_hz"]
    side_ticks = int(round(p["side_m"] / p["speed_mps"] * p["rate_hz"]))
    w = (math.pi / 2) / (p["turn_ticks"] * dt)
    pose = np.array([0.0, 0.0, math.pi / 2])
    out = []
    for _ in range(4):
        for v, om, ticks in ((p["speed_mps"], 0.0, side_ticks),
                             (0.0, w, p["turn_ticks"])):
            for _ in range(ticks):
                out.append(pose.copy())
                pose[0] += v * dt * math.cos(pose[2])
                pose[1] += v * dt * math.sin(pose[2])
                pose[2] = wrap(pose[2] + om * dt)
    return np.asarray(out)


def _placement_scores(occ, dist, res, origin, cand, rel):
    """Minimum clearance along ``cand[i] + rel`` (-1 where a pose leaves
    the map or is not free)."""
    h, w = occ.shape
    pts = cand[:, None, :] + rel[None, :, :]
    cx = ((pts[..., 0] - origin[0]) / res).astype(np.int64)
    cy = ((pts[..., 1] - origin[1]) / res).astype(np.int64)
    inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    cyc, cxc = np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)
    free = inb & (occ[cyc, cxc] == 0)
    return np.where(free, dist[cyc, cxc], -1.0).min(axis=1)


def placements(occ, dist, res, origin, lap, p: dict) -> list[np.ndarray]:
    """The lap's centre in the map: first where the least clearance along
    it is largest (``fit_trajectory_to_map`` at scale 1), then, for a
    kidnap mix, the best such centre at least ``kidnap_min_dist_m`` away
    (``second_placement``)."""
    stride, clear = 3, p["min_clearance_m"]
    rows, cols = np.nonzero((occ == 0) & (dist >= clear))
    cand = np.stack([origin[0] + (cols[::stride] + 0.5) * res,
                     origin[1] + (rows[::stride] + 0.5) * res], axis=1)
    rel = lap[:, :2] - lap[:, :2].mean(axis=0)
    score = _placement_scores(occ, dist, res, origin, cand, rel)
    best = int(np.argmax(score))
    if score[best] < clear:
        raise ValueError("the tour fits nowhere on the map")
    out = [cand[best]]
    if p.get("kidnap_every", 0):
        far = np.hypot(*(cand - cand[best]).T) >= p["kidnap_min_dist_m"]
        s2 = np.where(far, score, -1.0)
        b2 = int(np.argmax(s2))
        if s2[b2] < clear:
            raise ValueError("no distant placement for the kidnap")
        out.append(cand[b2])
    return [c - lap[:, :2].mean(axis=0) for c in out]


def raycast(poses: torch.Tensor, angles: torch.Tensor, occ: torch.Tensor,
            res: float, origin, max_range: float,
            ray_step: float) -> torch.Tensor:
    """(N, M) ranges: march each beam in ``ray_step`` steps; the first
    non-free cell (occupied or unknown) returns its distance, leaving the
    map or no hit returns ``max_range``."""
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


def noisy_odometry(gt: np.ndarray, alpha, seed: int) -> np.ndarray:
    """(T, 3) odometry: the true per-step (rot1, trans, rot2) with
    alpha-scaled Gaussian noise, integrated from the first true pose."""
    a1, a2, a3, a4 = alpha
    d = np.diff(gt.astype(np.float64), axis=0)
    r1 = wrap(np.arctan2(d[:, 1], d[:, 0]) - gt[:-1, 2])
    tr = np.hypot(d[:, 0], d[:, 1])
    r2 = wrap(d[:, 2]) - r1
    # a turn in place has no direction of travel: all of it is rot2
    still = tr < 1e-9
    r2 = np.where(still, wrap(d[:, 2]), r2)
    r1 = np.where(still, 0.0, r1)
    z = np.random.default_rng(seed).standard_normal((len(d), 3))
    r1n = r1 + z[:, 0] * (a1 * abs(r1) + a2 * tr)
    trn = tr + z[:, 1] * (a3 * tr + a4 * (abs(r1n) + abs(r2)))
    r2n = r2 + z[:, 2] * (a1 * abs(r2) + a2 * abs(trn))
    th = np.concatenate([[gt[0, 2]], gt[0, 2] + np.cumsum(r1n + r2n)])
    heading = th[:-1] + r1n
    x = gt[0, 0] + np.concatenate([[0.0], np.cumsum(trn * np.cos(heading))])
    y = gt[0, 1] + np.concatenate([[0.0], np.cumsum(trn * np.sin(heading))])
    return np.stack([x, y, wrap(th)], axis=1).astype(np.float32)


def make(p: dict, occ_np: np.ndarray, dist_np: np.ndarray, res: float,
         origin, scans: int, seed: int, device) -> Traffic:
    """``scans`` scans of the mix ``p`` on the map: laps of the tour at
    the first placement, and, with ``kidnap_every`` > 0, the scans
    switching between the two placements every that many scans after
    ``settle_scans`` (the odometry blind to it).  The lap's scans are ray
    cast once a placement on ``device``; every scan gets its own range
    noise there."""
    odom_seed, noise_seed, _ = seeds(seed)
    lap = square_lap(p)
    spots = placements(occ_np, dist_np, res, origin, lap, p)
    t = np.arange(scans)
    place = np.zeros(scans, dtype=np.int8)
    if p.get("kidnap_every", 0):
        after = np.maximum(t - p["settle_scans"], 0)
        place = np.where(t >= p["settle_scans"] + p["kidnap_every"],
                         (after // p["kidnap_every"]) % 2, 0).astype(np.int8)
    tick = t % len(lap)
    gt = lap[tick].copy()
    gt[:, :2] += np.stack(spots)[place]
    occ = torch.from_numpy(occ_np).to(device)
    angles = torch.linspace(-math.pi, math.pi, p["n_beams"],
                            dtype=torch.float32, device=device)
    lap_scans = []
    for spot in spots:
        poses = lap.copy()
        poses[:, :2] += spot
        lap_scans.append(raycast(
            torch.from_numpy(poses.astype(np.float32)).to(device), angles,
            occ, res, origin, p["max_range_m"], p["ray_step_m"]))
    lap_scans = torch.stack(lap_scans)                      # (P, L, M)
    idx = torch.from_numpy(place.astype(np.int64) * len(lap) + tick).to(device)
    clean = lap_scans.reshape(-1, p["n_beams"])[idx]
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    noise = torch.randn(clean.shape, generator=gen, device=device)
    hit = clean < p["max_range_m"]
    ranges = torch.where(
        hit, torch.clamp(clean + noise * p["range_noise_m"], 0.01,
                         p["max_range_m"]), clean)
    # the odometry follows the first placement: continuous through a kidnap
    tour = lap[tick].copy()
    tour[:, :2] += spots[0]
    odom = noisy_odometry(tour, p["odom_alpha"], odom_seed)
    return Traffic(ranges=ranges.cpu().numpy(), odom=odom,
                   gt=gt.astype(np.float32), placement=place,
                   odom_per_scan=int(p["odom_per_scan"]),
                   max_range=float(p["max_range_m"]),
                   n_beams=int(p["n_beams"]))
