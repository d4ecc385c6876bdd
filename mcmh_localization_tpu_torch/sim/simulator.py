"""Synthetic scan/odometry simulator — the replacement for `rosbag play`
(port of ``mcmh_localization_tpu/sim/simulator.py``).

Generates what the reference consumed from its (missing) evaluation bags
(`/scan` + `/odom` + Gazebo ground truth, test_algs.launch:9-46): ray-cast
LDS-style scans from the ground-truth trajectory plus drift-noised odometry,
packaged as a Bag.  Scans come from the port's fixed-step raycaster
(models/sensor.py) with unknown-as-obstacle semantics, all poses of a chunk
in one batched call on the map's device.

Randomness: the JAX key becomes ``seed``, an integer or a
``torch.Generator``.  The range noise is drawn from a generator on the
map's device; the odometry noise is numpy's, seeded with one integer
(``_noisy_odometry``), as in the JAX package.  So a bag matches a JAX bag of
the same trajectory statistically, never draw for draw.  The returned
``Bag`` holds host numpy arrays: bags are files and host data.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mcmh_localization_tpu_torch.filter.state import make_generator, split_seed
from mcmh_localization_tpu_torch.models.motion import compute_motion
from mcmh_localization_tpu_torch.models.sensor import raycast
from mcmh_localization_tpu_torch.utils.angles import normalize_angle
from mcmh_localization_tpu_torch.utils.host import to_numpy

# ray samples (poses x beams x steps) a raycast chunk holds at once
RAYCAST_CHUNK_SAMPLES = 1 << 23


class Bag(NamedTuple):
    """A recorded run: everything the filter + evaluator consume."""

    ranges: np.ndarray   # (T, M) float32 scan ranges
    angles: np.ndarray   # (M,) beam angles in the sensor frame
    odom: np.ndarray     # (T, 3) odometry poses (drift-noised ground truth)
    gt: np.ndarray       # (T, 3) ground-truth poses
    times: np.ndarray    # (T,) seconds
    max_range: float
    meta: dict


def odometry_deltas(odom: np.ndarray) -> np.ndarray:
    """(T, 3) per-step (rot1, trans, rot2) from consecutive odometry poses;
    row 0 is zeros (no motion before the first scan).  Mirrors the odometry
    decomposition at amcmh_localizer.py:410-421; one batched
    ``compute_motion`` over the T - 1 steps, on the host."""
    odom = torch.as_tensor(np.asarray(odom, dtype=np.float32))
    deltas = compute_motion(odom[:-1].T, odom[1:].T).T
    return np.concatenate(
        [np.zeros((1, 3), dtype=np.float32), deltas.numpy().astype(np.float32)]
    )


def _noisy_odometry(rng_seed: int, gt: np.ndarray,
                    alpha: Tuple[float, float, float, float]):
    """Integrate ground-truth per-step motion with alpha-scaled noise to
    produce a drifting odometry track (the real-world gap between /odom and
    Gazebo ground truth that the evaluator measures).  ``rng_seed`` seeds
    numpy's generator, as the JAX package seeds it from its key's last
    word."""
    a1, a2, a3, a4 = alpha
    rng = np.random.default_rng(rng_seed)
    steps = odometry_deltas(gt)
    odom = np.zeros_like(gt)
    odom[0] = gt[0]
    for t in range(1, len(gt)):
        r1, tr, r2 = steps[t]
        r1 += rng.normal(0, a1 * abs(r1) + a2 * abs(tr))
        tr += rng.normal(0, a3 * abs(tr) + a4 * (abs(r1) + abs(r2)))
        r2 += rng.normal(0, a1 * abs(r2) + a2 * abs(tr))
        x, y, th = odom[t - 1]
        odom[t] = [
            x + tr * np.cos(th + r1),
            y + tr * np.sin(th + r1),
            float(normalize_angle(th + r1 + r2)),
        ]
    return odom.astype(np.float32)


def _seeds(seed, device) -> tuple[int, torch.Generator]:
    """(odometry seed, range-noise generator on ``device``) from an integer
    seed (two independent streams) or from a generator (the odometry seed
    drawn from it)."""
    if isinstance(seed, torch.Generator):
        odom_seed = int(torch.randint(0, 2**62, (), generator=seed,
                                      device=seed.device))
        return odom_seed, seed
    odom_seed, noise_seed = split_seed(seed)
    return odom_seed, make_generator(noise_seed, device)


def simulate_bag(
    seed: int | torch.Generator,
    grid_map,
    gt_poses: np.ndarray,
    n_beams: int = 360,
    max_range: float = 5.0,
    rate: float = 5.0,
    ray_step: float = 0.02,
    odom_alpha: Tuple[float, float, float, float] = (0.002, 0.002, 0.01, 0.002),
    range_noise: float = 0.0,
    name: str = "sim",
) -> Bag:
    """Simulate a full run along ``gt_poses`` ((T, 3), theta wrapped).

    ``range_noise`` adds Gaussian noise to the simulated ranges; the default
    LDS angle layout matches get_lidar_angles (amcmh_localizer.py:346-348)
    with [-pi, pi] coverage.  The scans are ray-cast on the map's device,
    chunked over poses to bound memory.
    """
    dev = grid_map.device
    gt_poses = np.asarray(gt_poses, dtype=np.float32)
    t_steps = len(gt_poses)
    angles = torch.linspace(-np.pi, np.pi, n_beams, dtype=torch.float32,
                            device=dev)
    odom_seed, noise_gen = _seeds(seed, dev)

    poses = torch.from_numpy(gt_poses).to(dev)
    per_pose = n_beams * int(max_range / ray_step)
    chunk = max(1, RAYCAST_CHUNK_SAMPLES // max(per_pose, 1))
    scans = torch.cat([
        raycast(p[:, :2], p[:, 2:3] + angles, grid_map, max_range,
                step=ray_step, hit_unknown=True)
        for p in poses.split(chunk)
    ]) if t_steps else torch.zeros((0, n_beams), device=dev)
    if range_noise > 0:
        noise = torch.randn(scans.shape, generator=noise_gen,
                            device=dev) * range_noise
        hit = scans < max_range  # only returned beams carry sensor noise
        scans = torch.where(hit, torch.clamp(scans + noise, 0.01, max_range),
                            scans)

    odom = _noisy_odometry(odom_seed, gt_poses, odom_alpha)
    times = (np.arange(t_steps) / rate).astype(np.float32)
    return Bag(
        ranges=to_numpy(scans).astype(np.float32),
        angles=to_numpy(angles),
        odom=odom,
        gt=gt_poses,
        times=times,
        max_range=float(max_range),
        meta={"name": name, "n_beams": n_beams, "rate": rate},
    )


def drive_bag(
    seed: int | torch.Generator,
    grid_map,
    commands,
    duration: float | None = None,
    rate: float = 5.0,
    start_pose=(0.0, 0.0, 0.0),
    clearance: float = 0.15,
    name: str = "drive",
    **sim_kwargs,
) -> Bag:
    """Interactive (v, omega) command-stream driving — the library
    equivalent of the reference's Gazebo + keyboard-teleop live sim
    (mcmh_localization.launch:8-46, where /cmd_vel drives the robot and
    the localizer consumes the resulting /scan + /odom).

    ``commands`` is either an (T, 2) array of per-tick (v, omega) — an
    open-loop recorded teleop stream — or a callable
    ``controller(t_seconds, pose3) -> (v, omega)`` for closed-loop
    driving (``duration`` required then).  Unicycle integration at
    ``rate`` Hz with wall collision: a commanded translation into a cell
    closer than ``clearance`` to an obstacle is dropped for that tick
    (the robot 'bumps and stops', rotation still applies), matching how
    a teleoped TurtleBot cannot drive through walls.  The resulting
    ground-truth trajectory feeds :func:`simulate_bag` (scans + noisy
    odometry), so every downstream consumer (filter, evaluator, bag
    save/replay) works unchanged.  The distance map comes to the host
    once, before the first tick."""
    pose = np.asarray(start_pose, dtype=np.float32).copy()
    dt = 1.0 / rate
    if callable(commands):
        if duration is None:
            raise ValueError("duration is required with a controller callable")
        t_steps = int(round(duration * rate))
        get = lambda t: commands(t * dt, pose.copy())  # noqa: E731
    else:
        commands = np.asarray(commands, dtype=np.float32)
        t_steps = len(commands)
        get = lambda t: commands[t]  # noqa: E731

    distance = to_numpy(grid_map.distance)
    ox, oy = grid_map.origin_xy
    res = grid_map.res
    h, w = distance.shape

    def _clear(x, y):
        mx = int((x - ox) / res)
        my = int((y - oy) / res)
        if not (0 <= mx < w and 0 <= my < h):
            return 0.0
        return float(distance[my, mx])

    poses = [pose.copy()]
    for t in range(t_steps - 1):
        v, w_cmd = get(t)
        th = pose[2] + 0.5 * w_cmd * dt  # midpoint heading for the arc
        nx = pose[0] + v * dt * np.cos(th)
        ny = pose[1] + v * dt * np.sin(th)
        if _clear(nx, ny) >= clearance:
            pose[0], pose[1] = nx, ny
        pose[2] = float(normalize_angle(np.float32(pose[2] + w_cmd * dt)))
        poses.append(pose.copy())
    return simulate_bag(
        seed, grid_map, np.asarray(poses), rate=rate, name=name, **sim_kwargs
    )
