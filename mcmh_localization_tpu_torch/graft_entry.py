"""The entry points (twins of ``__graft_entry__.py``).

``entry(device=None)`` returns ``(fn, example_args)``: ``fn(state, ranges,
angles, delta)`` is the flagship AMHAMCL filter step (``_predict`` +
``_correct`` over the exact likelihood field: motion proposal, weights,
MH, the adaptive resample), and ``example_args`` one scan's inputs for it.

``dryrun_multichip(n_devices)`` runs one step of each multi-rank path on
the process group the caller set up (NCCL on cards, gloo on the CPU), on
every rank.  JAX switches to a virtual CPU mesh when it has too few
devices; this one raises, since the port picks no device for the caller.

The map is always the JAX entry point's procedural room (256 x 256 cells
at 0.1 m: walls and one inner wall).  The JAX entry point reads the
reference's ``map_house.yaml`` where that file exists; the port names no
path outside its checkout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mcmh_localization_tpu_torch.config import FilterConfig
from mcmh_localization_tpu_torch.filter.step import _correct, _predict, make_model
from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map
from mcmh_localization_tpu_torch.models.sensor import raycast
from mcmh_localization_tpu_torch.utils.device import DEFAULT_DEVICE

ROOM_CELLS = 256
ROOM_RES = 0.1


def room_occupancy(n: int = ROOM_CELLS) -> np.ndarray:
    """The JAX entry point's procedural room: a wall ring and one inner
    wall across the lower half (``__graft_entry__.py::_build_map``)."""
    occ = np.full((n, n), 0, dtype=np.int8)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = 100
    occ[n // 3, : n // 2] = 100
    return occ


def entry_config() -> FilterConfig:
    """The flagship AMHAMCL at 4096 particles (min 256), started at
    (0, 0, 0.3)."""
    return FilterConfig(mode="AMHAMCL", num_particles=4096, min_particles=256,
                        max_particles=4096, initialized=True,
                        initial_pose=(0.0, 0.0, 0.3))


def example_scan(grid_map, config, n_beams: int = 360):
    """(ranges, angles, delta): a ray-cast scan of ``n_beams`` beams over
    [-pi, pi] from the config's initial pose, and the odometry delta (0.01,
    0.05, 0.005)."""
    dev = grid_map.device
    angles = torch.linspace(-math.pi, math.pi, n_beams, dtype=torch.float32,
                            device=dev)
    pose = torch.tensor(config.initial_pose, dtype=torch.float32, device=dev)
    ranges = raycast(pose[:2], pose[2] + angles, grid_map, config.max_range,
                     hit_unknown=True)
    delta = torch.tensor([0.01, 0.05, 0.005], dtype=torch.float32, device=dev)
    return ranges, angles, delta


def example_inputs(model, n_beams: int = 360, seed: int = 0):
    """(state, ranges, angles, delta): the initial state from ``seed`` and
    ``example_scan``'s scan."""
    return (model.init(seed),
            *example_scan(model.grid_map, model.config, n_beams))


def entry(device=None):
    """The flagship step and its example inputs, on ``device`` (the card
    unless told otherwise; raises without one)."""
    n = ROOM_CELLS
    grid_map = build_grid_map(room_occupancy(n), ROOM_RES,
                              (-n * 0.05, -n * 0.05),
                              device=DEFAULT_DEVICE if device is None
                              else device)
    model = make_model(entry_config(), grid_map)
    config, log_field = model.config, model.log_field

    def fn(state, ranges, angles, delta):
        state = _predict(state, delta, grid_map, config)
        return _correct(state, ranges, angles, grid_map, log_field, config)

    return fn, example_inputs(model)


def _finite(info) -> None:
    if not torch.isfinite(info.estimate.mean).all():
        raise RuntimeError(f"non-finite estimate {info.estimate.mean}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of each multi-rank path on the first ``n_devices`` ranks of
    the caller's process group, at the JAX dry run's widths
    (``__graft_entry__.py:86-212``): the distributed corr filter (8192
    particles a rank, theta-sharded builds), the GSPMD twin, the beam
    field, the 3-D lidar, and the staged hand-off cycle big -> shrink ->
    small -> grow -> big.  Every rank calls it, on ``device``: the rank's
    current card unless told otherwise (``parallel/sharding.py::
    rank_device``; pass ``device="cpu"`` for the CPU).  Raises when the
    group has fewer than ``n_devices`` ranks or cannot carry tensors on
    the device."""
    import torch.distributed as dist

    from mcmh_localization_tpu_torch.filter.staged import (
        make_staged_dist_model,
    )
    from mcmh_localization_tpu_torch.filter.step import state_size
    from mcmh_localization_tpu_torch.maps.voxel_map import (
        build_voxel_map,
        nav_slice,
    )
    from mcmh_localization_tpu_torch.parallel.distributed import (
        make_dist_model,
    )
    from mcmh_localization_tpu_torch.parallel.sharding import (
        make_mesh,
        make_sharded_model,
        rank_device,
    )

    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs a process group of "
            f"{n_devices} ranks, have {world}: start one rank a device "
            "(torch.distributed.init_process_group) first")
    dev = rank_device(device)
    mesh = make_mesh(range(n_devices))
    if dist.get_rank() >= n_devices:
        return
    n = 64
    grid_map = build_grid_map(room_occupancy(n), ROOM_RES,
                              (-n * 0.05, -n * 0.05), device=dev)
    # 1) the distributed filter: theta-sharded corr builds, psum-only
    #    reductions, island resampling and the ring migration
    config = FilterConfig(
        mode="AMHAMCL", num_particles=8192 * n_devices,
        min_particles=2 * n_devices, max_particles=8192 * n_devices,
        initialized=True, initial_pose=(0.0, 0.0, 0.0),
        likelihood_impl="corr", corr_n_theta=16, corr_window_cells=32,
        corr_theta_window_bins=8, corr_coarse_factor=4, corr_coarse_n_theta=8,
    )
    model = make_dist_model(config, grid_map, mesh)
    ranges, angles, delta = example_scan(grid_map, model.config, n_beams=32)
    _, info = model.step(model.init(0), ranges, angles, delta)
    _finite(info)
    # 2) the GSPMD twin
    config2 = FilterConfig(
        mode="AMHAMCL", num_particles=16 * n_devices, min_particles=8,
        max_particles=16 * n_devices, initialized=True,
        initial_pose=(0.0, 0.0, 0.0))
    model2 = make_sharded_model(config2, grid_map, mesh)
    _, info2 = model2.step(model2.init(0), ranges, angles, delta)
    _finite(info2)
    # 3) the beam field, its theta bins sharded
    config3 = config.replace(sensor_model="beam", beam_impl="field",
                             beam_table_n_theta=16, likelihood_impl="auto")
    model3 = make_dist_model(config3, grid_map, mesh)
    _, info3 = model3.step(model3.init(0), ranges, angles, delta)
    _finite(info3)
    # 4) the 3-D lidar: the score volume on every rank, lookups local
    occ3 = np.zeros((10, 32, 32), dtype=np.int8)
    occ3[:, 0, :] = occ3[:, -1, :] = 100
    occ3[:, :, 0] = occ3[:, :, -1] = 100
    occ3[0, :, :] = 100
    room3d = build_voxel_map(occ3, 0.1, (-1.6, -1.6, 0.0), device=dev)
    nav = nav_slice(room3d, z=0.1)
    az = np.linspace(-np.pi, np.pi, 8, endpoint=False)
    directions = torch.tensor(
        np.stack([np.repeat(az, 2), np.tile([-0.1, 0.1], 8)], 1),
        dtype=torch.float32, device=dev)
    config4 = FilterConfig(
        mode="MCL", num_particles=16 * n_devices, initialized=True,
        initial_pose=(0.0, 0.0, 0.0), max_range=3.0,
        sensor_model="lidar3d", lidar3d_sensor_z=0.5)
    model4 = make_dist_model(config4, nav, mesh, voxel_map=room3d)
    ranges3d = torch.full((directions.shape[0],), 1.2, device=dev)
    _, info4 = model4.step(model4.init(0), ranges3d, directions, delta)
    _finite(info4)
    # 5) the staged hand-off cycle, each rank resizing its own rows
    staged = make_staged_dist_model(
        config, grid_map, mesh,
        tracking_capacity=max(2048, 4 * config.min_particles))
    st5, _ = staged.big.step(staged.init(0), ranges, angles, delta)
    st5 = staged.shrink(st5)
    if st5.particles.shape[0] != state_size(staged.small_config) // n_devices:
        raise RuntimeError(f"shrink kept {st5.particles.shape[0]} rows")
    st5, _ = staged.small.step(st5, ranges, angles, delta)
    st5 = staged.grow(st5)
    if st5.particles.shape[0] != state_size(staged.config) // n_devices:
        raise RuntimeError(f"grow left {st5.particles.shape[0]} rows")
    _, info5 = staged.big.step(st5, ranges, angles, delta)
    _finite(info5)
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: {n_devices} ranks, "
              f"{model.config.max_particles} particles (distributed corr + "
              "GSPMD + distributed beam field + distributed lidar3d + "
              f"staged hand-off cycle), mesh={tuple(mesh.shape)} on {dev}")
