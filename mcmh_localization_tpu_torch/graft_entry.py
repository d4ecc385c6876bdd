"""The single-card entry point (twin of ``__graft_entry__.py::entry``).

``entry(device=None)`` returns ``(fn, example_args)``: ``fn(state, ranges,
angles, delta)`` is the flagship AMHAMCL filter step (``_predict`` +
``_correct`` over the exact likelihood field: motion proposal, weights,
MH, the adaptive resample), and ``example_args`` one scan's inputs for it.

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


def example_inputs(model, n_beams: int = 360, seed: int = 0):
    """(state, ranges, angles, delta): the initial state from ``seed``, a
    ray-cast scan of ``n_beams`` beams over [-pi, pi] from the initial
    pose, and the odometry delta (0.01, 0.05, 0.005)."""
    config, grid_map = model.config, model.grid_map
    dev = grid_map.device
    state = model.init(seed)
    angles = torch.linspace(-math.pi, math.pi, n_beams, dtype=torch.float32,
                            device=dev)
    pose = torch.tensor(config.initial_pose, dtype=torch.float32, device=dev)
    ranges = raycast(pose[:2], pose[2] + angles, grid_map, config.max_range,
                     hit_unknown=True)
    delta = torch.tensor([0.01, 0.05, 0.005], dtype=torch.float32, device=dev)
    return state, ranges, angles, delta


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
