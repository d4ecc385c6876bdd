"""Likelihood-field sensor basics (port of
``mcmh_localization_tpu/models/sensor.py``): the per-map log-likelihood
table, the score constants and the fixed-step ray cast that makes scans."""

from __future__ import annotations

import math

import torch

LOG_FLOOR = 1e-6        # probability floor (parallel_utils.py:141)
BLIND_SCORE = -50.0     # no-valid-beam penalty (parallel_utils.py:147)
RAY_STEP = 0.1          # ray-march step in meters (parallel_utils.py:10)
# Score for poses on non-free cells under motion_validity="score"
INVALID_SCORE = -100.0


def log_likelihood_field(grid_map, config) -> torch.Tensor:
    """Per-cell log mixture weight L(cell), (H, W) float32:
    ``log(max(z_hit * N(d; 0, sigma_hit) + z_rand / max_range, 1e-6))``
    with ``p_hit = 0`` beyond max_range (parallel_utils.py:135-141)."""
    d = grid_map.distance
    sigma = config.sigma_hit
    norm = torch.sqrt(torch.tensor(2.0 * math.pi * sigma * sigma,
                                   dtype=torch.float32, device=d.device))
    p_hit = torch.exp(-0.5 * (d * d) / (sigma * sigma)) / norm
    p_hit = torch.where(d <= config.max_range, p_hit, 0.0)
    p = config.z_hit * p_hit + config.z_rand / config.max_range
    return torch.log(torch.clamp(p, min=LOG_FLOOR)).to(torch.float32)


def raycast(pose_xy: torch.Tensor, angles: torch.Tensor, grid_map,
            max_range: float, step: float = RAY_STEP,
            hit_unknown: bool = False) -> torch.Tensor:
    """Fixed-step ray march, (M,) predicted ranges (parallel_utils.py:4-29):
    leaving the map returns max_range; the first occupied cell (and, with
    ``hit_unknown``, unknown cell) returns ``i * step``."""
    n_steps = int(max_range / step)
    dev = angles.device
    dists = torch.arange(1, n_steps + 1, dtype=torch.float32, device=dev) * step
    dx = torch.cos(angles)[:, None] * dists[None, :]
    dy = torch.sin(angles)[:, None] * dists[None, :]
    mx, my = grid_map.world_to_grid(pose_xy[0] + dx, pose_xy[1] + dy)
    out = ~grid_map.in_bounds(mx, my)
    occ = grid_map.occupancy_at(mx, my, fill=0)
    hit = (occ > 50) | (hit_unknown & (occ != 0))
    event = out | hit
    any_event = event.any(dim=1)
    first = event.to(torch.uint8).argmax(dim=1)
    first_is_hit = hit.gather(1, first[:, None])[:, 0]
    d_event = torch.where(first_is_hit, dists[first], max_range)
    return torch.where(any_event, d_event, max_range).to(torch.float32)
