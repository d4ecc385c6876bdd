"""Particle initialization (port of ``mcmh_localization_tpu/filter/init.py``).

The draws come in as arguments (so a test can hand in the JAX ones) or
from ``generator``."""

from __future__ import annotations

import math

import torch

# above this count, free cells come from a tiled iid pool (the JAX package's
# _POOL; slot order carries no meaning downstream)
_POOL = 65536


def uniform_draws(n: int, grid_map, generator: torch.Generator | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``init_uniform``'s draws, in its order: (cells, jitter, theta)."""
    dev = grid_map.device
    f = grid_map.free_xy.shape[0]
    cells = torch.randint(0, f, (min(n, _POOL),), generator=generator,
                          device=dev)
    jitter = torch.rand((n, 2), generator=generator, device=dev) - 0.5
    theta = torch.rand((n,), generator=generator, device=dev) \
        * (2.0 * math.pi) - math.pi
    return cells, jitter, theta


def init_uniform(
    n: int,
    grid_map,
    generator: torch.Generator | None = None,
    cells: torch.Tensor | None = None,
    jitter: torch.Tensor | None = None,
    theta: torch.Tensor | None = None,
) -> torch.Tensor:
    """(n, 3) poses uniform over free space, theta ~ U(-pi, pi).

    ``cells``: (min(n, 65536),) int free-cell indices; ``jitter``: (n, 2)
    U(-0.5, 0.5) in-cell offsets (in cells); ``theta``: (n,) headings
    (``uniform_draws``; drawn from ``generator`` where None)."""
    if cells is None or jitter is None or theta is None:
        drawn = uniform_draws(n, grid_map, generator)
        cells, jitter, theta = (d if g is None else g for d, g in
                                zip(drawn, (cells, jitter, theta)))
    pool = min(n, _POOL)
    xy = grid_map.free_xy[cells.to(torch.int64)]
    if pool < n:
        xy = xy.repeat(-(-n // pool), 1)[:n]
    return torch.cat([xy + jitter * grid_map.resolution, theta[:, None]],
                     dim=1).to(torch.float32)


def init_gaussian(
    mean,
    cov,
    n: int,
    grid_map,
    ref_compat: bool = False,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """(n, 3) poses ~ N(mean, cov), validated against the map: a sample is
    kept iff its cell is free, else it collapses to the mean; with
    ``ref_compat`` the reference's in-bounds and distance < 1 m test, with
    rejected samples zeroed.  ``noise``: (n, 3) standard normals."""
    dev = grid_map.device
    mean = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    chol = torch.linalg.cholesky(torch.as_tensor(cov, dtype=torch.float32,
                                                 device=dev))
    if noise is None:
        noise = torch.randn((n, 3), generator=generator, device=dev)
    samples = mean[None, :] + noise @ chol.T
    mx, my = grid_map.world_to_grid(samples[:, 0], samples[:, 1])
    if ref_compat:
        ok = grid_map.in_bounds(mx, my) & (
            grid_map.distance_at(mx, my, fill=math.inf) < 1.0)
        fallback = torch.zeros_like(samples)
    else:
        ok = grid_map.occupancy_at(mx, my) == 0
        fallback = mean.expand_as(samples)
    return torch.where(ok[:, None], samples, fallback)
