"""Likelihood-field sensor model (port of
``mcmh_localization_tpu/models/sensor.py``): the per-map log-likelihood
table, the score constants, the exact scorer (its reads are the kernel of
``ops/likelihood.py``), the motion-validity wrap, the fixed-step ray cast
that makes scans, and the beam model's per-(particle, beam) ray-march
scorer."""

from __future__ import annotations

import math

import numpy as np
import torch

from mcmh_localization_tpu_torch.utils.f32 import divide

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


def scan_endpoints(particles: torch.Tensor, ranges: torch.Tensor,
                   angles: torch.Tensor):
    """(lx, ly), each (N, M): world endpoints of every beam from every
    pose, ``x + cos(theta) u - sin(theta) v`` with ``u, v = r cos(a),
    r sin(a)``."""
    from mcmh_localization_tpu_torch.ops.likelihood import scan_endpoints_uv

    return scan_endpoints_uv(particles, ranges * torch.cos(angles),
                             ranges * torch.sin(angles))


def likelihood_field_scores(particles: torch.Tensor, ranges: torch.Tensor,
                            angles: torch.Tensor, grid_map, config,
                            log_field: torch.Tensor | None = None,
                            cell_div: bool = True) -> torch.Tensor:
    """(N,) exact per-particle scores (parallel_utils.py:85-149): beams
    subsampled by ``config.step``; valid = finite and < max_range; valid
    beams off the map count in the denominator and add 0; the blind
    penalty when no beam is valid.  ``cell_div`` finds a beam's cell by
    dividing by the resolution (the JAX "jnp" scorer) or, when False, by
    multiplying by its f32 inverse (the JAX "pallas" scorer)."""
    from mcmh_localization_tpu_torch.ops.likelihood import likelihood_scores

    if log_field is None:
        log_field = log_likelihood_field(grid_map, config)
    if config.step > 1:
        ranges = ranges[:: config.step]
        angles = angles[:: config.step]
    valid = torch.isfinite(ranges) & (ranges < config.max_range)
    safe_r = torch.where(valid, ranges, 0.0)
    u = (safe_r * torch.cos(angles)).to(torch.float32).contiguous()
    v = (safe_r * torch.sin(angles)).to(torch.float32).contiguous()
    return likelihood_scores(
        particles.contiguous(), u, v, valid.contiguous(), log_field.contiguous(),
        grid_map.origin_xy[0], grid_map.origin_xy[1],
        grid_map.res if cell_div else grid_map.inv_res, cell_div,
        valid.sum().to(torch.int32), config.score_aggregation)


def wrap_score_with_validity(score, grid_map, config, ranges):
    """Wrap a scorer so poses on non-free cells take INVALID_SCORE (times
    the valid-beam count under "sum"): the motion_validity="score" penalty
    for the scorers that do not fold it into their field build."""
    rr = ranges[:: config.step] if config.step > 1 else ranges
    n_valid = (torch.isfinite(rr) & (rr < config.max_range)).sum()
    pen = (INVALID_SCORE * n_valid.clamp(min=1).to(torch.float32)
           if config.score_aggregation == "sum" else INVALID_SCORE)

    def wrapped(p):
        return torch.where(grid_map.valid_mask(p), score(p), pen)

    return wrapped


def hit_norm(sigma: float) -> float:
    """``1 / (sqrt(2 pi) * sigma)`` in f32 arithmetic, as the JAX beam
    scorers compute their weak-typed ``inv_sqrt``."""
    s = np.sqrt(np.float32(2.0 * np.pi)) * np.float32(sigma)
    return float(np.float32(1.0) / s)


def raycast(pose_xy: torch.Tensor, angles: torch.Tensor, grid_map,
            max_range: float, step: float = RAY_STEP,
            hit_unknown: bool = False) -> torch.Tensor:
    """Fixed-step ray march, (..., M) predicted ranges (parallel_utils.py:
    4-29): leaving the map returns max_range; the first occupied cell (and,
    with ``hit_unknown``, unknown cell) returns ``i * step``.  ``pose_xy``
    (..., 2) and ``angles`` (..., M) broadcast: one pose's (2,) and (M,),
    or a batch of poses' (N, 2) and (N, M)."""
    n_steps = int(max_range / step)
    dev = angles.device
    dists = torch.arange(1, n_steps + 1, dtype=torch.float32, device=dev) * step
    dx = torch.cos(angles)[..., None] * dists
    dy = torch.sin(angles)[..., None] * dists
    mx, my = grid_map.world_to_grid(pose_xy[..., 0, None, None] + dx,
                                    pose_xy[..., 1, None, None] + dy)
    out = ~grid_map.in_bounds(mx, my)
    occ = grid_map.occupancy_at(mx, my, fill=0)
    hit = (occ > 50) | (hit_unknown & (occ != 0))
    event = out | hit
    any_event = event.any(dim=-1)
    first = event.to(torch.uint8).argmax(dim=-1)
    first_is_hit = hit.gather(-1, first[..., None])[..., 0]
    d_event = torch.where(first_is_hit, dists[first], max_range)
    return torch.where(any_event, d_event, max_range).to(torch.float32)


def raycast_beam_scores(particles: torch.Tensor, ranges: torch.Tensor,
                        angles: torch.Tensor, grid_map,
                        sigma_hit: float = 0.05, z_hit: float = 0.8,
                        z_rand: float = 0.1, max_range: float = 10.0,
                        chunk: int = 64,
                        aggregation: str = "mean") -> torch.Tensor:
    """(N,) beam-model scores by a ray march per (particle, beam)
    (compute_likelihoods_raycast, parallel_utils.py:151-201, with its
    defaults; JAX sensor.py:180-227): valid beams are finite and below
    max_range; each adds ``log(max(z_hit N(r - r_pred; sigma_hit) + z_rand
    / max_range, 1e-6))``; the blind penalty when no beam is valid.
    Particles march ``chunk`` at a time to bound the (chunk, M, S) work."""
    valid = torch.isfinite(ranges) & (ranges < max_range)
    count = valid.sum()
    inv_sqrt = hit_norm(sigma_hit)
    p_rand = 1.0 / max_range
    totals = []
    for c0 in range(0, particles.shape[0], chunk):
        p = particles[c0:c0 + chunk]
        r_pred = raycast(p[:, :2], p[:, 2:3] + angles[None, :], grid_map,
                         max_range)
        z = divide(ranges - r_pred, sigma_hit)
        prob = z_hit * (inv_sqrt * torch.exp(-0.5 * z ** 2)) + z_rand * p_rand
        logp = torch.log(torch.clamp(prob, min=LOG_FLOOR))
        totals.append(torch.where(valid, logp, 0.0).sum(dim=1))
    score = torch.cat(totals)
    if aggregation != "sum":
        score = score / count.clamp(min=1).to(torch.float32)
    return torch.where(count > 0, score, BLIND_SCORE).to(torch.float32)
