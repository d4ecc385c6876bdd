"""Odometry motion model (port of ``mcmh_localization_tpu/models/motion.py``).

``sample_motion`` takes the raw draw (``retries=0``, for
``motion_validity="score"``, which folds map validity into the sensor
score) or the first of ``retries`` draws that lands on a free cell
(``motion_validity="reject"``).  The proposal noise comes in as ``noise``
(so a test can hand it the JAX draws) or from ``generator``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from mcmh_localization_tpu_torch.utils.angles import normalize_angle

_SIGMA_MIN = 1e-9


def compute_motion(odom_prev: torch.Tensor, odom_curr: torch.Tensor) -> torch.Tensor:
    """(rot1, trans, rot2) between two odometry poses
    (amcmh_localizer.py:410-421; rot1 is not wrapped, like the reference)."""
    dx = odom_curr[0] - odom_prev[0]
    dy = odom_curr[1] - odom_prev[1]
    dtheta = normalize_angle(odom_curr[2] - odom_prev[2])
    rot1 = torch.atan2(dy, dx) - odom_prev[2]
    trans = torch.hypot(dx, dy)
    rot2 = dtheta - rot1
    return torch.stack([rot1, trans, rot2])


def advance_anchor(anchor: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Noise-free rot1/trans/rot2 odometry applied to the anchor pose."""
    th1 = anchor[2] + delta[0]
    x = anchor[0] + delta[1] * torch.cos(th1)
    y = anchor[1] + delta[1] * torch.sin(th1)
    return torch.stack([x, y, normalize_angle(th1 + delta[2])]).to(torch.float32)


def invert_delta(delta: torch.Tensor, ref_compat: bool = False) -> torch.Tensor:
    """The reverse motion of ``delta``: ``(pi - rot2, trans, -rot1 - pi)``
    wrapped, or the reference's rigid-body quirk with ``ref_compat``."""
    r1, t, r2 = delta[0], delta[1], delta[2]
    if ref_compat:
        return torch.stack([
            -r1 * torch.cos(r2) - t * torch.sin(r2),
            r1 * torch.sin(r2) - t * torch.cos(r2),
            -r2,
        ])
    return torch.stack([normalize_angle(math.pi - r2), t,
                        normalize_angle(-r1 - math.pi)])


def _noise_stds(delta, alpha):
    rot1, trans, rot2 = delta[0], delta[1], delta[2]
    a1, a2, a3, a4 = alpha
    s_rot1 = a1 * torch.abs(rot1) + a2 * torch.abs(trans)
    s_trans = a3 * torch.abs(trans) + a4 * (torch.abs(rot1) + torch.abs(rot2))
    s_rot2 = a1 * torch.abs(rot2) + a2 * torch.abs(trans)
    return s_rot1, s_trans, s_rot2


def sample_motion(
    particles: torch.Tensor,
    delta: torch.Tensor,
    alpha: Tuple[float, float, float, float],
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    grid_map=None,
    retries: int = 0,
) -> torch.Tensor:
    """(N, 3) proposals through the noisy odometry model.

    ``retries=0``: the raw draw, no validity check; ``noise`` (N, 3)
    standard normals.  ``retries > 0``: ``noise`` (retries, N, 3); each
    particle takes its first candidate on a free cell of ``grid_map`` and
    keeps its old pose when none is (JAX motion.py:154-178).  ``noise`` is
    drawn from ``generator`` when None."""
    n = particles.shape[0]
    shape = (n, 3) if retries == 0 else (retries, n, 3)
    if noise is None:
        noise = torch.randn(shape, generator=generator,
                            device=particles.device, dtype=particles.dtype)
    s_rot1, s_trans, s_rot2 = _noise_stds(delta, alpha)
    r1_hat = delta[0] + noise[..., 0] * s_rot1
    t_hat = delta[1] + noise[..., 1] * s_trans
    r2_hat = delta[2] + noise[..., 2] * s_rot2
    x, y, theta = particles[:, 0], particles[:, 1], particles[:, 2]
    heading = theta + r1_hat
    if retries == 0:
        return torch.stack([
            x + t_hat * torch.cos(heading),
            y + t_hat * torch.sin(heading),
            normalize_angle(heading + r2_hat),
        ], dim=-1)
    cand = torch.stack([
        x + t_hat * torch.cos(heading),
        y + t_hat * torch.sin(heading),
        normalize_angle(theta + r1_hat + r2_hat),
    ], dim=-1)                                               # (R, N, 3)
    valid = grid_map.is_free_world(cand[..., 0], cand[..., 1])   # (R, N)
    any_valid = valid.any(dim=0)
    first = valid.to(torch.uint8).argmax(dim=0)              # first free draw
    picked = cand.gather(0, first[None, :, None].expand(1, n, 3))[0]
    return torch.where(any_valid[:, None], picked, particles)


def _gaussian_prob(diff, sigma):
    s = torch.clamp(sigma, min=_SIGMA_MIN)
    return torch.exp(-0.5 * (diff / s) ** 2) / torch.sqrt(2.0 * math.pi * s * s)


def motion_density(
    particles_prev: torch.Tensor,
    particles_curr: torch.Tensor,
    delta: torch.Tensor,
    alpha: Tuple[float, float, float, float],
    normalize: bool = True,
) -> torch.Tensor:
    """p(x_t | x_{t-1}, u_t) per particle pair, normalized to sum 1
    (parallel_utils.py:282-330)."""
    dx = particles_curr[:, 0] - particles_prev[:, 0]
    dy = particles_curr[:, 1] - particles_prev[:, 1]
    theta_prev = particles_prev[:, 2]
    theta_curr = particles_curr[:, 2]
    trans_hat = torch.sqrt(dx * dx + dy * dy)
    rot1_hat = normalize_angle(torch.atan2(dy, dx) - theta_prev)
    rot2_hat = normalize_angle(theta_curr - theta_prev - rot1_hat)
    s_rot1, s_trans, s_rot2 = _noise_stds(delta, alpha)
    p = (
        _gaussian_prob(normalize_angle(delta[0] - rot1_hat), s_rot1)
        * _gaussian_prob(delta[1] - trans_hat, s_trans)
        * _gaussian_prob(normalize_angle(delta[2] - rot2_hat), s_rot2)
    )
    if not normalize:
        return p
    total = p.sum()
    return torch.where(total > 0, p / total, p)
