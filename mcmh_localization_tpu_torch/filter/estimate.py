"""Pose estimation from the weighted particle set (port of
``mcmh_localization_tpu/filter/estimate.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmh_localization_tpu_torch.utils.angles import normalize_angle_about


class PoseEstimate(NamedTuple):
    mean: torch.Tensor  # (3,) [x, y, theta]
    cov: torch.Tensor   # (3, 3) over (x, y, theta)

    def replace(self, **kw) -> "PoseEstimate":
        """A copy with the given fields (JAX's flax ``.replace``)."""
        return self._replace(**kw)


def estimate_pose(particles: torch.Tensor, weights: torch.Tensor,
                  mask: torch.Tensor | None = None) -> PoseEstimate:
    """Weighted mean (circular in theta) and numpy-``aweights`` covariance
    of a possibly padded set (amcmh_localizer.py:584-597)."""
    w = torch.where(mask, weights, 0.0) if mask is not None else weights
    v1 = w.sum()
    wn = w / torch.clamp(v1, min=1e-30)
    mean_xy = (particles[:, :2] * wn[:, None]).sum(dim=0)
    cos_m = (torch.cos(particles[:, 2]) * wn).sum()
    sin_m = (torch.sin(particles[:, 2]) * wn).sum()
    mean_theta = torch.atan2(sin_m, cos_m)
    mean = torch.cat([mean_xy, mean_theta[None]])
    res3 = torch.stack([
        particles[:, 0] - mean_xy[0],
        particles[:, 1] - mean_xy[1],
        normalize_angle_about(particles[:, 2], mean_theta),
    ], dim=0)
    if mask is not None:
        res3 = torch.where(mask[None, :], res3, 0.0)
    v2 = (wn * wn).sum()
    denom = torch.clamp(1.0 - v2, min=1e-12)
    cov = (res3 * wn[None, :]) @ res3.T / denom
    return PoseEstimate(mean=mean, cov=cov)


def row_at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d integer tensor ``i`` on ``x``'s device, without
    reading ``i`` on the host (indexing with a 0-d tensor does)."""
    return x.index_select(0, i.reshape(1))[0]


def _near(particles, pose, radius_xy, radius_theta):
    dx = particles[:, 0] - pose[0]
    dy = particles[:, 1] - pose[1]
    dth = torch.abs(normalize_angle_about(particles[:, 2], pose[2]))
    return (dx * dx + dy * dy <= radius_xy * radius_xy) & (dth <= radius_theta)


def estimate_pose_cluster(
    particles: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor | None = None,
    radius_xy: float = 0.5,
    radius_theta: float = 1.0,
    anchor: torch.Tensor | None = None,
) -> PoseEstimate:
    """Weighted mean over the top-weight particle's (or ``anchor``'s)
    (radius_xy, radius_theta) neighborhood."""
    w = torch.where(mask, weights, 0.0) if mask is not None else weights
    if anchor is None:
        anchor = row_at(particles, torch.argmax(w))
    near = _near(particles, anchor, radius_xy, radius_theta)
    cmask = near if mask is None else (near & mask)
    return estimate_pose(particles, weights, cmask)


def cluster_mass(particles: torch.Tensor, weights: torch.Tensor,
                 pose: torch.Tensor, radius_xy: float, radius_theta: float,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Total weight within (radius_xy, radius_theta) of ``pose``."""
    w = torch.where(mask, weights, 0.0) if mask is not None else weights
    near = _near(particles, pose, radius_xy, radius_theta)
    return torch.where(near, w, 0.0).sum()


COV6_SLOTS = (0, 1, 5, 6, 7, 11, 30, 31, 35)


def covariance_6x6(cov3: torch.Tensor) -> torch.Tensor:
    """Pack a 3x3 (x, y, theta) covariance into the ROS flat 6x6 layout
    (x, y, z, rot_x, rot_y, rot_z) used at amcmh_localizer.py:606-620."""
    flat = torch.zeros(36, dtype=cov3.dtype, device=cov3.device)
    idx = torch.tensor(COV6_SLOTS, device=cov3.device)
    return flat.index_copy(0, idx, cov3.reshape(9))
