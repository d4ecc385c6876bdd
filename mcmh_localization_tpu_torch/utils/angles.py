"""Angle utilities (port of ``mcmh_localization_tpu/utils/angles.py``).

``%`` on tensors is floor-mod, as ``jnp`` is, so the wrap matches."""

from __future__ import annotations

import math

import torch


def normalize_angle(theta):
    """Wrap angle(s) to [-pi, pi)."""
    return (theta + math.pi) % (2.0 * math.pi) - math.pi


def normalize_angle_about(angles, mean_angle):
    """Wrap ``angles - mean_angle`` to [-pi, pi)."""
    return normalize_angle(angles - mean_angle)


def _f32(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.float32)


def yaw_from_quaternion(x, y, z, w) -> torch.Tensor:
    """Yaw (Z euler) of a quaternion, elementwise over numbers or tensors
    (float32 for numbers, as JAX's weak types give)."""
    return torch.atan2(_f32(2.0 * (w * z + x * y)),
                       _f32(1.0 - 2.0 * (y * y + z * z)))


def quaternion_from_yaw(yaw) -> tuple:
    """(x, y, z, w) planar quaternion of ``yaw``."""
    half = 0.5 * _f32(yaw)
    zero = torch.zeros_like(half)
    return zero, zero, torch.sin(half), torch.cos(half)
