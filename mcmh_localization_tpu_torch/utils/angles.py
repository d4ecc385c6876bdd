"""Angle utilities (port of ``mcmh_localization_tpu/utils/angles.py``).

``%`` on tensors is floor-mod, as ``jnp`` is, so the wrap matches."""

from __future__ import annotations

import math


def normalize_angle(theta):
    """Wrap angle(s) to [-pi, pi)."""
    return (theta + math.pi) % (2.0 * math.pi) - math.pi


def normalize_angle_about(angles, mean_angle):
    """Wrap ``angles - mean_angle`` to [-pi, pi)."""
    return normalize_angle(angles - mean_angle)

