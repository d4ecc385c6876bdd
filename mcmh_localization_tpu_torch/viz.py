"""The map->odom re-anchoring of the online facade (port of the numpy-only
part of ``mcmh_localization_tpu/viz.py``: ``_pose_to_matrix``,
``map_to_odom_transform`` and ``TFReanchorer``, copied as they are).  The
plotting and frame recording of that module are not ported yet."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _pose_to_matrix(x, y, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0, x], [s, c, 0, y], [0, 0, 1, 0], [0, 0, 0, 1]])


def map_to_odom_transform(
    estimated_pose: Tuple[float, float, float],
    odom_to_base: Tuple[float, float, float],
):
    """T_map_odom = T_map_base . inv(T_odom_base), quaternion w forced >= 0.

    The planar equivalent of compute_map_to_odom_tf
    (pose_broadcaster.py:43-86): re-anchors the odometry frame so that
    composing map->odom->base reproduces the estimated pose.
    Returns (translation (3,), quaternion xyzw (4,)).
    """
    t_map_base = _pose_to_matrix(*estimated_pose)
    t_odom_base = _pose_to_matrix(*odom_to_base)
    t_map_odom = t_map_base @ np.linalg.inv(t_odom_base)
    yaw = np.arctan2(t_map_odom[1, 0], t_map_odom[0, 0])
    quat = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
    quat /= np.linalg.norm(quat)
    if quat[3] < 0:
        quat = -quat
    trans = np.array([t_map_odom[0, 3], t_map_odom[1, 3], 0.0])
    return trans, quat


class TFReanchorer:
    """Live map->odom re-anchoring loop — the PoseBroadcaster node as a
    stream helper (pose_broadcaster.py:22,31-41,88-105).

    The reference node, per estimate message: look up the LATEST
    odom->base transform from the TF buffer (``Time(0)`` semantics,
    :37-41), compose ``T_map_odom = T_map_base . inv(T_odom_base)``
    (:43-86), and broadcast map->odom (:88-105).  Here ``on_odom`` plays
    the TF buffer (latest odom->base) and ``on_estimate`` plays
    pose_callback, returning the TransformStamped-equivalent dict (and
    recording it on ``.transforms``).

    Deviations (documented): when no odom->base is available yet the
    reference's lookup returns None and pose_callback would crash on it
    (pose_broadcaster.py:33-34 passes None into the math) — here the
    estimate is skipped and None returned.  ``stale_after`` optionally
    rejects odom older than the estimate by more than that many seconds
    (the ExtrapolationException analogue); default None = the reference's
    Time(0) latest-available behavior.
    """

    def __init__(self, stale_after: float | None = None):
        self.stale_after = stale_after
        self._odom = None          # (x, y, yaw)
        self._odom_stamp = None
        self.transforms: list = []  # broadcast history

    def on_odom(self, x: float, y: float, yaw: float, stamp: float | None = None):
        """Latest odom->base_footprint pose (the TF-listener feed)."""
        self._odom = (float(x), float(y), float(yaw))
        self._odom_stamp = stamp

    def on_estimate(self, pose3, stamp: float | None = None):
        """One estimate message -> one map->odom broadcast (or None when
        the odom lookup fails / is stale)."""
        if self._odom is None:
            return None
        if (
            self.stale_after is not None
            and stamp is not None
            and self._odom_stamp is not None
            and stamp - self._odom_stamp > self.stale_after
        ):
            return None
        trans, quat = map_to_odom_transform(tuple(pose3), self._odom)
        t = {
            "frame_id": "map",
            "child_frame_id": "odom",
            "stamp": stamp,
            "translation": tuple(float(v) for v in trans),
            "rotation": tuple(float(v) for v in quat),
        }
        self.transforms.append(t)
        return t

    def latest(self):
        return self.transforms[-1] if self.transforms else None
