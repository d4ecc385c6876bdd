"""OnlineLocalizer: callback-style facade mirroring the reference node (port
of ``mcmh_localization_tpu/filter/online.py``).

The reference's ``AMCMHLocalizer`` is a ROS node driven by /odom (~30 Hz)
and /scan (~5 Hz) callbacks (amcmh_localizer.py:104-105,294,379).  Feed
odometry poses and scans as they arrive: each odometry message runs the
predict step (or only records the pose, under
``predict_batching="per_scan"``), each scan runs the correct step and
returns the estimate.  The filter runs where the map lives: the card for a
map built by the port's entry points with their default device, the CPU
for a map built with ``device="cpu"``.

On the card, ``on_scan`` replays its program's correct step captured in a
CUDA graph (``filter/captured.py``; every config is ``graph_capturable``);
the odometry's predict steps run eagerly.  On the CPU the correct step
runs eagerly.

With tracing on (``utils/profiling.py``), both calls record spans where
their work happens, each carrying the number of the scan (``on_odom``'s,
the scan it precedes): ``online.on_odom`` with ``online.odom.motion``
(``compute_motion``) and ``online.odom.predict`` (the predict: the delta's
copy to the device, the proposal, the anchor's advance); ``online.on_scan``
with ``online.scan.inputs`` (the scan's copy, the angles),
``online.scan.replay`` (the correct step), ``online.scan.policy`` (the
staged policy's read and the hand-off) and ``online.scan.estimate`` (the
estimate's read and packing).  Each read of a device value counts one
``host_sync``.

The state's random source is a ``torch.Generator``, which the step advances
in place, where the JAX key is a value.  So wherever the JAX facade reuses
a key value (``warmup``'s throwaway steps on both programs), this one works
on a copy of the generator, and the localizer's stream stays untouched.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mcmh_localization_tpu_torch.filter.estimate import COV6_SLOTS
from mcmh_localization_tpu_torch.filter.state import FilterState, copy_generator
from mcmh_localization_tpu_torch.filter.step import (
    as_f32,
    make_model,
    state_size,
)
from mcmh_localization_tpu_torch.models.motion import compute_motion
from mcmh_localization_tpu_torch.utils import profiling
from mcmh_localization_tpu_torch.utils.angles import yaw_from_quaternion
from mcmh_localization_tpu_torch.viz import TFReanchorer


class OnlineLocalizer:
    """Stateful wrapper: on_odom()/on_scan() like the reference's callbacks."""

    def __init__(
        self,
        config,
        grid_map,
        seed: int = 0,
        initial_pose=None,
        voxel_map=None,
        staged: bool = False,
        tracking_capacity: int | None = None,
        tracking_ess_threshold: float | None = None,
        tracking_theta_bins: int | None = None,
        tracking_window_cells: int | None = None,
        frame_recorder=None,
    ):
        """The JAX facade's parameters.  ``voxel_map``: the VoxelMap of
        sensor_model="lidar3d" (``grid_map`` then its navigation slice;
        ``on_scan`` takes the (M, 2) azimuth and elevation as ``angles``).

        ``staged=True`` runs the two-program execution (filter/staged.py)
        online: global/recovery phases use the full-capacity full-field
        program, converged tracking the small windowed one, switching per
        scan on the same count/injection/mode-dominance policy as
        run_staged.  Requires an adaptive mode.

        ``frame_recorder``: a ``viz.FrameRecorder`` — every on_scan
        renders the live cloud + estimate into it (the reference node's
        per-scan MarkerArray stream into RViz, amcmh_localizer.py:538-581,
        as a direct hook; settable later via ``.frame_recorder``)."""
        self.config = config
        self.grid_map = grid_map
        self.staged = None
        if staged:
            from mcmh_localization_tpu_torch.filter.staged import make_staged_model

            self.staged = make_staged_model(
                config, grid_map, tracking_capacity=tracking_capacity,
                voxel_map=voxel_map,
                tracking_ess_threshold=tracking_ess_threshold,
                tracking_theta_bins=tracking_theta_bins,
                tracking_window_cells=tracking_window_cells,
            )
            self._cap = state_size(self.staged.small_config)
            self._n_big = state_size(self.staged.config)
            self._in_small = False
            self.model = self.staged.big
        else:
            self.model = make_model(config, grid_map, voxel_map=voxel_map)
        self.state = self.model.init(seed, initial_pose=initial_pose)
        self._last_odom: Optional[np.ndarray] = None
        # per_scan batching: odom pose at the time of the last predict —
        # on_scan dispatches ONE predict covering everything since
        self._predicted_from: Optional[np.ndarray] = None
        self.last_info = None
        self._est_for = self._est_cache = None
        # the scans on_scan was handed: the next scan's number
        self.scan_count = 0
        # live map->odom re-anchoring (pose_broadcaster node equivalent);
        # fed by on_odom, emits on every on_scan via .reanchor.latest()
        self.reanchor = TFReanchorer()
        # per-scan live view (viz.FrameRecorder); None = no rendering
        self.frame_recorder = frame_recorder

    @property
    def device(self) -> torch.device:
        return self.grid_map.device

    # -- inputs --------------------------------------------------------------

    def set_initial_pose(self, x: float, y: float, yaw: float, seed: int = 1):
        """Re-initialize around a pose (the /initial_pose callback,
        amcmh_localizer.py:199-208)."""
        if self.staged is not None:
            # re-initialization is a global event: back to the big program
            self.model = self.staged.big
            self._in_small = False
        self.state = self.model.init(seed, initial_pose=[x, y, yaw])
        self._last_odom = None
        self._predicted_from = None

    def _scan_inputs(self, ranges, angles, angle_min, angle_max):
        ranges = as_f32(ranges, self.device)
        if angles is None:
            angles = torch.linspace(angle_min, angle_max, ranges.shape[0],
                                    dtype=torch.float32, device=self.device)
        else:
            angles = as_f32(angles, self.device)
        return ranges, angles

    def warmup(self, ranges, angles=None, angle_min=-np.pi, angle_max=np.pi):
        """Run one throwaway predict+correct per program this localizer can
        dispatch (and, staged, the shrink/grow hand-off), outside any timed
        or real-time region: on the card this builds the CUDA kernels at
        their first use (``ops/_cuda.py``), captures each capturable
        program's correct step (the port's counterpart of JAX's compile)
        and fills PyTorch's allocator and library caches.  The steps run on
        copies of the state's generator, so the localizer's state, its
        random stream, the odometry bookkeeping and the estimate cache are
        untouched.  The online twin of the JAX
        ``filter.staged.warmup_staged``."""
        ranges, angles = self._scan_inputs(ranges, angles, angle_min, angle_max)
        delta = torch.zeros(3, dtype=torch.float32, device=self.device)

        def copy(st: FilterState) -> FilterState:
            return st.replace(key=copy_generator(self.state.key))

        if self.staged is None:
            programs = [(self.model, copy(self.state))]
        else:
            from mcmh_localization_tpu_torch.filter.staged import (
                grow_state,
                shrink_state,
            )

            big_state = (grow_state(self.state, self._n_big) if self._in_small
                         else self.state)
            small_state = shrink_state(big_state, self._cap)
            # the grow direction too: escalation back to the big program
            grow_state(small_state, self._n_big)
            programs = [(self.staged.big, copy(big_state)),
                        (self.staged.small, copy(small_state))]
        for model, st in programs:
            st = model.predict(st, delta)
            _correct_scan(model, st, ranges, angles)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_odom(self, x: float, y: float, yaw: float, stamp: float | None = None):
        """Odometry pose update -> motion proposal (odom_callback,
        amcmh_localizer.py:379-408).  First message only seeds last_odom.

        With config.predict_batching="per_scan" this is host-side
        bookkeeping only (no device dispatch); on_scan runs one predict
        covering all odometry since the previous scan."""
        with profiling.span("online.on_odom", self.scan_count):
            curr = np.asarray([x, y, yaw], dtype=np.float32)
            if self._last_odom is None:
                self._predicted_from = curr
            elif self.config.predict_batching == "per_message":
                with profiling.span("online.odom.motion"):
                    delta = compute_motion(torch.from_numpy(self._last_odom),
                                           torch.from_numpy(curr))
                with profiling.span("online.odom.predict"):
                    self.state = self.model.predict(self.state, delta)
                self._predicted_from = curr
            self._last_odom = curr
            self.reanchor.on_odom(x, y, yaw, stamp)

    def on_odom_quaternion(self, x, y, qx, qy, qz, qw):
        """Odometry with quaternion orientation, as a ROS Odometry carries."""
        yaw = float(yaw_from_quaternion(qx, qy, qz, qw))
        self.on_odom(x, y, yaw)

    def on_scan(self, ranges, angles=None, angle_min=-np.pi, angle_max=np.pi):
        """Scan update -> full correction; returns the estimate dict
        (lidar_callback, amcmh_localizer.py:294-338).  ``angles`` defaults to
        the reference's linspace(angle_min, angle_max, M) layout
        (get_lidar_angles, :346-348)."""
        scan = self.scan_count
        self.scan_count = scan + 1
        with profiling.span("online.on_scan", scan):
            return self._on_scan(ranges, angles, angle_min, angle_max)

    def _on_scan(self, ranges, angles, angle_min, angle_max):
        with profiling.span("online.scan.inputs"):
            ranges, angles = self._scan_inputs(ranges, angles, angle_min,
                                               angle_max)
        if (
            self.config.predict_batching == "per_scan"
            and self._last_odom is not None
            and self._predicted_from is not None
            and not np.array_equal(self._predicted_from, self._last_odom)
        ):
            delta = compute_motion(torch.from_numpy(self._predicted_from),
                                   torch.from_numpy(self._last_odom))
            self.state = self.model.predict(self.state, delta)
            self._predicted_from = self._last_odom
        with profiling.span("online.scan.replay"):
            self.state, info = _correct_scan(self.model, self.state, ranges,
                                             angles)
        self.last_info = info
        if self.staged is not None:
            with profiling.span("online.scan.policy"):
                self._hand_off(info)
        with profiling.span("online.scan.estimate"):
            est = self.estimate()
        if est:
            # the pose_broadcaster loop: one map->odom re-anchor per
            # estimate (pose_broadcaster.py:31-35)
            self.reanchor.on_estimate(est["pose3"])
        if self.frame_recorder is not None:
            profiling.count("host_sync")
            self.frame_recorder.update(
                self.state.particles, self.state.weights,
                estimate=(est["pose3"] if est else None),
                count=int(self.state.count),
            )
        return est

    def _hand_off(self, info) -> None:
        """The staged policy on the scan's count, injection share and mode
        mass: shrink to the tracking program, grow back to the big one, or
        stay."""
        from mcmh_localization_tpu_torch.filter.staged import (
            grow_state,
            next_stage,
            shrink_state,
        )

        # ONE device-to-host copy for the three policy scalars
        profiling.count("host_sync")
        cnt, p_rand, mass = torch.stack([
            info.count.to(torch.float64), info.p_random.to(torch.float64),
            info.anchor_mass.to(torch.float64)]).cpu().numpy()
        nxt = next_stage(self._in_small, cnt, p_rand, mass, self._cap)
        if nxt and not self._in_small:
            self.state = shrink_state(self.state, self._cap)
            self.model = self.staged.small
        elif self._in_small and not nxt:
            self.state = grow_state(self.state, self._n_big)
            self.model = self.staged.big
        self._in_small = nxt

    # -- outputs -------------------------------------------------------------

    def estimate(self) -> dict:
        """Latest pose estimate in PoseWithCovarianceStamped-like form
        (publish_estimate, amcmh_localizer.py:584-623).

        Cached per step: the mean and covariance come to the host in one
        copy, which waits for the device; a second call per scan must not
        pay it again.  The 6x6 ROS packing (``covariance_6x6``'s layout)
        is done on the host, on the fetched values."""
        if self.last_info is None:
            return {}
        if self._est_for is self.last_info:
            return self._est_cache
        e = self.last_info.estimate
        profiling.count("host_sync")
        host = torch.cat([e.mean.reshape(3), e.cov.reshape(9)]).cpu().numpy()
        mean, cov = host[:3], host[3:]
        yaw = float(mean[2])
        flat = np.zeros(36, dtype=np.float32)
        flat[list(COV6_SLOTS)] = cov.astype(np.float32)
        est = {
            "position": (float(mean[0]), float(mean[1]), 0.0),
            "orientation": (0.0, 0.0, float(np.sin(yaw / 2)),
                            float(np.cos(yaw / 2))),
            "covariance": flat,
            "pose3": (float(mean[0]), float(mean[1]), yaw),
        }
        self._est_for, self._est_cache = self.last_info, est
        return est

    def particles(self) -> tuple[np.ndarray, np.ndarray]:
        """(active particles, weights) for visualization."""
        n = int(self.state.count)
        return (self.state.particles[:n].cpu().numpy(),
                self.state.weights[:n].cpu().numpy())

    # -- checkpoint/resume -----------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Persist the filter state (utils/checkpoint.py npz, bit-exact
        with the generator's state).  Under staged execution the array
        capacity identifies the active program, so no extra metadata is
        needed."""
        from mcmh_localization_tpu_torch.utils.checkpoint import save_state

        save_state(path, self.state)

    def load_checkpoint(self, path: str) -> None:
        """Resume from ``save_checkpoint`` (or from the JAX facade's
        checkpoint: utils/checkpoint.py seeds the generator from its key),
        on the map's device.  Under staged execution the checkpoint's
        capacity selects the program (BIG or SMALL); a capacity matching
        neither configuration is an error.  Odometry bookkeeping resets —
        the next on_odom re-seeds it, as at construction."""
        from mcmh_localization_tpu_torch.utils.checkpoint import load_state

        st = load_state(path, device=self.device)
        cap = st.particles.shape[0]
        if self.staged is not None:
            if cap == self._cap:
                self._in_small = True
                self.model = self.staged.small
            elif cap == self._n_big:
                self._in_small = False
                self.model = self.staged.big
            else:
                raise ValueError(
                    f"checkpoint capacity {cap} matches neither the big "
                    f"({self._n_big}) nor the tracking ({self._cap}) program"
                )
        elif cap != self.state.particles.shape[0]:
            raise ValueError(
                f"checkpoint capacity {cap} != model capacity "
                f"{self.state.particles.shape[0]}"
            )
        self.state = st
        self._last_odom = None
        self._predicted_from = None
        self.last_info = None
        self._est_for = self._est_cache = None


def _correct_scan(model, state: FilterState, ranges, angles):
    """``model.correct``: a replay of its captured correct step where the
    model ``replays_graph``, an eager step otherwise."""
    if model.replays_graph:
        return model.captured(state, ranges.shape[0], predict=False).scan(
            state, ranges, angles)
    if not profiling.enabled():
        return model.correct(state, ranges, angles)
    with profiling.clocked(profiling.stage_clock(model.name, model.device)):
        return model.correct(state, ranges, angles)
