"""kernels.voxel_scores_roofline: the 3-D lidar scorer's kernel over the
profiled stretch, as the step ran it: the device time of form (b) of
``csrc/scan_scores.cu`` in the profiler's trace (``voxel_levels_kernel``,
or ``voxel_f32_kernel`` where the volume keeps its f32 form), against the
least time the card could take for the work of every scan of the stretch
(``counts/voxel_scores.py`` at the step's poses, twice the state's slots
under MH, and each scan's own live beams, against ``counts/peaks.py``),
in %.  The stretch's scans are the localizer's last ``trace.scans``, so the
reading spans whole kidnap cycles, converged and spread clouds alike.
The count's per-beam work (a scan's endpoint planes) runs in plain
PyTorch before the kernel and is not in the time read; it is under a
1e-5 part of the bound.  Nothing to read without the 3-D lidar's kernel
in a trace."""

import sys

import numpy as np

from benchmark.counts import peaks, voxel_scores

KERNELS = ("voxel_levels_kernel", "voxel_f32_kernel")


def live_beams(ranges: np.ndarray, elevation: np.ndarray, max_range: float,
               sensor_z: float, origin_z: float, res: float,
               depth: int) -> int:
    """The valid beams whose endpoint's plane lies inside the volume."""
    valid = np.isfinite(ranges) & (ranges < max_range)
    z = sensor_z + np.where(valid, ranges, 0.0) * np.sin(elevation)
    vz = np.floor((z - origin_z) / res)
    return int((valid & (vz >= 0) & (vz < depth)).sum())


def read(run):
    cfg, t = run.loc.config, run.trace
    if t is None or cfg.sensor_model != "lidar3d":
        return None
    kernel_s = sum(s for name, s in t.device_ops
                   if any(k in name for k in KERNELS))
    if kernel_s <= 0:
        return None
    vm = run.loc.model.voxel_map
    n = (2 if cfg.use_mh else 1) * run.loc.state.particles.shape[0]
    elevation = np.asarray(run.traffic.angles, np.float64)[::cfg.step, 1]
    last = run.loc.scan_count          # traffic scan t is the t-th on_scan
    lives = [live_beams(run.traffic.ranges[i, ::cfg.step].astype(np.float64),
                        elevation, cfg.max_range, cfg.lidar3d_sensor_z,
                        vm.origin[2], vm.resolution, vm.depth)
             for i in range(last - t.scans + 1, last + 1)]
    bound = sum(peaks.bound_ms(
        voxel_scores.ops(n, live, elevation.shape[0]),
        voxel_scores.nbytes(n, live, elevation.shape[0],
                            vm.depth * vm.height * vm.width))[0]
        for live in lives)
    share = 100.0 * bound / (kernel_s * 1e3)
    print(f"voxel scores: {kernel_s * 1e3 / t.scans:.4f} ms a scan of {n} "
          f"poses and {np.mean(lives):.0f} live beams over {t.scans} traced "
          f"scans against a bound of {bound / t.scans:.5f} ms ({share:.2f}%)",
          file=sys.stderr)
    return share
