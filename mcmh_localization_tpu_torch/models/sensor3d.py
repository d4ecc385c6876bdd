"""3-D lidar likelihood-field sensor model (port of
``mcmh_localization_tpu/models/sensor3d.py``).

A planar pose (x, y, theta) and a 3-D scan: beam j has a range r_j, a
body-frame azimuth a_j and an elevation e_j.  Its endpoint in world
coordinates is

    (x, y, z0) + r_j * [cos e_j cos(theta + a_j), cos e_j sin(theta + a_j),
                        sin e_j]

scored with the 2-D likelihood field's mixture against the VoxelMap's 3-D
distance volume: valid beams are finite and below max_range; a valid beam
whose endpoint leaves the volume counts in the "mean" denominator and adds
0; a scan with no valid beam scores the blind penalty.

The per-voxel log mixture is built once per (map, config)
(``lidar3d_log_volume``, the same ops the JAX scorer applies to each read
distance) with its level form (``ops/scan_scores.py::voxel_levels``: a
16-bit index of every voxel into the volume's distinct values), and the
scan scores in one fused read per (particle, beam)
(``ops/scan_scores.py::voxel_scores``, a CUDA kernel on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmh_localization_tpu_torch.maps.voxel_map import VoxelMap, raycast3d
from mcmh_localization_tpu_torch.models.sensor import LOG_FLOOR, hit_norm
from mcmh_localization_tpu_torch.ops.scan_scores import (
    VoxelGeometry,
    VoxelLevels,
    voxel_levels,
    voxel_scores,
)
from mcmh_localization_tpu_torch.utils import profiling
from mcmh_localization_tpu_torch.utils.f32 import divide


class Lidar3dTable(NamedTuple):
    """The 3-D lidar's per-(map, config) sensor table: the voxel map, its
    log-mixture volume and the volume's level form, which the scorer
    reads."""

    voxel_map: VoxelMap
    log_volume: torch.Tensor   # (D, H, W) float32
    levels: VoxelLevels


def lidar3d_table(voxel_map: VoxelMap, config) -> Lidar3dTable:
    """The sensor table of ``voxel_map`` under ``config``, on the map's
    device: under tracing the span ``setup.voxel_tables`` (its host time:
    the launches, and the level form's wait for the distinct values)."""
    with profiling.span("setup.voxel_tables"):
        log_volume = lidar3d_log_volume(voxel_map, config)
        return Lidar3dTable(voxel_map, log_volume, voxel_levels(log_volume))


def lidar3d_log_volume(voxel_map: VoxelMap, config) -> torch.Tensor:
    """(D, H, W) f32 ``log(max(z_hit * N(d; sigma_hit) + z_rand /
    max_range, LOG_FLOOR))`` of every voxel's distance d, in the JAX
    scorer's op order (sensor3d.py:85-89)."""
    sigma = config.sigma_hit
    p_hit = hit_norm(sigma) * torch.exp(-0.5 * divide(voxel_map.distance,
                                                      sigma) ** 2)
    prob = config.z_hit * p_hit + config.z_rand / config.max_range
    return torch.log(torch.clamp(prob, min=LOG_FLOOR))


def scan_beams(ranges: torch.Tensor, directions: torch.Tensor,
               voxel_map: VoxelMap, config, sensor_z: float = 0.0):
    """(u, v, zrow, live, count): each beam's sensor-frame endpoint (u, v),
    its voxel plane times H (``zrow``, int32) and ``live`` (valid, the plane
    inside the volume), in the JAX order (sensor3d.py:44-66), and the
    valid-beam count; ``config.step`` subsamples the beams.  The endpoint's
    height does not depend on a planar pose, so a beam that is not live
    adds 0 to every pose (and counts in the "mean" denominator if valid)."""
    azimuth = directions[:, 0]
    elevation = directions[:, 1]
    if config.step > 1:
        ranges = ranges[:: config.step]
        azimuth = azimuth[:: config.step]
        elevation = elevation[:: config.step]
    valid = torch.isfinite(ranges) & (ranges < config.max_range)
    safe_r = torch.where(valid, ranges, 0.0)
    ce = torch.cos(elevation)
    u = safe_r * ce * torch.cos(azimuth)
    v = safe_r * ce * torch.sin(azimuth)
    w = safe_r * torch.sin(elevation)
    # the endpoint's plane: world_to_voxel's z in its op form
    vz = torch.floor((sensor_z + w - voxel_map.origin[2])
                     * (1.0 / voxel_map.resolution)).to(torch.int32)
    live = valid & (vz >= 0) & (vz < voxel_map.depth)
    zrow = (vz.clamp(0, voxel_map.depth - 1) * voxel_map.height).to(torch.int32)
    return (u.contiguous(), v.contiguous(), zrow.contiguous(),
            live.contiguous(), valid.sum())


def voxel_geometry(voxel_map: VoxelMap) -> VoxelGeometry:
    return VoxelGeometry(
        origin_x=voxel_map.origin[0], origin_y=voxel_map.origin[1],
        inv=1.0 / voxel_map.resolution, d=voxel_map.depth,
        h=voxel_map.height, w=voxel_map.width)


def lidar3d_scores(
    particles: torch.Tensor,    # (N, 3) planar poses
    ranges: torch.Tensor,       # (M,)
    directions: torch.Tensor,   # (M, 2): [azimuth, elevation] body-frame
    voxel_map: VoxelMap,
    config,
    sensor_z: float = 0.0,      # sensor height above the pose plane
    log_volume: torch.Tensor | VoxelLevels | None = None,
) -> torch.Tensor:
    """(N,) f32 per-particle log-likelihood scores (JAX sensor3d.py:34-98).
    ``log_volume`` is ``lidar3d_log_volume(voxel_map, config)`` (built
    here when not given), read as it is, or its level form
    (``Lidar3dTable.levels``, built once per (map, config): the same
    values)."""
    if log_volume is None:
        log_volume = lidar3d_log_volume(voxel_map, config)
    if isinstance(log_volume, torch.Tensor):
        log_volume = VoxelLevels(None, None, log_volume.contiguous())
    u, v, zrow, live, count = scan_beams(ranges, directions, voxel_map,
                                         config, sensor_z)
    return voxel_scores(particles.contiguous(), u, v, zrow, live, log_volume,
                        voxel_geometry(voxel_map), count,
                        config.score_aggregation)


def simulate_scan3d(
    key: torch.Generator | None,
    pose,                       # (3,) planar pose
    directions: torch.Tensor,   # (M, 2) body-frame [azimuth, elevation]
    voxel_map: VoxelMap,
    max_range: float,
    sensor_z: float = 0.0,
    noise: float = 0.0,
    normals: torch.Tensor | None = None,
) -> torch.Tensor:
    """(M,) ground-truth 3-D scan from a pose (the simulator's path, JAX
    sensor3d.py:101-120), on the map's device.  The range noise is
    ``noise`` times standard normals: ``normals`` (M,) when given, else
    drawn from the generator ``key`` (JAX's key streams cannot be
    reproduced here)."""
    dev = voxel_map.device
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    directions = torch.as_tensor(directions, dtype=torch.float32, device=dev)
    origin = torch.stack([pose[0], pose[1],
                          torch.full((), sensor_z, dtype=torch.float32,
                                     device=dev)])
    r = raycast3d(origin, pose[2] + directions[:, 0], directions[:, 1],
                  voxel_map, max_range)
    if noise > 0:
        if normals is None:
            normals = torch.randn(r.shape, generator=key, device=dev)
        r = r + noise * torch.as_tensor(normals, dtype=torch.float32,
                                        device=dev)
    return torch.clamp(r, 0.05, max_range)
