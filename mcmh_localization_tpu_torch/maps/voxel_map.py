"""3-D voxel occupancy map on a device (port of
``mcmh_localization_tpu/maps/voxel_map.py``).

A (D, H, W) voxel grid for 3-D lidar sensing: trinary occupancy (int8: -1
unknown, 0 free, 100 occupied), the 3-D Euclidean distance transform (f32
meters, scipy's on the host, once per map) and the world<->voxel
transforms.  The pose stays planar (x, y, theta): the motion model,
validity checks and injection run on a 2-D navigation slice
(``nav_slice``); only the sensor is 3-D.  The resolution, origin and EDT
cap are python floats, as in the JAX map.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mcmh_localization_tpu_torch.maps.grid_map import GridMap, build_grid_map
from mcmh_localization_tpu_torch.utils import profiling
from mcmh_localization_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    resolve_device,
)
from mcmh_localization_tpu_torch.utils.host import to_numpy


@dataclasses.dataclass(frozen=True)
class VoxelMap:
    occupancy: torch.Tensor   # (D, H, W) int8: -1 unknown, 0 free, 100 occ
    distance: torch.Tensor    # (D, H, W) f32 meters to the nearest occupied
    resolution: float
    # world coords of voxel (0, 0, 0)'s min corner: (x, y, z)
    origin: Tuple[float, float, float]
    # the EDT cap applied at build time (None: uncapped), kept so a saved
    # map loads with the same distance volume
    max_distance: float | None = None

    @property
    def depth(self) -> int:
        return self.occupancy.shape[0]

    @property
    def height(self) -> int:
        return self.occupancy.shape[1]

    @property
    def width(self) -> int:
        return self.occupancy.shape[2]

    @property
    def device(self) -> torch.device:
        return self.occupancy.device

    def replace(self, **kw) -> "VoxelMap":
        """A copy with the given fields (JAX's flax ``.replace``)."""
        return dataclasses.replace(self, **kw)

    def world_to_voxel(self, x, y, z):
        """(vx, vy, vz) int32: ``floor((p - origin) * inv)`` with ``inv =
        1 / resolution`` a python float (JAX voxel_map.py:46-51: the
        multiply form, which differs from ``/ resolution`` by an ulp at
        voxel edges)."""
        inv = 1.0 / self.resolution
        vx = torch.floor((x - self.origin[0]) * inv).to(torch.int32)
        vy = torch.floor((y - self.origin[1]) * inv).to(torch.int32)
        vz = torch.floor((z - self.origin[2]) * inv).to(torch.int32)
        return vx, vy, vz

    def in_bounds(self, vx, vy, vz) -> torch.Tensor:
        return ((vx >= 0) & (vx < self.width) & (vy >= 0) & (vy < self.height)
                & (vz >= 0) & (vz < self.depth))

    def occupancy_at(self, vx, vy, vz) -> torch.Tensor:
        """The occupancy of the voxels clamped into the volume."""
        return self.occupancy[vz.clamp(0, self.depth - 1).long(),
                              vy.clamp(0, self.height - 1).long(),
                              vx.clamp(0, self.width - 1).long()]

    def is_free_world(self, x, y, z) -> torch.Tensor:
        """Free-voxel test for world coords; False out of bounds."""
        vx, vy, vz = self.world_to_voxel(x, y, z)
        return self.in_bounds(vx, vy, vz) & (self.occupancy_at(vx, vy, vz) == 0)


def build_voxel_map(
    occupancy: np.ndarray,
    resolution: float,
    origin: Tuple[float, float, float],
    max_distance: float | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> VoxelMap:
    """A VoxelMap on ``device`` (the card unless told otherwise; raises
    without one) with its 3-D EDT, scipy's on the host over the occupied
    voxels (``> 50``), capped at ``max_distance`` when given (JAX
    voxel_map.py:68-94).  Under tracing the EDT and the copy to the device
    are the span ``setup.voxel_map``."""
    dev = resolve_device(device)
    with profiling.span("setup.voxel_map"):
        occ = np.asarray(occupancy, dtype=np.int8)
        occupied = occ > 50
        if occupied.any():
            from scipy.ndimage import distance_transform_edt

            dist = distance_transform_edt(~occupied, sampling=resolution)
        else:
            dist = np.full(occ.shape, 1e6, dtype=np.float64)
        if max_distance is not None:
            dist = np.minimum(dist, max_distance)
        return VoxelMap(
            occupancy=torch.from_numpy(occ.copy()).to(dev),
            distance=torch.from_numpy(dist.astype(np.float32)).to(dev),
            resolution=float(resolution),
            origin=(float(origin[0]), float(origin[1]), float(origin[2])),
            max_distance=(None if max_distance is None
                          else float(max_distance)),
        )


def raycast3d(
    pose_xyz: torch.Tensor,     # (3,) ray origin in world coords
    azimuth: torch.Tensor,      # (M,) world-frame azimuth per ray
    elevation: torch.Tensor,    # (M,) elevation per ray
    vmap_: VoxelMap,
    max_range: float,
    step: float = 0.1,
) -> torch.Tensor:
    """(M,) fixed-step ray march in 3-D on the map's device (the simulator's
    path; the scorer reads the distance volume): the first occupied voxel
    gives ``i * step``, leaving the volume ``max_range`` (JAX
    voxel_map.py:97-135)."""
    n_steps = int(max_range / step)
    dev = vmap_.device
    pose_xyz = torch.as_tensor(pose_xyz, dtype=torch.float32, device=dev)
    azimuth = torch.as_tensor(azimuth, dtype=torch.float32, device=dev)
    elevation = torch.as_tensor(elevation, dtype=torch.float32, device=dev)
    d = torch.arange(1, n_steps + 1, dtype=torch.float32, device=dev) * step
    ce = torch.cos(elevation)
    dx = ce * torch.cos(azimuth)
    dy = ce * torch.sin(azimuth)
    dz = torch.sin(elevation)
    px = pose_xyz[0] + d[None, :] * dx[:, None]   # (M, S)
    py = pose_xyz[1] + d[None, :] * dy[:, None]
    pz = pose_xyz[2] + d[None, :] * dz[:, None]
    vx, vy, vz = vmap_.world_to_voxel(px, py, pz)
    inb = vmap_.in_bounds(vx, vy, vz)
    occ = vmap_.occupancy_at(vx, vy, vz)
    event = ~inb | (occ > 50)
    hit = inb & (occ > 50)
    first = event.to(torch.uint8).argmax(dim=1)
    any_event = event.any(dim=1)
    first_hit = hit.gather(1, first[:, None])[:, 0]
    return torch.where(any_event & first_hit, d[first],
                       max_range).to(torch.float32)


def nav_slice(voxel_map: VoxelMap, z: float = 0.0,
              edt_impl: str = "scipy") -> GridMap:
    """The 2-D navigation GridMap of the voxel layer at height ``z``, on the
    map's device, with the voxel map's resolution and x/y origin, its EDT
    by ``edt_impl`` as in ``build_grid_map`` (JAX voxel_map.py:138-159)."""
    k = int(np.clip(
        np.floor((z - voxel_map.origin[2]) / voxel_map.resolution),
        0, voxel_map.depth - 1,
    ))
    occ2d = to_numpy(voxel_map.occupancy[k])
    return build_grid_map(occ2d, voxel_map.resolution,
                          (voxel_map.origin[0], voxel_map.origin[1]),
                          edt_impl=edt_impl, device=voxel_map.device)


def save_voxel_map(path: str, voxel_map: VoxelMap) -> None:
    """NPZ persistence with the JAX package's keys (occupancy and metadata;
    the EDT rebuilds on load), so either package loads the other's file."""
    np.savez_compressed(
        path,
        occupancy=to_numpy(voxel_map.occupancy),
        resolution=np.float64(voxel_map.resolution),
        origin=np.asarray(voxel_map.origin, dtype=np.float64),
        max_distance=np.float64(
            np.nan if voxel_map.max_distance is None
            else voxel_map.max_distance
        ),
    )


def load_voxel_map(path: str,
                   device: str | torch.device = DEFAULT_DEVICE) -> VoxelMap:
    """A VoxelMap from ``save_voxel_map``'s (or the JAX package's) file, on
    ``device`` (the card unless told otherwise)."""
    with np.load(path) as z:
        md = float(z["max_distance"]) if "max_distance" in z else np.nan
        return build_voxel_map(
            z["occupancy"], float(z["resolution"]),
            tuple(float(o) for o in z["origin"]),
            max_distance=None if np.isnan(md) else md, device=device,
        )
