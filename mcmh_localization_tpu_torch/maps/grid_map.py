"""Occupancy-grid map on a device (port of
``mcmh_localization_tpu/maps/grid_map.py``).

The tensors keep the JAX package's layouts and dtypes: occupancy (H, W)
int8 (0 free, 100 occupied, -1 unknown; row 0 is the bottom row), distance
(H, W) f32 meters, origin (2,) f32, resolution () f32.  The f32 origin and
resolution are also kept as python floats for shapes and kernel arguments,
so no step has to read them back from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mcmh_localization_tpu_torch.io.pgm import load_map_yaml
from mcmh_localization_tpu_torch.maps.edt import distance_transform_edt
from mcmh_localization_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class GridMap:
    occupancy: torch.Tensor    # (H, W) int8
    distance: torch.Tensor     # (H, W) f32, meters to the nearest non-free cell
    origin: torch.Tensor       # (2,) f32 world coords of the (0, 0) corner
    resolution: torch.Tensor   # () f32 meters per cell
    free_xy: torch.Tensor      # (F, 2) f32 free-cell centers
    free_mask: torch.Tensor    # (H, W) f32 0/1 free cells
    res: float                 # resolution's f32 value
    origin_xy: Tuple[float, float]  # origin's f32 values

    @property
    def height(self) -> int:
        return self.occupancy.shape[0]

    @property
    def width(self) -> int:
        return self.occupancy.shape[1]

    @property
    def device(self) -> torch.device:
        return self.occupancy.device

    @property
    def inv_res(self) -> float:
        """``1.0 / resolution`` in f32, as the JAX call sites compute it."""
        return float(np.float32(1.0) / np.float32(self.res))

    # ---- transforms --------------------------------------------------------

    def world_to_grid(self, x, y):
        """(mx, my) int32 cells; ``int((x - origin) / res)`` truncation."""
        mx = ((x - self.origin[0]) / self.resolution).to(torch.int32)
        my = ((y - self.origin[1]) / self.resolution).to(torch.int32)
        return mx, my

    def in_bounds(self, mx, my) -> torch.Tensor:
        return (mx >= 0) & (mx < self.width) & (my >= 0) & (my < self.height)

    # ---- queries (safe out of bounds: clamp + mask) ------------------------

    def occupancy_at(self, mx, my, fill: int = 100) -> torch.Tensor:
        ok = self.in_bounds(mx, my)
        vals = self.occupancy[my.clamp(0, self.height - 1).long(),
                              mx.clamp(0, self.width - 1).long()]
        return torch.where(ok, vals, torch.tensor(fill, dtype=torch.int8,
                                                  device=vals.device))

    def distance_at(self, mx, my, fill: float = 0.0) -> torch.Tensor:
        ok = self.in_bounds(mx, my)
        vals = self.distance[my.clamp(0, self.height - 1).long(),
                             mx.clamp(0, self.width - 1).long()]
        return torch.where(ok, vals, fill)

    def is_free_world(self, x, y) -> torch.Tensor:
        """Free-cell test for world coords; False out of bounds (read
        through the gather kernel on CUDA tensors)."""
        from mcmh_localization_tpu_torch.ops.gather import gather_2d

        mx, my = self.world_to_grid(x, y)
        ok = self.in_bounds(mx, my)
        mxc = mx.clamp(0, self.width - 1).reshape(-1).contiguous()
        myc = my.clamp(0, self.height - 1).reshape(-1).contiguous()
        vals = gather_2d(self.free_mask, myc, mxc).reshape(ok.shape)
        return ok & (vals > 0.5)

    def valid_mask(self, particles: torch.Tensor) -> torch.Tensor:
        """(N,) bool: the pose's cell is free, for (N, 3) poses."""
        return self.is_free_world(particles[..., 0], particles[..., 1])


def build_grid_map(
    occupancy: np.ndarray,
    resolution: float,
    origin: Tuple[float, float] = (0.0, 0.0),
    distance: np.ndarray | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> GridMap:
    """Build a GridMap on ``device`` (the card unless told otherwise; raises
    without one), computing the EDT on the host with scipy when
    ``distance`` is not given."""
    dev = resolve_device(device)
    occupancy = np.asarray(occupancy, dtype=np.int8)
    if distance is None:
        distance = distance_transform_edt(occupancy != 0, resolution)
    rows, cols = np.nonzero(occupancy == 0)
    if rows.size == 0:  # degenerate all-occupied map: keep one dummy cell
        rows, cols = np.array([0]), np.array([0])
    free_xy = np.stack(
        [origin[0] + (cols + 0.5) * resolution,
         origin[1] + (rows + 0.5) * resolution], axis=1,
    ).astype(np.float32)
    origin32 = np.asarray(origin[:2], dtype=np.float32)
    res32 = np.float32(resolution)
    return GridMap(
        occupancy=torch.from_numpy(occupancy.copy()).to(dev),
        distance=torch.from_numpy(np.array(distance, np.float32)).to(dev),
        origin=torch.from_numpy(origin32).to(dev),
        resolution=torch.tensor(res32, dtype=torch.float32, device=dev),
        free_xy=torch.from_numpy(free_xy).to(dev),
        free_mask=torch.from_numpy(
            (occupancy == 0).astype(np.float32)).to(dev),
        res=float(res32),
        origin_xy=(float(origin32[0]), float(origin32[1])),
    )


def load_map(yaml_path: str,
             device: str | torch.device = DEFAULT_DEVICE) -> GridMap:
    """Load a ROS map YAML+PGM pair onto ``device`` (the card unless told
    otherwise)."""
    occ, meta = load_map_yaml(yaml_path)
    return build_grid_map(occ, meta["resolution"], meta["origin"][:2],
                          device=device)
