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

from mcmh_localization_tpu_torch import native
from mcmh_localization_tpu_torch.io.pgm import load_map_yaml
from mcmh_localization_tpu_torch.maps.edt import (
    distance_transform_edt,
    distance_transform_edt_device,
)
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

    @property
    def limits(self) -> torch.Tensor:
        """(4,) f32 [x_min, x_max, y_min, y_max] (amcmh_localizer.py:168-173;
        JAX grid_map.py:58-70)."""
        ox, oy = self.origin[0], self.origin[1]
        return torch.stack([ox, ox + self.width * self.resolution,
                            oy, oy + self.height * self.resolution])

    def replace(self, **kw) -> "GridMap":
        """A copy with the given fields (JAX's flax ``.replace``).  A new
        ``resolution`` or ``origin`` tensor also sets the python floats kept
        beside it, unless ``res`` / ``origin_xy`` are given too."""
        if "resolution" in kw and "res" not in kw:
            kw["res"] = float(kw["resolution"])
        if "origin" in kw and "origin_xy" not in kw:
            kw["origin_xy"] = tuple(float(o) for o in kw["origin"][:2])
        return dataclasses.replace(self, **kw)

    # ---- transforms --------------------------------------------------------

    def world_to_grid(self, x, y):
        """(mx, my) int32 cells; ``int((x - origin) / res)`` truncation."""
        mx = ((x - self.origin[0]) / self.resolution).to(torch.int32)
        my = ((y - self.origin[1]) / self.resolution).to(torch.int32)
        return mx, my

    def grid_to_world(self, mx, my):
        """World coords of cell centres, f32 on the map's device
        (amcmh_localizer.py:163-164; JAX grid_map.py:80-84)."""
        mx = torch.as_tensor(mx, device=self.device).to(torch.float32)
        my = torch.as_tensor(my, device=self.device).to(torch.float32)
        return (self.origin[0] + (mx + 0.5) * self.resolution,
                self.origin[1] + (my + 0.5) * self.resolution)

    def in_bounds(self, mx, my) -> torch.Tensor:
        return (mx >= 0) & (mx < self.width) & (my >= 0) & (my < self.height)

    # ---- queries (safe out of bounds: clamp + mask) ------------------------

    def occupancy_at(self, mx, my, fill: int = 100) -> torch.Tensor:
        ok = self.in_bounds(mx, my)
        vals = self.occupancy[my.clamp(0, self.height - 1).long(),
                              mx.clamp(0, self.width - 1).long()]
        # a python fill, not a tensor copied from the host (a captured step
        # holds no host copy): an int scalar keeps the int8 dtype
        return torch.where(ok, vals, fill)

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


EDT_IMPLS = ("auto", "native", "device", "scipy")


def build_grid_map(
    occupancy: np.ndarray,
    resolution: float,
    origin: Tuple[float, float] = (0.0, 0.0),
    distance: np.ndarray | None = None,
    edt_impl: str = "scipy",
    device: str | torch.device = DEFAULT_DEVICE,
) -> GridMap:
    """Build a GridMap on ``device`` (the card unless told otherwise; raises
    without one), computing the EDT by ``edt_impl`` when ``distance`` is
    not given: "scipy" (the default; JAX's is "auto"), "native", "device"
    or "auto" (see ``_compute_edt``)."""
    dev = resolve_device(device)
    occupancy = np.asarray(occupancy, dtype=np.int8)
    if distance is None:
        field = _compute_edt(occupancy != 0, resolution, edt_impl, dev)
    else:
        field = torch.from_numpy(np.array(distance, np.float32)).to(dev)
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
        distance=field,
        origin=torch.from_numpy(origin32).to(dev),
        resolution=torch.tensor(res32, dtype=torch.float32, device=dev),
        free_xy=torch.from_numpy(free_xy).to(dev),
        free_mask=torch.from_numpy(
            (occupancy == 0).astype(np.float32)).to(dev),
        res=float(res32),
        origin_xy=(float(origin32[0]), float(origin32[1])),
    )


def _compute_edt(occupied: np.ndarray, resolution: float, impl: str,
                 dev: torch.device) -> torch.Tensor:
    """The (H, W) f32 distance field in meters on ``dev``, with the JAX
    package's meanings (grid_map.py:165-180): "scipy" on the host; "native"
    the C++ library (raises when it is not built); "device" the EDT kernel
    on ``dev`` (its plain version on the CPU), kept there; "auto" native
    when ``native.available()``, else device.  Any other name raises (JAX
    takes its device path there)."""
    if impl not in EDT_IMPLS:
        raise ValueError(f"edt_impl {impl!r}: expected one of {EDT_IMPLS}")
    if impl == "auto":
        impl = "native" if native.available() else "device"
    if impl == "device":
        return distance_transform_edt_device(
            torch.from_numpy(occupied).to(dev), resolution)
    if impl == "native":
        dist = native.edt(occupied) * resolution
    else:
        dist = distance_transform_edt(occupied, resolution)
    return torch.from_numpy(np.array(dist, np.float32)).to(dev)


def load_map(yaml_path: str, edt_impl: str = "scipy",
             device: str | torch.device = DEFAULT_DEVICE) -> GridMap:
    """Load a ROS map YAML+PGM pair onto ``device`` (the card unless told
    otherwise), its EDT by ``edt_impl`` as in ``build_grid_map``."""
    occ, meta = load_map_yaml(yaml_path)
    return build_grid_map(occ, meta["resolution"], meta["origin"][:2],
                          edt_impl=edt_impl, device=device)
