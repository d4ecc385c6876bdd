from mcmh_localization_tpu_torch.maps.grid_map import (
    GridMap,
    build_grid_map,
    load_map,
)
from mcmh_localization_tpu_torch.maps.voxel_map import (
    VoxelMap,
    build_voxel_map,
    load_voxel_map,
    nav_slice,
    raycast3d,
    save_voxel_map,
)

# the JAX package's maps exports, less the device EDT (the port's EDT is
# scipy's on the host)
__all__ = [
    "GridMap",
    "load_map",
    "build_grid_map",
    "VoxelMap",
    "build_voxel_map",
    "nav_slice",
    "raycast3d",
    "save_voxel_map",
    "load_voxel_map",
]
