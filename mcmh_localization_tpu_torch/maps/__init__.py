from mcmh_localization_tpu_torch.maps.grid_map import (
    GridMap,
    build_grid_map,
    load_map,
)

# the JAX package's maps exports, less the device EDT and the voxel map
# (not ported)
__all__ = [
    "GridMap",
    "load_map",
    "build_grid_map",
]
