from mcmh_localization_tpu_torch.io.pgm import load_map_yaml, read_pgm, write_pgm

# the JAX package's io exports, less the rosbag readers and writers (not
# ported)
__all__ = [
    "read_pgm",
    "write_pgm",
    "load_map_yaml",
]
