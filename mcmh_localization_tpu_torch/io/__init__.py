from mcmh_localization_tpu_torch.io.pgm import load_map_yaml, read_pgm, write_pgm
from mcmh_localization_tpu_torch.io.rosbag import read_rosbag, write_rosbag
from mcmh_localization_tpu_torch.io.rosbag2 import read_rosbag2, write_rosbag2

# the JAX package's io exports
__all__ = [
    "read_pgm",
    "write_pgm",
    "load_map_yaml",
    "read_rosbag",
    "write_rosbag",
    "read_rosbag2",
    "write_rosbag2",
]
