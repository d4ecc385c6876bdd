"""mcmh_localization_tpu_torch — the PyTorch/CUDA port of mcmh_localization_tpu.

It keeps the JAX package's module layout (``maps``, ``models``, ``ops``,
``filter``) and its array layouts at the public functions: particles
(n_max, 3) f32 padded to a static n_max with a ``count`` scalar, fields
(K, h, w).  Plain functions take tensors on an explicit device; the kernels
the JAX package wrote in Pallas for the TPU are CUDA C++ for Hopper here
(``csrc/``, built on first use by ``ops/_cuda.py``), each beside a plain
PyTorch version that CPU tensors take.  The port imports neither JAX nor
the JAX package; ``config.py`` and ``io/pgm.py``, which are pure Python,
are the JAX package's own files loaded by path.
"""

from mcmh_localization_tpu_torch.config import FilterConfig, parse_mode
from mcmh_localization_tpu_torch.maps.grid_map import (
    GridMap,
    build_grid_map,
    load_map,
)

__all__ = ["FilterConfig", "parse_mode", "GridMap", "build_grid_map",
           "load_map"]
