"""mcmh_localization_tpu_torch — the PyTorch/CUDA port of mcmh_localization_tpu.

It keeps the JAX package's module layout (``maps``, ``models``, ``ops``,
``filter``, ``sim``, ``eval``, ``io``) and its array layouts at the public
functions: particles (n_max, 3) f32 padded to a static n_max with a
``count`` scalar, fields (K, h, w).  The entry points (``build_grid_map``, ``load_map`` and the
``convert`` functions) put their tensors on the card unless the caller
names another device (the tests pass ``device="cpu"``), and raise when
there is no card; every later step runs where the map lives.  The kernels
the JAX package wrote in Pallas for the TPU are CUDA C++ for Hopper here
(``csrc/``, built on first use by ``ops/_cuda.py``), each beside a plain
PyTorch version that CPU tensors take.  The port imports, opens and
executes nothing of JAX or of the JAX package: ``config.py``, ``io/``'s
readers, ``sim/bag.py``, ``eval``'s evaluator and plots and ``native/``'s
ctypes binding are its own copies of that package's pure-Python files.  The top level exports the
JAX package's names; ``build_grid_map`` is importable here too, as in
``maps.grid_map``.
"""

__version__ = "0.1.0"

from mcmh_localization_tpu_torch.config import FilterConfig, parse_mode
from mcmh_localization_tpu_torch.maps.grid_map import (
    GridMap,
    build_grid_map,
    load_map,
)

__all__ = [
    "FilterConfig",
    "parse_mode",
    "GridMap",
    "load_map",
    "__version__",
]
