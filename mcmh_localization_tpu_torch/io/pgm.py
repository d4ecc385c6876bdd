"""PGM image + ROS map YAML loading: the JAX package's numpy-only
``io/pgm.py``, loaded by path (``_shared.py``)."""

from __future__ import annotations

from mcmh_localization_tpu_torch import _shared

_src = _shared.load("io/pgm.py", "mcmh_localization_tpu_torch._pgm_src")

read_pgm = _src.read_pgm
write_pgm = _src.write_pgm
load_map_yaml = _src.load_map_yaml
