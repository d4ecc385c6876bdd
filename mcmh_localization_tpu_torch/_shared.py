"""Pure-Python modules shared with the JAX package, loaded by file path.

``mcmh_localization_tpu/config.py`` and ``io/pgm.py`` import neither JAX
nor Flax, but importing them through their package would run
``mcmh_localization_tpu/__init__.py``, which does.  Loading the files by
path gives the port the same single source without importing JAX.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_JAX_PKG = Path(__file__).resolve().parent.parent / "mcmh_localization_tpu"


def load(relpath: str, name: str):
    """Execute ``mcmh_localization_tpu/<relpath>`` as module ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, _JAX_PKG / relpath)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {_JAX_PKG / relpath}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses resolve annotations through it
    spec.loader.exec_module(mod)
    return mod
