"""ctypes binding to the native C++ EDT library (port of
``mcmh_localization_tpu/native/__init__.py``, with its contract).

The library is ``native/libmcmh_native.so`` at the root of the checkout,
built from ``native/edt.cpp`` by ``make -C native``; this module does not
build it.  ``available()`` says whether it is built and loads;
``edt(occupied)`` is its exact Felzenszwalb EDT on the host, the
``edt_impl="native"`` choice of ``maps/grid_map.py::build_grid_map``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libmcmh_native.so"
_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not LIB_PATH.exists():
        raise ImportError(
            f"{LIB_PATH} not built; run `make -C native` or use a "
            "non-native implementation"
        )
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.mcmh_edt.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mcmh_edt.restype = None
    _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _load()
        return True
    except ImportError:
        return False


def edt(occupied: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance (cells, f32) to the nearest True cell,
    Felzenszwalb O(n); matches ``scipy.ndimage.distance_transform_edt(
    ~occupied)``.  Raises ImportError when the library is not built."""
    lib = _load()
    occ = np.ascontiguousarray(occupied, dtype=np.uint8)
    h, w = occ.shape
    out = np.empty((h, w), dtype=np.float32)
    lib.mcmh_edt(
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(h),
        ctypes.c_int(w),
    )
    return out
