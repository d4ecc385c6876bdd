"""Exact Euclidean distance transform on the host (port of
``mcmh_localization_tpu/maps/edt.py``): scipy's, as the JAX package's
``edt_impl="scipy"`` and the reference's one-time precompute use."""

from __future__ import annotations

import numpy as np


def distance_transform_edt(occupied: np.ndarray,
                           resolution: float = 1.0) -> np.ndarray:
    """Meters from each cell to the nearest ``occupied`` cell, (H, W) f64.
    Matches ``scipy.ndimage.distance_transform_edt(~occupied) * resolution``
    (amcmh_localizer.py:156; unknown cells count as occupied)."""
    from scipy.ndimage import distance_transform_edt as _edt

    return _edt(~np.asarray(occupied, dtype=bool)) * resolution
