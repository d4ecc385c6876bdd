"""Exact Euclidean distance transform (port of
``mcmh_localization_tpu/maps/edt.py``).

* ``distance_transform_edt``: scipy's on the host, as the JAX package's
  ``edt_impl="scipy"`` and the reference's one-time precompute use.
* ``squared_edt_device`` / ``distance_transform_edt_device``: the EDT on
  the occupancy tensor's device, through ``ops/edt.py::squared_edt`` (the
  CUDA kernel ``csrc/edt.cu`` on the card, its plain version on the CPU).
  The squared distances are exact integers; the meter form is JAX's
  ``sqrt(d2) * resolution`` in f32, which differs from scipy's
  ``(edt * res).astype(f32)`` by an ulp in some cells.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmh_localization_tpu_torch.ops.edt import squared_edt


def distance_transform_edt(occupied: np.ndarray,
                           resolution: float = 1.0) -> np.ndarray:
    """Meters from each cell to the nearest ``occupied`` cell, (H, W) f64.
    Matches ``scipy.ndimage.distance_transform_edt(~occupied) * resolution``
    (amcmh_localizer.py:156; unknown cells count as occupied)."""
    from scipy.ndimage import distance_transform_edt as _edt

    return _edt(~np.asarray(occupied, dtype=bool)) * resolution


def squared_edt_device(occupied: torch.Tensor,
                       chunk: int = 128) -> torch.Tensor:
    """Exact squared EDT (in cells) of the free region to the nearest
    ``occupied`` cell, ``occupied`` an (H, W) bool tensor: (H, W) f32 on its
    device, 1e12 everywhere on a map with no occupied cell.  ``chunk``
    bounds the plain version's memory on the CPU (columns a min-plus
    product); the kernel ignores it."""
    return squared_edt(occupied, chunk)


def distance_transform_edt_device(occupied: torch.Tensor, resolution=1.0,
                                  chunk: int = 128) -> torch.Tensor:
    """Euclidean distance (meters) from each cell to the nearest occupied
    cell, (H, W) f32 on ``occupied``'s device: ``sqrt`` of the squared form
    times the resolution as f32, JAX's order (maps/edt.py:69-70).
    ``chunk`` as in ``squared_edt_device``."""
    d2 = squared_edt_device(occupied, chunk=chunk)
    res = torch.as_tensor(resolution, dtype=torch.float32, device=d2.device)
    return torch.sqrt(d2) * res
