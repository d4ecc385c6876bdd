"""Carry a map, a voxel map, a filter state and beam tables across from
numpy arrays.

Both packages then compute on the same inputs: a JAX ``GridMap``,
``VoxelMap``, ``FilterState`` or ``BeamTables`` flattened to numpy arrays (``np.asarray``
of each field) rebuilds here.  The PRNG key is the one field that cannot
transfer: the port's state takes a fresh ``torch.Generator``.  Each
function puts its tensors on the card unless ``device`` names another
device, and raises when there is no card to put them on.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmh_localization_tpu_torch.filter.state import FilterState, make_generator
from mcmh_localization_tpu_torch.maps.grid_map import GridMap, build_grid_map
from mcmh_localization_tpu_torch.maps.voxel_map import VoxelMap
from mcmh_localization_tpu_torch.models.range_table import BeamTables
from mcmh_localization_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    resolve_device,
)

STATE_FIELDS = ("particles", "prev_particles", "weights", "count", "w_slow",
                "w_fast", "delta", "anchor", "anchor_streak")
_INT_FIELDS = ("count", "anchor_streak")


def grid_map_from_numpy(occupancy, resolution, origin, distance=None,
                        device=DEFAULT_DEVICE) -> GridMap:
    """A GridMap from trinary int8 occupancy, resolution, origin (x, y) and
    optionally the distance field (else scipy's EDT)."""
    return build_grid_map(np.asarray(occupancy), float(resolution),
                          tuple(float(o) for o in np.asarray(origin)[:2]),
                          distance=distance, device=device)


def voxel_map_from_numpy(occupancy, distance, resolution, origin,
                         max_distance=None, device=DEFAULT_DEVICE) -> VoxelMap:
    """A VoxelMap from a JAX VoxelMap's arrays and metadata as they are: the
    int8 occupancy, the f32 distance volume (no EDT is recomputed), the
    resolution, the (x, y, z) origin and the EDT cap."""
    dev = resolve_device(device)
    return VoxelMap(
        occupancy=torch.as_tensor(np.array(occupancy), dtype=torch.int8,
                                  device=dev),
        distance=torch.as_tensor(np.array(distance), dtype=torch.float32,
                                 device=dev),
        resolution=float(resolution),
        origin=tuple(float(o) for o in origin),
        max_distance=None if max_distance is None else float(max_distance),
    )


def beam_tables_from_numpy(table, qt, dvals, qtc=None,
                           device=DEFAULT_DEVICE) -> BeamTables:
    """BeamTables from a JAX BeamTables' fields as numpy arrays: the f32
    range table, its int8 ``qt``, the ``dvals`` and the coarse ``qtc`` (or
    None)."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return BeamTables(table=t(table, torch.float32), qt=t(qt, torch.int8),
                      dvals=t(dvals, torch.float32),
                      qtc=None if qtc is None else t(qtc, torch.int8))


def state_from_numpy(arrays: dict, device=DEFAULT_DEVICE,
                     generator: torch.Generator | None = None) -> FilterState:
    """A FilterState from a dict of numpy arrays with the JAX FilterState's
    field names (``key`` is ignored); ``generator`` (default: seeded with
    0) becomes the state's random source."""
    dev = resolve_device(device)
    kw = {}
    for name in STATE_FIELDS:
        dtype = torch.int32 if name in _INT_FIELDS else torch.float32
        kw[name] = torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                                   device=dev)
    return FilterState(key=generator or make_generator(0, dev), **kw)
