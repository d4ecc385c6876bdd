"""Batched multi-robot localization (port of
``mcmh_localization_tpu/parallel/batched.py``).

A fleet of B robots keeps one stacked state: every tensor of
``FilterState`` carries a leading B axis (particles (B, n_max, 3)), and
``key`` holds B generators, one a robot.  The JAX package vmaps one step
over that axis.  Here ``step`` runs each robot's single-program
``_predict`` + ``_correct`` on its row of the stacked state, on its own
generator, in robot order, and stacks the rows again: the port's step
takes its data-dependent decisions on the host (the window origin, the
injection count, the ESS gate, the KLD stop rule), and each of them is a
robot's own.  One launch a kernel for the whole fleet waits for those
decisions to move onto the device.

``make_multimap_model`` gives each robot its own map: ``stack_maps``
stacks same-shaped maps, and each robot's exact log-likelihood field is
built once from its map (JAX rebuilds it inside its vmapped step; the
values are the same).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mcmh_localization_tpu_torch.filter.state import (
    FilterState,
    make_generator,
    split_seed,
)
from mcmh_localization_tpu_torch.filter.step import (
    as_f32,
    make_model,
    stack_infos,
)
from mcmh_localization_tpu_torch.maps.grid_map import GridMap

_TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(FilterState)
                       if f.name != "key")


class BatchedModel(NamedTuple):
    config: object
    grid_map: object
    batch: int
    step: object   # (states, ranges (B, M), angles (M,), deltas (B, 3)) -> ...
    run: object    # (states, ranges (T, B, M), angles, deltas (T, B, 3)) -> ...
    init: object   # seed -> batched FilterState


def stack_states(states) -> FilterState:
    """One stacked state from B states: each tensor field stacked on a new
    leading axis, ``key`` the tuple of their B generators (which must be B
    distinct generators: a shared one would couple the robots' draws)."""
    keys = tuple(s.key for s in states)
    if len({id(k) for k in keys}) != len(keys):
        raise ValueError("stack_states: the states share a generator; give "
                         "each robot its own (filter/state.py::"
                         "copy_generator)")
    return FilterState(
        **{f: torch.stack([getattr(s, f) for s in states])
           for f in _TENSOR_FIELDS}, key=keys)


def state_row(states: FilterState, b: int) -> FilterState:
    """Robot ``b``'s state: row b of each tensor field and its generator."""
    return FilterState(**{f: getattr(states, f)[b] for f in _TENSOR_FIELDS},
                       key=states.key[b])


def stack_maps(maps) -> GridMap:
    """Stack same-shaped GridMaps into one GridMap whose tensors carry a
    leading batch axis.

    ``free_xy`` tables differ in length per map, so each is padded to the
    longest by tiling its own entries: every free cell then appears k or
    k+1 times, keeping uniform free-space sampling within ~1/F of exact.
    The maps must share their shape, resolution and origin, which a GridMap
    also carries as python floats."""
    first = maps[0]
    for m in maps[1:]:
        if m.occupancy.shape != first.occupancy.shape:
            raise ValueError(f"stack_maps: map shapes differ "
                             f"({tuple(m.occupancy.shape)} vs "
                             f"{tuple(first.occupancy.shape)})")
        if m.res != first.res or m.origin_xy != first.origin_xy:
            raise ValueError("stack_maps: the maps' resolutions or origins "
                             "differ")
    f_max = max(m.free_xy.shape[0] for m in maps)

    def pad_free(m):
        f = m.free_xy.shape[0]
        reps = -(-f_max // f)
        return m.free_xy.repeat(reps, 1)[:f_max]

    fields = {f.name: torch.stack([getattr(m, f.name) for m in maps])
              for f in dataclasses.fields(GridMap)
              if f.name not in ("free_xy", "res", "origin_xy")}
    return GridMap(free_xy=torch.stack([pad_free(m) for m in maps]),
                   res=first.res, origin_xy=first.origin_xy, **fields)


def map_row(grid_maps: GridMap, b: int) -> GridMap:
    """Robot ``b``'s map from ``stack_maps``' stacked map."""
    return dataclasses.replace(
        grid_maps, **{f.name: getattr(grid_maps, f.name)[b]
                      for f in dataclasses.fields(GridMap)
                      if f.name not in ("res", "origin_xy")})


def _fleet(config, grid_map, models, batch: int) -> BatchedModel:
    """The BatchedModel over one FilterModel a robot (``models``)."""
    dev = models[0].device

    def step(states, ranges, angles, deltas, draws=None):
        """One scan of every robot; ``draws``: None, or B ``Draws`` (one a
        robot, as ``FilterModel.step`` takes them)."""
        ranges, angles = as_f32(ranges, dev), as_f32(angles, dev)
        deltas = as_f32(deltas, dev)
        rows, infos = [], []
        for b in range(batch):
            st, info = models[b].step(state_row(states, b), ranges[b], angles,
                                      deltas[b],
                                      None if draws is None else draws[b])
            rows.append(st)
            infos.append(info)
        return stack_states(rows), stack_infos(infos)

    def run(states, ranges_seq, angles, deltas_seq):
        ranges_seq, angles = as_f32(ranges_seq, dev), as_f32(angles, dev)
        deltas_seq = as_f32(deltas_seq, dev)
        infos = []
        for t in range(ranges_seq.shape[0]):
            states, info = step(states, ranges_seq[t], angles, deltas_seq[t])
            infos.append(info)
        return states, stack_infos(infos, device=dev, batch=(batch,))

    def init(seed: int = 0, initial_poses=None):
        """Each robot's initial state on its own generator, from ``seed``
        split into B seeds (JAX splits one key)."""
        states = [
            models[b].init(make_generator(s, dev),
                           initial_pose=(None if initial_poses is None
                                         else initial_poses[b]))
            for b, s in enumerate(split_seed(seed, batch))]
        return stack_states(states)

    return BatchedModel(config=config, grid_map=grid_map, batch=batch,
                        step=step, run=run, init=init)


def make_multimap_model(config, grid_maps: GridMap, batch: int) -> BatchedModel:
    """Batched localization with a DIFFERENT map per robot.

    ``grid_maps``: ``stack_maps``' GridMap, its tensors with a leading
    batch axis.  Uses the exact ("jnp") likelihood scorer, as the JAX
    package forces it; each robot's field is built from its own map."""
    config = config.replace(likelihood_impl="jnp")
    models = [make_model(config, map_row(grid_maps, b)) for b in range(batch)]
    return _fleet(config, grid_maps, models, batch)


def make_batched_model(config, grid_map, batch: int) -> BatchedModel:
    """B robots on one map: one FilterModel (one sensor table) for all."""
    model = make_model(config, grid_map)
    return _fleet(config, grid_map, [model] * batch, batch)
