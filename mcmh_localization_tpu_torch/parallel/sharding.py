"""Particle-axis sharding over a 1-D ``torch.distributed`` mesh (port of
``mcmh_localization_tpu/parallel/sharding.py``).

``make_mesh`` gives the 1-D ``DeviceMesh`` over the ranks of the default
process group, which the caller initializes (NCCL on cards, gloo on the
CPU); one rank holds one device: the card where there is one and the
group carries its tensors (``mesh_device_type``, ``rank_device``).
``shard_state`` keeps this rank's block of a state's rows: ``nl = n_max /
D`` rows of ``particles``, ``prev_particles`` and ``weights``, every other
field as it is.

``make_sharded_model`` is the GSPMD twin: its step equals ``make_model``'s
step on the same state and generator.  XLA all-gathers the full set for
the JAX package's resamplers (its docstring says so); here the step
all-gathers the rows, runs ``filter/step.py``'s ``_predict`` +
``_correct`` on the full set with the replicated generator (every rank
seeds it alike, so every rank draws alike) and keeps this rank's rows.
``parallel/distributed.py`` is the designed multi-rank filter, whose
collectives never move the particle set.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from mcmh_localization_tpu_torch.filter.state import FilterState
from mcmh_localization_tpu_torch.filter.step import (
    Draws,
    as_f32,
    make_model,
    stack_infos,
    state_size,
)
from mcmh_localization_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    resolve_device,
)


def group_device_types(group=None) -> set:
    """The device types whose tensors ``group``'s collectives carry: a
    combined backend names them ("cpu:gloo,cuda:nccl"), NCCL carries CUDA
    tensors alone, gloo both, and so does a group started with no backend
    named, a backend a device type (some torch versions name it
    "undefined")."""
    backend = str(dist.get_backend(group))
    if ":" in backend:
        return {part.split(":")[0] for part in backend.split(",")}
    return {"cuda"} if backend == "nccl" else {"cpu", "cuda"}


def mesh_device_type(group=None) -> str:
    """The device type of a mesh over ``group``: the card where there is
    one and the group carries its tensors, else the CPU where the group
    carries that (a group of CPU backends alone names the CPU).  Raises
    when the group carries neither."""
    types = group_device_types(group)
    if torch.cuda.is_available() and "cuda" in types:
        return "cuda"
    if "cpu" in types:
        return "cpu"
    raise RuntimeError(
        f"the process group's backend {dist.get_backend(group)!r} carries "
        "CUDA tensors alone and no CUDA device is available")


def rank_device(device=None, group=None) -> torch.device:
    """This rank's device: ``device``, by default the current card (the
    port's device rule, ``utils/device.py``: raises without one; pass
    ``device="cpu"`` for the CPU).  Raises when ``group`` cannot carry
    tensors on it."""
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in group_device_types(group):
        raise RuntimeError(
            f"the process group's backend {dist.get_backend(group)!r} cannot "
            f"carry tensors on {dev}")
    return dev


def make_mesh(devices: Sequence[int] | None = None, axis: str = "data"):
    """1-D mesh over the particle axis: the ranks ``devices`` (default all
    ranks) of the default process group, named ``axis``, on
    ``mesh_device_type``'s device.  Raises when no process group is
    initialized: the caller starts one (``torch.distributed.
    init_process_group``: NCCL on cards, gloo on the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call torch."
            "distributed.init_process_group (NCCL on cards, gloo on the CPU) "
            "on every rank first")
    from torch.distributed.device_mesh import DeviceMesh

    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    return DeviceMesh(mesh_device_type(), ranks, mesh_dim_names=(axis,))


def shard_state(state: FilterState, mesh, axis: str = "data") -> FilterState:
    """This rank's rows of a full state: block ``r`` of D equal blocks of
    ``particles``, ``prev_particles`` and ``weights`` (copies, so the full
    arrays free); the scalars and the generator stay."""
    n_dev = mesh.size()
    n_max = state.n_max
    if n_max % n_dev:
        raise ValueError(f"n_max={n_max} is not a multiple of the mesh size "
                         f"{n_dev}")
    nl = n_max // n_dev
    lo = mesh.get_local_rank(axis) * nl
    return state.replace(
        particles=state.particles[lo:lo + nl].clone(),
        prev_particles=state.prev_particles[lo:lo + nl].clone(),
        weights=state.weights[lo:lo + nl].clone(),
    )


class ShardedModel(NamedTuple):
    config: object
    grid_map: object
    mesh: object
    step: object       # (state, ranges, angles, delta[, draws]) -> (state, info)
    run: object        # (state, ranges_seq, angles, deltas) -> (state, infos)
    init: object       # seed -> this rank's FilterState


def make_sharded_model(config, grid_map, mesh,
                       axis: str = "data") -> ShardedModel:
    """The step and run of ``make_model(config, grid_map)`` on states
    sharded over ``mesh``.  The particle count is padded up to a multiple
    of the mesh size, so every rank holds an equal block."""
    from mcmh_localization_tpu_torch.parallel.distributed import (
        all_gather_tiled,
    )

    n_dev = mesh.size()
    n_max = state_size(config)
    if n_max % n_dev:
        pad = n_dev - n_max % n_dev
        if config.use_adaptive:
            config = config.replace(max_particles=n_max + pad)
        else:
            config = config.replace(num_particles=n_max + pad,
                                    max_particles=n_max + pad)
    base = make_model(config, grid_map)
    group = mesh.get_group(axis)

    def step(state, ranges, angles, delta, draws: Draws | None = None):
        # _predict overwrites prev_particles with the gathered particles
        particles = all_gather_tiled(state.particles, group)
        full = state.replace(particles=particles, prev_particles=particles,
                             weights=all_gather_tiled(state.weights, group))
        full, info = base.step(full, ranges, angles, delta, draws)
        return shard_state(full, mesh, axis), info

    def run(state, ranges_seq, angles, deltas):
        ranges_seq = as_f32(ranges_seq, base.device)
        deltas = as_f32(deltas, base.device)
        infos = []
        for t in range(ranges_seq.shape[0]):
            state, info = step(state, ranges_seq[t], angles, deltas[t])
            infos.append(info)
        return state, stack_infos(infos, device=base.device)

    def init(seed: int = 0, **kw) -> FilterState:
        return shard_state(base.init(seed, **kw), mesh, axis)

    return ShardedModel(config=config, grid_map=grid_map, mesh=mesh,
                        step=step, run=run, init=init)
