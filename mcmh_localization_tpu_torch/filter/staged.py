"""Staged two-program execution (port of
``mcmh_localization_tpu/filter/staged.py``, single device).

A KLD-adaptive config runs as two programs over the same config:

  * BIG:   n_max = max_particles (global localization, recovery); no corr
           window (full-map field, all theta bins), "sum" aggregation,
           capacity-scaled injection refill;
  * SMALL: n_max = tracking capacity (converged tracking); the windowed
           field without the coarse fallback, optional ESS-gated resampling.

The host runs ``chunk`` scans at a time (on the card, one replay of each
program's captured step a scan, ``filter/captured.py``), reads the chunk's
StepInfo once and hands the state over: down (an exact prefix slice) when the counts fit the
small capacity and one mode dominates, up (zero tail pad) on injection, a
count pegged at capacity, or decaying mode dominance.  See the JAX module
docstring for the measured rationale of each choice.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mcmh_localization_tpu_torch.filter.state import FilterState, copy_generator
from mcmh_localization_tpu_torch.filter.step import (
    FilterModel,
    StepInfo,
    as_f32,
    concat_infos,
    make_model,
    state_size,
)


class StagedModel(NamedTuple):
    config: object          # the BIG config
    small_config: object    # capacity-reduced twin
    grid_map: object
    big: FilterModel        # or a DistModel (make_staged_dist_model)
    small: FilterModel
    init: object
    # the hand-offs; None = shrink_state / grow_state on the whole state.
    # make_staged_dist_model installs per-rank ones: each island is
    # prefix-packed after its own resample, so every rank's rows are
    # sliced or padded, not the global prefix
    shrink: object = None
    grow: object = None


def default_tracking_capacity(config) -> int:
    """1.3x min_particles rounded up to 1024, below the full capacity."""
    cap = int(1.3 * config.min_particles)
    cap = -(-cap // 1024) * 1024
    return min(max(cap, 1024), state_size(config))


def make_staged_model(
    config,
    grid_map,
    tracking_capacity: int | None = None,
    voxel_map=None,
    global_scoring: str = "full",
    tracking_ess_threshold: float | None = None,
    tracking_theta_bins: int | None = None,
    tracking_window_cells: int | None = None,
    global_score_aggregation: str | None = "sum",
) -> StagedModel:
    """Build the two programs; ``config`` must be adaptive.  The parameters
    are the JAX ``make_staged_model``'s, in its order; ``voxel_map`` is the
    3-D lidar's VoxelMap (``grid_map`` then its navigation slice), passed to
    both programs."""
    big_config, small_config = _staged_configs(
        config, tracking_capacity, global_scoring, tracking_ess_threshold,
        tracking_theta_bins, tracking_window_cells, global_score_aggregation,
    )
    big = make_model(big_config, grid_map, voxel_map=voxel_map)
    small = make_model(small_config, grid_map, voxel_map=voxel_map)
    big.name, small.name = "big", "small"
    return StagedModel(config=big_config, small_config=small_config,
                       grid_map=grid_map, big=big, small=small,
                       init=big.init)


def _staged_configs(
    config,
    tracking_capacity: int | None,
    global_scoring: str,
    tracking_ess_threshold: float | None,
    tracking_theta_bins: int | None,
    tracking_window_cells: int | None,
    global_score_aggregation: str | None = "sum",
):
    """(big_config, small_config), as the JAX _staged_configs derives them."""
    if not config.use_adaptive:
        raise ValueError(
            "make_staged_model needs an adaptive mode (AMCL/*AMCL): "
            "non-adaptive counts never change, one program suffices"
        )
    if global_scoring not in ("full", "windowed"):
        raise ValueError(f"unknown global_scoring {global_scoring!r}")
    cap = tracking_capacity or default_tracking_capacity(config)
    n_big = state_size(config)
    if cap >= n_big:
        raise ValueError(
            f"tracking_capacity {cap} must be < max capacity {n_big}")
    if cap < config.min_particles:
        raise ValueError(
            f"tracking_capacity {cap} < min_particles {config.min_particles}")
    big_config = config
    # BIG scores the full per-scan log-likelihood (product over beams)
    if (global_score_aggregation is not None
            and global_score_aggregation != config.score_aggregation):
        big_config = big_config.replace(
            score_aggregation=global_score_aggregation)
    # BIG is the recovery program: injection refills to capacity
    if big_config.use_adaptive and big_config.adaptive_resampler == "kld":
        big_config = big_config.replace(injection_refill=True)
    if global_scoring == "full" and config.corr_window_cells:
        big_config = big_config.replace(
            corr_window_cells=0, corr_theta_window_bins=0,
            beam_impl=(
                "table" if config.sensor_model == "beam"
                and config.beam_impl in ("auto", "field") else config.beam_impl
            ),
        )
    small_kw = {}
    if tracking_ess_threshold is not None:
        small_kw["resample_ess_threshold"] = tracking_ess_threshold
    if tracking_theta_bins is not None:
        if not config.corr_window_cells:
            raise ValueError("tracking_theta_bins needs a windowed scorer "
                             "(corr_window_cells > 0)")
        if (config.corr_theta_window_bins
                and tracking_theta_bins > config.corr_theta_window_bins):
            raise ValueError(
                f"tracking_theta_bins {tracking_theta_bins} > the config's "
                f"corr_theta_window_bins {config.corr_theta_window_bins}: "
                "the tracking theta window only shrinks")
        small_kw["corr_theta_window_bins"] = tracking_theta_bins
    if tracking_window_cells is not None:
        if not config.corr_window_cells:
            raise ValueError("tracking_window_cells needs a windowed scorer "
                             "(corr_window_cells > 0)")
        if tracking_window_cells > config.corr_window_cells:
            raise ValueError(
                f"tracking_window_cells {tracking_window_cells} > the "
                f"config's corr_window_cells {config.corr_window_cells}: "
                "the tracking window only shrinks")
        small_kw["corr_window_cells"] = tracking_window_cells
    # SMALL drops the (optimistic, max-pooled) coarse out-of-window fallback
    if config.corr_window_cells and config.corr_coarse_factor:
        small_kw.setdefault("corr_coarse_factor", 0)
    small_config = config.replace(
        num_particles=min(config.num_particles, cap),
        max_particles=cap,
        **small_kw,
    )
    return big_config, small_config


def make_staged_dist_model(
    config,
    grid_map,
    mesh,
    axis: str = "data",
    tracking_capacity: int | None = None,
    voxel_map=None,
    global_scoring: str = "full",
    tracking_theta_bins: int | None = None,
    tracking_window_cells: int | None = None,
    migration_fraction: float = 0.125,
    global_score_aggregation: str | None = "sum",
) -> StagedModel:
    """Staged execution over a mesh: both programs are
    ``parallel/distributed.py`` models over the same mesh, and the hand-off
    resizes each rank's rows with no collective (JAX :270-356).

    The island KLD packs each island's active particles into its own
    prefix, and the count stays a multiple of D with every island the same
    size, so count <= cap means count / D <= cap / D on every rank: slicing
    cap / D rows off every rank keeps every active particle, and growing
    zero-pads every rank's tail.  ``tracking_ess_threshold`` is absent: the
    distributed step always resamples.  The counts and the capacity are
    rounded to multiples of the mesh size."""
    from mcmh_localization_tpu_torch.parallel.distributed import (
        make_dist_model,
        round_counts,
        round_up,
    )

    config = round_counts(config, mesh.size())
    cap = round_up(tracking_capacity or default_tracking_capacity(config),
                   mesh.size())
    big_config, small_config = _staged_configs(
        config, cap, global_scoring, None, tracking_theta_bins,
        tracking_window_cells, global_score_aggregation,
    )
    big = make_dist_model(big_config, grid_map, mesh, axis=axis,
                          migration_fraction=migration_fraction,
                          voxel_map=voxel_map)
    small = make_dist_model(small_config, grid_map, mesh, axis=axis,
                            migration_fraction=migration_fraction,
                            voxel_map=voxel_map)
    return StagedModel(
        config=big.config, small_config=small.config, grid_map=grid_map,
        big=big, small=small, init=big.init,
        shrink=_shard_handoff(big.nl, small.nl),
        grow=_shard_handoff(small.nl, big.nl),
    )


def _shard_handoff(nl_in: int, nl_out: int):
    """The per-rank resize of ``nl_in`` rows to ``nl_out``: the
    single-device slice or zero pad, on this rank's rows alone."""
    if nl_out <= nl_in:
        return functools.partial(shrink_state, cap=nl_out)
    return functools.partial(grow_state, n_big=nl_out)


def shrink_state(state: FilterState, cap: int) -> FilterState:
    """BIG -> SMALL: exact prefix slice (the active particles occupy slots
    [0, count) after the KLD resample).  Copies, so the BIG arrays free."""
    return state.replace(
        particles=state.particles[:cap].clone(),
        prev_particles=state.prev_particles[:cap].clone(),
        weights=state.weights[:cap].clone(),
    )


def grow_state(state: FilterState, n_big: int) -> FilterState:
    """SMALL -> BIG: zero-pad the inactive tail."""
    pad = n_big - state.particles.shape[0]
    return state.replace(
        particles=F.pad(state.particles, (0, 0, 0, pad)),
        prev_particles=F.pad(state.prev_particles, (0, 0, 0, pad)),
        weights=F.pad(state.weights, (0, pad)),
    )


def next_stage(
    in_small: bool,
    counts,
    p_rand,
    mass,
    cap: int,
    shrink_margin: float = 0.9,
    escalate_p_random: float = 1e-6,
    shrink_mass: float = 0.6,
    escalate_mass: float = 0.35,
) -> bool:
    """The stage-switch policy over a chunk's StepInfo scalars (host
    arrays); returns the next in_small."""
    counts = np.atleast_1d(np.asarray(counts))
    p_rand = np.atleast_1d(np.asarray(p_rand))
    mass = np.atleast_1d(np.asarray(mass))
    if in_small:
        return not (
            counts.max() >= cap
            or p_rand.max() > escalate_p_random
            or mass.min() < escalate_mass
        )
    # never shrink mid-recovery or without a dominant mode
    return bool(
        counts.max() <= int(shrink_margin * cap)
        and p_rand.max() <= escalate_p_random
        and mass.min() >= shrink_mass
    )


def _handoff_fns(model: StagedModel):
    """(shrink, grow, the SMALL program's rows on this rank) of ``model``:
    the factory-installed per-rank callables, else the slice and pad to
    the programs' rows, a distributed program's ``nl`` (JAX's global
    shape is the whole state, the rank's is 1 / D of it)."""
    small_rows = getattr(model.small, "nl", state_size(model.small_config))
    big_rows = getattr(model.big, "nl", state_size(model.config))
    shrink = model.shrink or functools.partial(shrink_state, cap=small_rows)
    grow = model.grow or functools.partial(grow_state, n_big=big_rows)
    return shrink, grow, small_rows


class StagedRun(NamedTuple):
    state: FilterState
    infos: StepInfo        # stacked over all T scans
    modes: np.ndarray      # (T,) 0 = big program, 1 = small program
    switches: int


def warmup_staged(model: StagedModel, state: FilterState, ranges_seq,
                  angles, deltas, chunk: int = 16) -> None:
    """Run one throwaway chunk of each program for every chunk length
    ``run_staged`` will dispatch (the ``chunk``-scan body and the final
    remainder), and the shrink-then-grow hand-off, before a timed run: the
    staged twin of ``eval/runner.py::run_filter_on_bag``'s warmup.  On the
    card that is the kernels' build and load at first use
    (``ops/_cuda.py``), the capture of each capturable program's step in a
    CUDA graph (``filter/captured.py``; the counterpart of JAX's compile),
    cuBLAS's initialization and the allocator's pools.  The throwaway runs
    work on copies of ``state``'s generator, so the state, its random
    stream and a run after this are as without it."""
    dev = model.grid_map.device
    ranges_seq = as_f32(ranges_seq, dev)
    deltas = as_f32(deltas, dev)
    t_total = ranges_seq.shape[0]
    sizes = {min(chunk, t_total)}
    if t_total % chunk:
        sizes.add(t_total % chunk)
    shrink, grow, _ = _handoff_fns(model)
    small_state = shrink(state)
    grow(small_state)
    for tc in sorted(sizes):
        for st, m in ((state, model.big), (small_state, model.small)):
            m.run(st.replace(key=copy_generator(state.key)),
                  ranges_seq[:tc], angles, deltas[:tc])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_staged(
    model: StagedModel,
    state: FilterState,
    ranges_seq,
    angles,
    deltas,
    chunk: int = 16,
    shrink_margin: float = 0.9,
    escalate_p_random: float = 1e-6,
    shrink_mass: float = 0.6,
    escalate_mass: float = 0.35,
) -> StagedRun:
    """Host-staged trajectory run; returns per-scan infos plus the program
    trace.  Under a mesh, ``next_stage`` reads the psum'd infos, the same
    on every rank, so every rank switches together."""
    cap = state_size(model.small_config)
    shrink, grow, small_rows = _handoff_fns(model)
    dev = model.grid_map.device
    ranges_seq = as_f32(ranges_seq, dev)
    deltas = as_f32(deltas, dev)
    t_total = ranges_seq.shape[0]
    # the rank's rows: the JAX global shape is cap, the local one cap / D
    in_small = state.particles.shape[0] == small_rows

    infos_chunks = []
    modes = np.zeros(t_total, np.int8)
    switches = 0
    t = 0
    while t < t_total:
        tc = min(chunk, t_total - t)
        m = model.small if in_small else model.big
        state, infos = m.run(state, ranges_seq[t:t + tc], angles,
                             deltas[t:t + tc])
        infos_chunks.append(infos)
        modes[t:t + tc] = 1 if in_small else 0
        # the chunk's one read on the host: the policy's three scalars
        counts, p_rand, mass = torch.stack([
            infos.count.to(torch.float64), infos.p_random.to(torch.float64),
            infos.anchor_mass.to(torch.float64)]).cpu().numpy()
        nxt = next_stage(
            in_small, counts, p_rand, mass,
            cap, shrink_margin=shrink_margin,
            escalate_p_random=escalate_p_random,
            shrink_mass=shrink_mass, escalate_mass=escalate_mass,
        )
        if nxt and not in_small:
            state = shrink(state)
            switches += 1
        elif in_small and not nxt:
            state = grow(state)
            switches += 1
        in_small = nxt
        t += tc
    return StagedRun(state=state, infos=concat_infos(infos_chunks),
                     modes=modes, switches=switches)
