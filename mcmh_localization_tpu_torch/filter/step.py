"""The filter step (port of ``mcmh_localization_tpu/filter/step.py``): all
six modes with the likelihood-field scorers (corr, and the exact "jnp" and
"pallas" scorers), the ray-cast beam model (its score field, range-table
and ray-march scorers) and the 3-D lidar (a voxel map's distance volume,
the planar pose on its 2-D navigation slice).

One scan is ``_predict`` (odometry proposal, with rejection retries under
motion_validity="reject") then ``_correct`` (score the proposed and
previous sets in one call, MH, augmented-MCL bookkeeping, anchor refresh,
estimate, the optionally ESS-gated resample: KLD, "simple" or "lvr" in the
adaptive modes, systematic otherwise).

The JAX program's data-dependent choices stay on the device: the corr
and beam fields' window origin is a tensor (``_window_origin``) that the
field builds and the lookups read from device memory, the beam field's
LUT matrix is sized by the table's bins alone (``ops/bin_lut.py``), and
the injection ``lax.cond`` (:529), the ESS gate's ``while_loop`` (:748),
the KLD escalation (resampling.py:464) and the coarse builds' escapee
gates go through ``ops/graph.py::run_if``: conditional nodes in a captured
step, host ``if``s in an eager one.  On the card, ``FilterModel.run``
replays a step captured in a CUDA graph for every config
(``filter/captured.py::graph_capturable``; the JAX ``lax.scan`` of
step.py:872-882 compiles the trajectory once); ``run_eager`` is its plain
version, the Python loop of eager steps, which every CPU run takes.

Random draws: each scan's draws come from the state's generator, or from
an optional ``Draws`` record (so a test can hand in the JAX draws).  The
resampler's draws are all made at static shapes before its gates
(``_resample_draws``), as the JAX key is split whether a branch runs or
not, so an eager step and a replay of the captured one use the stream
alike.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from mcmh_localization_tpu_torch.filter.captured import graph_capturable
from mcmh_localization_tpu_torch.filter.estimate import (
    PoseEstimate,
    cluster_mass,
    estimate_pose,
    estimate_pose_cluster,
    row_at,
)
from mcmh_localization_tpu_torch.filter.init import (
    init_gaussian,
    init_uniform,
    uniform_draws,
)
from mcmh_localization_tpu_torch.filter.mh import asymmetric_mh, symmetric_mh
from mcmh_localization_tpu_torch.filter.state import (
    FilterState,
    make_generator,
    make_state,
)
from mcmh_localization_tpu_torch.models.corr_field import correlation_field_scores
from mcmh_localization_tpu_torch.models.motion import (
    invert_delta,
    motion_density,
    sample_motion,
)
from mcmh_localization_tpu_torch.models.range_table import (
    beam_field_scores,
    build_range_table,
    make_beam_tables,
    raycast_table_scores,
    table_cell_major,
)
from mcmh_localization_tpu_torch.models.sensor3d import (
    lidar3d_scores,
    lidar3d_table,
)
from mcmh_localization_tpu_torch.models.sensor import (
    likelihood_field_scores,
    log_likelihood_field,
    raycast_beam_scores,
    wrap_score_with_validity,
)
from mcmh_localization_tpu_torch.ops.graph import run_if
from mcmh_localization_tpu_torch.ops.resampling import (
    effective_sample_size,
    kld_noise_rows,
    kld_resample,
    multinomial_resample_indices,
    softmax_weights,
    systematic_resample_particles,
)
from mcmh_localization_tpu_torch.ops.scan_scores import table_levels
from mcmh_localization_tpu_torch.utils.angles import (
    normalize_angle,
    normalize_angle_about,
)
from mcmh_localization_tpu_torch.utils import profiling
from mcmh_localization_tpu_torch.utils.f32 import scalar


class StepInfo(NamedTuple):
    """Per-scan observability record (fields as the JAX StepInfo)."""

    estimate: PoseEstimate
    ess: torch.Tensor
    accept_rate: torch.Tensor
    count: torch.Tensor
    p_random: torch.Tensor
    w_slow: torch.Tensor
    w_fast: torch.Tensor
    anchor_mass: torch.Tensor

    def replace(self, **kw) -> "StepInfo":
        """A copy with the given fields (JAX's flax ``.replace``)."""
        return self._replace(**kw)


@dataclasses.dataclass
class Draws:
    """One scan's random draws; a field left None is drawn from the
    state's generator.  Shapes (n = n_max):

    motion (n, 3) normals, or (motion_retries, n, 3) under
    motion_validity="reject"; mh_u (n,) uniforms; kld_r () uniform;
    kld_noise / kld_noise_tail: see ops/resampling.py::kld_resample;
    inject_cells / inject_jitter / inject_theta: see filter/init.py::
    init_uniform (the injected or, for "simple" and "lvr", the candidate
    random particles); resample_r () uniform, the systematic offset of the
    systematic and "lvr" resamplers; multinomial_u (n,) uniforms of the
    "simple" resampler; lvr_coins (n,) uniforms of the "lvr" replacement
    coins."""

    motion: torch.Tensor | None = None
    mh_u: torch.Tensor | None = None
    kld_r: torch.Tensor | None = None
    kld_noise: torch.Tensor | None = None
    kld_noise_tail: torch.Tensor | None = None
    inject_cells: torch.Tensor | None = None
    inject_jitter: torch.Tensor | None = None
    inject_theta: torch.Tensor | None = None
    resample_r: torch.Tensor | None = None
    multinomial_u: torch.Tensor | None = None
    lvr_coins: torch.Tensor | None = None


def as_f32(x, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor, array or list."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


def state_size(config) -> int:
    """Static particle-array size for a config."""
    return config.max_particles if config.use_adaptive else config.num_particles


def empty_infos(device, batch: tuple = ()) -> StepInfo:
    """The StepInfo of a zero-scan trajectory: each field (0, *batch, ...)
    with one step's dtype and trailing shape (count int32, the rest
    float32), as JAX's ``lax.scan`` returns for a length-0 trajectory."""
    f32 = dict(dtype=torch.float32, device=device)
    lead = (0, *batch)
    return StepInfo(
        estimate=PoseEstimate(mean=torch.zeros((*lead, 3), **f32),
                              cov=torch.zeros((*lead, 3, 3), **f32)),
        count=torch.zeros(lead, dtype=torch.int32, device=device),
        **{f: torch.zeros(lead, **f32) for f in StepInfo._fields
           if f not in ("estimate", "count")})


def stack_infos(infos: list, device=None, batch: tuple = ()) -> StepInfo:
    """Stack per-scan StepInfos along a new leading axis; no StepInfos
    give ``empty_infos(device, batch)``."""
    if not infos:
        return empty_infos(device, batch)
    return StepInfo(
        estimate=PoseEstimate(
            mean=torch.stack([i.estimate.mean for i in infos]),
            cov=torch.stack([i.estimate.cov for i in infos]),
        ),
        **{f: torch.stack([getattr(i, f) for i in infos])
           for f in StepInfo._fields if f != "estimate"},
    )


def concat_infos(chunks: list, device=None, batch: tuple = ()) -> StepInfo:
    """Concatenate stacked StepInfos along the scan axis; no chunks give
    ``empty_infos(device, batch)``."""
    if not chunks:
        return empty_infos(device, batch)
    return StepInfo(
        estimate=PoseEstimate(
            mean=torch.cat([c.estimate.mean for c in chunks]),
            cov=torch.cat([c.estimate.cov for c in chunks]),
        ),
        **{f: torch.cat([getattr(c, f) for c in chunks])
           for f in StepInfo._fields if f != "estimate"},
    )


# ---------------------------------------------------------------------------
# predict (odom) step
# ---------------------------------------------------------------------------

def advance_anchor(anchor: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Noise-free rot1/trans/rot2 odometry applied to the anchor pose."""
    th1 = anchor[2] + delta[0]
    x = anchor[0] + delta[1] * torch.cos(th1)
    y = anchor[1] + delta[1] * torch.sin(th1)
    return torch.stack([x, y, normalize_angle(th1 + delta[2])]).to(torch.float32)


def _predict(state: FilterState, delta: torch.Tensor, grid_map, config,
             draws: Draws | None = None) -> FilterState:
    """Motion proposal (move_particles, amcmh_localizer.py:384-408): the
    raw draw under motion_validity="score", else ``motion_retries`` draws
    checked against the map."""
    delta = torch.as_tensor(delta, dtype=torch.float32, device=state.device)
    proposed = sample_motion(
        state.particles, delta, config.alpha,
        noise=draws.motion if draws is not None else None,
        generator=state.key, grid_map=grid_map,
        retries=(0 if config.motion_validity == "score"
                 else config.motion_retries),
    )
    return state.replace(
        prev_particles=state.particles,
        particles=proposed,
        delta=delta,
        anchor=advance_anchor(state.anchor, delta),
    )


# ---------------------------------------------------------------------------
# correct (scan) step
# ---------------------------------------------------------------------------

# the corr field pays a particle-independent build; below this state size
# the exact scorer is cheaper (the JAX package's TPU rule, step.py:118-128)
AUTO_CORR_MIN_STATE = 8192


def _resolved_likelihood_impl(config, device) -> str:
    """``likelihood_impl`` with "auto" resolved: "corr" on a CUDA device at
    ``state_size >= 8192``, the exact "jnp" scorer otherwise (the JAX rule
    with the card in the TPU's place; off the accelerator both pick "jnp")."""
    impl = config.likelihood_impl
    if impl == "auto":
        big = state_size(config) >= AUTO_CORR_MIN_STATE
        impl = "corr" if (torch.device(device).type == "cuda" and big) else "jnp"
    return impl


def _resolved_beam_impl(config, device) -> str:
    """``beam_impl`` with "auto" resolved: on a CUDA device the score
    "field" when a window is set, else the range "table"; off the card the
    "dense" ray march (the JAX rule, step.py:131-148, with the card in the
    TPU's place)."""
    impl = config.beam_impl
    if impl == "auto":
        if torch.device(device).type == "cuda":
            impl = "field" if config.corr_window_cells else "table"
        else:
            impl = "dense"
    if impl == "field" and not config.corr_window_cells:
        raise ValueError(
            "beam_impl='field' requires corr_window_cells > 0 (the beam "
            "score field is built over the particle-cloud window)")
    return impl


def _resolved_impl(config, device) -> str:
    """The scorer a config runs on ``device``: "lidar3d", the resolved beam
    impl or the resolved likelihood-field impl."""
    if config.sensor_model == "lidar3d":
        return "lidar3d"
    if config.sensor_model == "beam":
        return _resolved_beam_impl(config, device)
    return _resolved_likelihood_impl(config, device)


def _make_scorer(ranges, angles, grid_map, table, config, impl,
                 window_origin, shard_group=None):
    """The scorer for the resolved ``impl`` on the sensor ``table``
    (``_sensor_table``): the 3-D lidar's (``angles`` (M, 2): azimuth and
    elevation); the beam score field (with the window origin), the
    range-table or ray-march beam scorer; corr (with the window origin,
    when windowed) or the exact scorer in the "jnp" (divide) or "pallas"
    (multiply) cell form.  ``shard_group``: the process group over which
    the corr and beam fields build their theta bins
    (``parallel/distributed.py``)."""
    if impl == "lidar3d":
        def score(p):
            return lidar3d_scores(p, ranges, angles, table.voxel_map, config,
                                  sensor_z=config.lidar3d_sensor_z,
                                  log_volume=table.levels)
        return score
    if impl == "field":
        def score(p):
            return beam_field_scores(p, ranges, angles, grid_map, config,
                                     table, config.beam_table_n_theta,
                                     window_origin,
                                     shard_bins_axis=shard_group)
        return score
    if impl == "table":
        def score(p):
            return raycast_table_scores(p, ranges, angles, grid_map, config,
                                        table, config.beam_table_n_theta)
        return score
    if impl == "dense":
        # config.step subsampling here (the ray-march scorer takes no
        # config), so every beam impl scores the same beams
        r = ranges[:: config.step] if config.step > 1 else ranges
        a = angles[:: config.step] if config.step > 1 else angles

        def score(p):
            return raycast_beam_scores(
                p, r, a, grid_map, sigma_hit=config.sigma_hit,
                z_hit=config.z_hit, z_rand=config.z_rand,
                max_range=config.max_range,
                aggregation=config.score_aggregation)
        return score
    if impl == "corr":
        def score(p):
            return correlation_field_scores(
                p, ranges, angles, grid_map, config, log_field=table,
                n_theta=config.corr_n_theta, window_origin=window_origin,
                shard_bins_axis=shard_group)
        return score

    def score(p):
        return likelihood_field_scores(p, ranges, angles, grid_map, config,
                                       log_field=table,
                                       cell_div=impl == "jnp")
    return score


def _anchor_center(state: FilterState, config):
    """(cx, cy, heading) of an anchor-centred window: the anchor, its
    heading backed off half the scan's rotation under MH."""
    mean_t = state.anchor[2]
    if config.use_mh:
        mean_t = normalize_angle(
            mean_t - 0.5 * (state.delta[0] + state.delta[2]))
    return state.anchor[0], state.anchor[1], mean_t


def window_origin_at(cx, cy, mean_t, grid_map, config,
                     n_theta: int | None = None) -> torch.Tensor:
    """(3,) int32 (oy0, ox0, kstart) of the window centred on the 0-d
    tensors (cx, cy): the lower-left cell clamped to ``[0, h - win]`` x
    ``[0, w - win]`` as the JAX scorer clamps it (corr_field.py:378-380),
    and the first bin of the theta window around ``mean_t`` (0 without a
    theta window, where ``mean_t`` may be None).  Nothing is read on the
    host."""
    win = config.corr_window_cells
    half = win // 2
    ox0 = ((cx - grid_map.origin[0]) * grid_map.inv_res).to(torch.int32) - half
    oy0 = ((cy - grid_map.origin[1]) * grid_map.inv_res).to(torch.int32) - half
    oy0 = oy0.clamp(0, max(grid_map.height - win, 0))
    ox0 = ox0.clamp(0, max(grid_map.width - win, 0))
    if not config.corr_theta_window_bins:
        return torch.stack([oy0, ox0, torch.zeros_like(oy0)])
    k = n_theta if n_theta is not None else config.corr_n_theta
    kmid = ((mean_t + math.pi) * (k / (2.0 * math.pi))).to(torch.int32) % k
    kstart = (kmid - config.corr_theta_window_bins // 2) % k
    return torch.stack([oy0, ox0, kstart.to(torch.int32)])


def _window_origin(state: FilterState, grid_map, config,
                   n_theta: int | None = None) -> torch.Tensor:
    """(3,) int32 (oy0, ox0, kstart) on the state's device: the field
    window centred on the anchor (window_center="anchor") or the active
    cloud's mean (``window_origin_at``); see the JAX docstring
    (step.py:231-263).  The corr and beam fields read it from device
    memory: nothing is read on the host."""
    mask = state.active_mask
    if config.window_center == "anchor":
        return window_origin_at(*_anchor_center(state, config), grid_map,
                                config, n_theta)
    n = torch.clamp(mask.sum(), min=1)
    cx = torch.where(mask, state.particles[:, 0], 0.0).sum() / n
    cy = torch.where(mask, state.particles[:, 1], 0.0).sum() / n
    mean_t = None
    if config.corr_theta_window_bins:
        sets = ((state.particles, state.prev_particles) if config.use_mh
                else (state.particles,))
        c = sum(torch.where(mask, torch.cos(p[:, 2]), 0.0).sum() for p in sets)
        s = sum(torch.where(mask, torch.sin(p[:, 2]), 0.0).sum() for p in sets)
        mean_t = torch.atan2(s, c)
    return window_origin_at(cx, cy, mean_t, grid_map, config, n_theta)


def refresh_anchor(particles, weights, anchor, streak, config, mask,
                   score_scale=1.0):
    """Cluster-mass-gated, debounced window-anchor update; returns
    (anchor, anchor_mass, streak).  See the JAX docstring (step.py:307)."""
    w = torch.where(mask, weights, 0.0)
    top = torch.argmax(w)
    cand = row_at(particles, top).to(torch.float32)
    rxy, rth = config.cluster_radius_xy, config.cluster_radius_theta
    m_cand = cluster_mass(particles, w, cand, rxy, rth)
    m_cur = cluster_mass(particles, w, anchor, rxy, rth)
    d_xy = torch.hypot(cand[0] - anchor[0], cand[1] - anchor[1])
    d_th = torch.abs(normalize_angle_about(cand[2], anchor[2]))
    same_mode = (d_xy <= rxy) & (d_th <= rth)
    migrate = m_cand > config.anchor_hysteresis * m_cur
    if config.anchor_score_margin > 0.0:
        d2 = ((particles[:, 0] - anchor[0]) ** 2
              + (particles[:, 1] - anchor[1]) ** 2)
        inc = (d2 <= rxy ** 2) & (
            torch.abs(normalize_angle_about(particles[:, 2], anchor[2])) <= rth)
        w_inc_top = torch.where(inc, w, 0.0).max()
        w_cand_top = row_at(w, top)
        migrate = migrate & (
            w_inc_top < w_cand_top * torch.exp(
                torch.as_tensor(-config.anchor_score_margin * score_scale)))
    challenge = migrate & ~same_mode
    streak = torch.where(challenge, streak + 1, 0).to(torch.int32)
    migrate = migrate & (streak >= config.anchor_commit_scans)
    adopt = same_mode | migrate
    streak = torch.where(migrate, 0, streak).to(torch.int32)
    return (
        torch.where(adopt, cand, anchor).to(torch.float32),
        torch.where(adopt, m_cand, m_cur),
        streak,
    )


def _transition_probabilities(state: FilterState, config):
    fwd = motion_density(state.prev_particles, state.particles, state.delta,
                         config.alpha)
    bwd_delta = invert_delta(state.delta,
                             ref_compat=config.ref_compat_backward_delta)
    bwd = motion_density(state.particles, state.prev_particles, bwd_delta,
                         config.alpha)
    return fwd, bwd


def _p_random(state: FilterState, config) -> torch.Tensor:
    p = torch.clamp(1.0 - state.w_fast / (state.w_slow + 1e-9), min=0.0)
    return torch.where(p >= config.min_injection_prob, p, 0.0)


def _uniform_weights(state: FilterState) -> torch.Tensor:
    return torch.where(state.active_mask,
                       1.0 / torch.clamp(state.count, min=1), 0.0
                       ).to(torch.float32)


def _resample_systematic(state: FilterState, grid_map, config, d: Draws):
    """Non-adaptive path (resample_lvr, amcmh_localizer.py:488-492):
    systematic resampling to the fixed count; the weights stay, except
    under the ESS-gated carry-over, where they reset to uniform."""
    resampled = systematic_resample_particles(
        state.particles, state.weights, state.n_max, count=state.count,
        r=d.resample_r, generator=state.key)
    zero = scalar(0.0, state.device)
    if config.resample_ess_threshold < 1.0:
        return (state.replace(particles=resampled,
                              weights=_uniform_weights(state)), zero)
    return state.replace(particles=resampled), zero


def _candidates(state: FilterState, grid_map, d: Draws) -> torch.Tensor:
    return init_uniform(state.n_max, grid_map, generator=state.key,
                        cells=d.inject_cells, jitter=d.inject_jitter,
                        theta=d.inject_theta)


def _resample_amcl_simple(state: FilterState, grid_map, config, d: Draws):
    """Adaptive 'simple' (resample_amcl_simple, amcmh_localizer.py:444-458):
    multinomial resampling of N - N_random slots, N_random fresh uniform
    particles; count unchanged; uniform weights."""
    n = state.count
    p_random = _p_random(state, config)
    n_random = (p_random * n.to(torch.float32)).to(torch.int32)
    idx = multinomial_resample_indices(state.weights, state.n_max,
                                       u=d.multinomial_u, generator=state.key)
    randoms = _candidates(state, grid_map, d)
    slot = torch.arange(state.n_max, device=state.device)
    particles = torch.where((slot < n - n_random)[:, None],
                            state.particles[idx.to(torch.int64)], randoms)
    return (state.replace(particles=particles,
                          weights=_uniform_weights(state)), p_random)


def _resample_amcl_lvr(state: FilterState, grid_map, config, d: Draws):
    """Adaptive 'lvr' (resample_amcl_lvr, amcmh_localizer.py:460-479):
    systematic resampling, each slot replaced by a fresh uniform particle
    with probability p_random; count unchanged; uniform weights."""
    p_random = _p_random(state, config)
    resampled = systematic_resample_particles(
        state.particles, state.weights, state.n_max, count=state.count,
        r=d.resample_r, generator=state.key)
    randoms = _candidates(state, grid_map, d)
    coins = d.lvr_coins
    if coins is None:
        coins = torch.rand((state.n_max,), generator=state.key,
                           device=state.device)
    particles = torch.where((coins < p_random)[:, None], randoms, resampled)
    return (state.replace(particles=particles,
                          weights=_uniform_weights(state)), p_random)


def _resample_kld(state: FilterState, grid_map, config, d: Draws):
    """Augmented-MCL injection + KLD-sized systematic resampling
    (resample_amcl_kld, amcmh_localizer.py:496-527).  The injection is
    ``run_if`` on ``n_random > 0`` (the JAX ``lax.cond``, step.py:529); its
    randoms come drawn at static shape on every resampling scan
    (``_resample_draws``)."""
    n = state.count
    n_max = state.n_max
    dev = state.device
    p_random = _p_random(state, config)
    n_drop = (p_random * n.to(torch.float32)).to(torch.int32)
    n_resampled = n - n_drop
    if config.injection_refill:
        n_random = (p_random * float(n_max)).to(torch.int32)
    else:
        n_random = n_drop
    samples, n_kept = kld_resample(
        state.particles, state.weights,
        max_samples=n_max,
        min_particles=config.min_particles,
        bin_size_xy=config.kld_bin_size_xy,
        bin_size_theta=config.kld_bin_size_theta,
        epsilon=config.kld_epsilon,
        z=config.kld_z,
        count=n_resampled,
        eval_window=config.kld_eval_window,
        stop_rule=("new_bin" if config.ref_compat_kld_newbin_stop
                   else "every_sample"),
        r=d.kld_r, noise=d.kld_noise, noise_tail=d.kld_noise_tail,
        generator=state.key,
    )
    n_kept = torch.minimum(n_kept, n_resampled)

    def inject():
        # injected randoms take the FIRST slots (reference order); the kept
        # samples shift behind them: the roll by the device-held n_random
        randoms = init_uniform(n_max, grid_map, generator=state.key,
                               cells=d.inject_cells, jitter=d.inject_jitter,
                               theta=d.inject_theta)
        slot = torch.arange(n_max, device=dev)
        shifted = samples[(slot - n_random) % n_max]
        return [torch.where((slot < n_random)[:, None], randoms, shifted)]

    (particles,) = run_if(n_random > 0, inject, [samples], donate=True)
    new_count = torch.clamp(n_random + n_kept, config.min_particles,
                            n_max).to(torch.int32)
    mask = torch.arange(n_max, device=dev) < new_count
    weights = torch.where(mask, 1.0 / new_count.to(torch.float32), 0.0)
    return (state.replace(particles=particles, weights=weights,
                          count=new_count), p_random)


def _resample_draws(state: FilterState, grid_map, config, d: Draws,
                    min_particles: int | None = None,
                    eval_window: int | None = None) -> Draws:
    """``d`` with every draw the config's resampler can use, at static
    shapes: the fields left None are drawn from the state's generator, in
    the order the resamplers take them (the systematic offset or the KLD
    offset, jitter normals and escalation tail; the multinomial uniforms;
    the uniform candidates; the "lvr" coins).  The step makes them before
    the ESS gate, the KLD escalation and the injection, so the stream
    moves by the same draws whichever branches run, in a replay (which
    draws what it captured) as in an eager step, as the JAX key is split
    whether a branch runs or not.  ``min_particles`` and ``eval_window``
    (the config's by default) size the KLD draw: the multi-device
    filter's island passes its own (``parallel/distributed.py``)."""
    n = state.n_max
    if min_particles is None:
        min_particles = config.min_particles
    if eval_window is None:
        eval_window = config.kld_eval_window
    dev = state.device
    gen = state.key
    fill = {}

    def need(name):
        return getattr(d, name) is None

    def uniform(name, shape):
        if need(name):
            fill[name] = torch.rand(shape, generator=gen, device=dev)

    if not config.use_adaptive:
        uniform("resample_r", ())
        return dataclasses.replace(d, **fill)
    kind = config.adaptive_resampler
    if kind == "kld":
        uniform("kld_r", ())
        rows, tail = kld_noise_rows(n, min_particles, eval_window)
        for name, k in (("kld_noise", rows), ("kld_noise_tail", tail)):
            if k and need(name):
                fill[name] = torch.randn((k, 3), generator=gen, device=dev,
                                         dtype=state.particles.dtype)
    elif kind == "simple":
        uniform("multinomial_u", (n,))
    else:
        uniform("resample_r", ())
    if need("inject_cells") or need("inject_jitter") or need("inject_theta"):
        drawn = uniform_draws(n, grid_map, gen)
        for name, x in zip(("inject_cells", "inject_jitter", "inject_theta"),
                           drawn):
            if need(name):
                fill[name] = x
    if kind == "lvr":
        uniform("lvr_coins", (n,))
    return dataclasses.replace(d, **fill)


def _beam_count(ranges: torch.Tensor, config) -> torch.Tensor:
    sig = ranges[:: config.step] if config.step > 1 else ranges
    return (torch.isfinite(sig) & (sig < config.max_range)).sum()


def _correct(state: FilterState, ranges: torch.Tensor, angles: torch.Tensor,
             grid_map, log_field: torch.Tensor, config,
             draws: Draws | None = None):
    """Measurement update (lidar_callback, amcmh_localizer.py:294-338).
    Under a stage clock (``utils/profiling.py``) it stamps the stages
    ``score``, ``mh``, ``estimate`` and ``resample``: stamps make no draws
    and change no value."""
    profiling.stamp("begin")
    d = draws if draws is not None else Draws()
    mask = state.active_mask
    impl = _resolved_impl(config, state.device)
    field = impl in ("corr", "field")
    wo = (_window_origin(state, grid_map, config,
                         n_theta=(config.beam_table_n_theta
                                  if impl == "field" else None))
          if config.corr_window_cells and field else None)
    score = _make_scorer(ranges, angles, grid_map, log_field, config, impl, wo)
    if config.motion_validity == "score" and not field:
        # the corr and beam fields fold the penalty into their builds; the
        # other scorers (exact, beam table and dense, lidar3d) take the
        # explicit wrap (JAX step.py:581-593)
        score = wrap_score_with_validity(score, grid_map, config, ranges)

    # inactive slots collapse onto slot 0 (always active) before scoring
    anchor = state.particles[0]
    p_sc = torch.where(mask[:, None], state.particles, anchor)
    carry_on = config.resample_ess_threshold < 1.0
    log_carry = (torch.log(torch.clamp(state.weights, min=1e-30))
                 if carry_on else 0.0)
    if config.use_mh:
        n_max = state.n_max
        prev_sc = torch.where(mask[:, None], state.prev_particles, anchor)
        s_both = score(torch.cat([p_sc, prev_sc]))  # one field build
        profiling.stamp("score")
        s_post = s_both[:n_max]
        weights_post = softmax_weights(s_post + log_carry, mask)
        weights_pre = softmax_weights(s_both[n_max:] + log_carry, mask)
        if config.asymmetric:
            fwd, bwd = _transition_probabilities(state, config)
            particles, weights, accepted = asymmetric_mh(
                state.prev_particles, state.particles, weights_post,
                weights_pre, fwd, bwd,
                ref_compat_guard=config.ref_compat_assym_guard,
                u=d.mh_u, generator=state.key)
        else:
            particles, weights, accepted = symmetric_mh(
                state.prev_particles, state.particles, weights_post,
                weights_pre, u=d.mh_u, generator=state.key)
        accept_rate = (torch.where(mask, accepted, False).sum()
                       / torch.clamp(state.count, min=1))
        state = state.replace(particles=particles)
    else:
        s_post = score(p_sc)
        profiling.stamp("score")
        weights = softmax_weights(s_post + log_carry, mask)
        accept_rate = scalar(1.0, state.device)
    profiling.stamp("mh")

    # -- augmented-MCL bookkeeping (update_acml_weights, :276-286)
    weights = torch.where(mask, weights, 0.0)
    weights = weights / torch.clamp(weights.sum(), min=1e-30)
    if config.use_adaptive:
        if config.ref_compat_w_avg:
            w_avg = weights.sum() / torch.clamp(state.count, min=1)
        else:
            # per-beam geometric-mean likelihood of the current set
            per_beam = (s_post / torch.clamp(_beam_count(ranges, config), min=1)
                        if config.score_aggregation == "sum" else s_post)
            w_avg = (torch.where(mask, torch.exp(per_beam), 0.0).sum()
                     / torch.clamp(state.count, min=1))
        state = state.replace(
            w_slow=state.w_slow + config.alpha_slow * (w_avg - state.w_slow),
            w_fast=state.w_fast + config.alpha_fast * (w_avg - state.w_fast),
        )
    state = state.replace(weights=weights)

    # -- window anchor refresh on the pre-resample weights
    scale = (torch.clamp(_beam_count(ranges, config), min=1).to(torch.float32)
             if config.score_aggregation == "sum" else 1.0)
    new_anchor, anchor_mass, new_streak = refresh_anchor(
        state.particles, state.weights, state.anchor, state.anchor_streak,
        config, mask, score_scale=scale)
    state = state.replace(anchor=new_anchor, anchor_streak=new_streak)

    # -- estimate before resampling (:327)
    if config.estimate_mode in ("cluster", "anchor"):
        est = estimate_pose_cluster(
            state.particles, state.weights, mask,
            radius_xy=config.cluster_radius_xy,
            radius_theta=config.cluster_radius_theta,
            anchor=state.anchor if config.estimate_mode == "anchor" else None)
    else:
        est = estimate_pose(state.particles, state.weights, mask)
    ess = effective_sample_size(state.weights)
    profiling.stamp("estimate")

    # -- resample, ESS-gated when the threshold is below 1 (run_if in
    # place of the JAX 0/1-iteration while_loop, step.py:748)
    if config.use_adaptive:
        resample = {"kld": _resample_kld, "simple": _resample_amcl_simple,
                    "lvr": _resample_amcl_lvr}[config.adaptive_resampler]
    else:
        resample = _resample_systematic
    d = _resample_draws(state, grid_map, config, d)
    if carry_on:
        need = ess < config.resample_ess_threshold * state.count.to(torch.float32)
        if config.use_adaptive:
            need = need | (_p_random(state, config) > 0)
        fields = ("particles", "weights", "count")

        def gated():
            st, p = resample(state, grid_map, config, d)
            return [getattr(st, f) for f in fields] + [p]

        # the carry is donated: the pre-resample set is read by nothing
        # after the gate (the count is the step's input, so a copy)
        *new, p_random = run_if(
            need, gated, [state.particles, state.weights, state.count.clone(),
                          scalar(0.0, state.device)], donate=True)
        state = state.replace(**dict(zip(fields, new)))
    else:
        state, p_random = resample(state, grid_map, config, d)
    profiling.stamp("resample")

    info = StepInfo(
        estimate=est, ess=ess, accept_rate=accept_rate, count=state.count,
        p_random=p_random, w_slow=state.w_slow, w_fast=state.w_fast,
        anchor_mass=anchor_mass,
    )
    return state, info


# ---------------------------------------------------------------------------
# public factory
# ---------------------------------------------------------------------------

def _sensor_table(grid_map, config, voxel_map=None):
    """The per-(map, config) sensor precompute (JAX step.py:786-816): the
    voxel map and its log-mixture volume (3-D lidar), the BeamTables of the
    beam score field, the cell-major range table of the beam "table"
    scorer (each of the last two scorers' tables in the form its kernel
    reads, ``ops/scan_scores.py::table_levels``), or the log-likelihood
    field."""
    if config.sensor_model == "lidar3d":
        if voxel_map is None:
            raise ValueError(
                "sensor_model='lidar3d' requires make_step/make_model("
                "..., voxel_map=VoxelMap); grid_map stays the 2-D "
                "navigation slice (maps/voxel_map.py::nav_slice)")
        return lidar3d_table(voxel_map, config)
    if config.sensor_model == "beam":
        impl = _resolved_beam_impl(config, grid_map.device)
        if impl == "field":
            return make_beam_tables(grid_map, config)
        if impl == "table":
            # the poses a scan scores: the proposed and previous sets under MH
            poses = state_size(config) * (2 if config.use_mh else 1)
            return table_levels(table_cell_major(build_range_table(
                grid_map, config.beam_table_n_theta, config.max_range)),
                poses)
    return log_likelihood_field(grid_map, config)


class FilterModel:
    """A config + map bound into init / predict / correct / step / run.

    ``log_field`` is the per-(map, config) sensor table (``_sensor_table``),
    built once on the map's device.  ``voxel_map`` is the 3-D lidar's map
    (None for the 2-D sensors); ``grid_map`` is then its navigation slice,
    which motion validity and injection use."""

    def __init__(self, config, grid_map, voxel_map=None):
        self.config = config
        self.grid_map = grid_map
        self.voxel_map = voxel_map
        self.log_field = _sensor_table(grid_map, config, voxel_map)
        self._graphs: dict = {}
        # the program's name: the label of its stage clock
        # (utils/profiling.py); the staged programs are "big" and "small"
        self.name = "step"

    @property
    def device(self) -> torch.device:
        return self.grid_map.device

    @property
    def replays_graph(self) -> bool:
        """True where ``run`` replays a captured step: on a CUDA device, for
        a config ``filter/captured.py::graph_capturable`` names."""
        return self.device.type == "cuda" and graph_capturable(self.config)

    def captured(self, state, beams: int, predict: bool = True):
        """The ``CapturedStep`` of this model for ``state``'s slots and
        scans of ``beams`` ranges (``predict=False``: the correct step
        alone), made at first use; it captures at its first run."""
        from mcmh_localization_tpu_torch.filter.captured import CapturedStep

        key = (state.n_max, beams, predict)
        if key not in self._graphs:
            self._graphs[key] = CapturedStep(self, state, beams, predict)
        return self._graphs[key]

    def init(self, seed: int | torch.Generator = 0, initial_pose=None,
             initial_cov=None) -> FilterState:
        """Gaussian around a pose when config.initialized (or a pose is
        given), else uniform over free space (amcmh_localizer.py:179-197)."""
        cfg = self.config
        gen = (seed if isinstance(seed, torch.Generator)
               else make_generator(seed, self.device))
        n = cfg.num_particles
        if cfg.initialized or initial_pose is not None:
            mean = initial_pose if initial_pose is not None else cfg.initial_pose
            cov = (torch.diag(torch.tensor(cfg.initial_cov, dtype=torch.float32))
                   if initial_cov is None else initial_cov)
            particles = init_gaussian(
                mean, cov, n, self.grid_map,
                ref_compat=cfg.ref_compat_gaussian_init, generator=gen)
        else:
            particles = init_uniform(n, self.grid_map, generator=gen)
        w_init = 1e-3 if cfg.ref_compat_w_init else 1.0 / n
        return make_state(particles, n, gen, state_size(cfg), w_init=w_init)

    def predict(self, state, delta, draws: Draws | None = None):
        return _predict(state, delta, self.grid_map, self.config, draws)

    def correct(self, state, ranges, angles, draws: Draws | None = None):
        return _correct(state, self._on_device(ranges),
                        self._on_device(angles), self.grid_map,
                        self.log_field, self.config, draws)

    def step(self, state, ranges, angles, delta, draws: Draws | None = None):
        return self.correct(self.predict(state, delta, draws), ranges,
                            angles, draws)

    def run(self, state, ranges_seq, angles, deltas):
        """A trajectory, one step per scan: (T, M) ranges, (M,) angles (or
        the 3-D lidar's (M, 2) directions), (T, 3) deltas -> (final state,
        stacked StepInfo).

        On a CUDA device (``replays_graph``) it runs one replay of the
        captured step per scan (``filter/captured.py``; the step is
        captured at the first run, or by ``filter/staged.py::
        warmup_staged``), bitwise the eager steps on the same generator;
        every CPU run is a Python loop of eager steps (``run_eager``).
        The choice is the device's, not a fallback."""
        if not self.replays_graph:
            return self.run_eager(state, ranges_seq, angles, deltas)
        ranges_seq = self._on_device(ranges_seq)
        return self.captured(state, ranges_seq.shape[1]).run(
            state, ranges_seq, self._on_device(angles),
            self._on_device(deltas))

    def run_eager(self, state, ranges_seq, angles, deltas):
        """``run`` as a Python loop of eager steps on any config: the
        captured run's plain version."""
        return run_steps(self, state, ranges_seq, angles, deltas)

    def _on_device(self, x) -> torch.Tensor:
        return as_f32(x, self.device)


def run_steps(model, state, ranges_seq, angles, deltas):
    """(final state, stacked StepInfo) of ``model.step`` once a scan of
    ``ranges_seq`` (T, M) and ``deltas`` (T, 3), eagerly: a ``FilterModel``'s
    or ``DistModel``'s ``run_eager``."""
    dev = model.device
    ranges_seq, angles, deltas = (as_f32(x, dev)
                                  for x in (ranges_seq, angles, deltas))
    infos = []
    for t in range(ranges_seq.shape[0]):
        state, info = model.step(state, ranges_seq[t], angles, deltas[t])
        infos.append(info)
    return state, stack_infos(infos, device=dev)


def make_model(config, grid_map, voxel_map=None) -> FilterModel:
    """The JAX ``make_model``'s parameters: ``voxel_map`` is the VoxelMap of
    sensor_model="lidar3d" (``grid_map`` then its 2-D navigation slice,
    ``maps/voxel_map.py::nav_slice``)."""
    return FilterModel(config, grid_map, voxel_map)


def make_step(config, grid_map, voxel_map=None):
    """(predict, correct, step, log_field) for a config and map (and the
    3-D lidar's ``voxel_map``): the JAX ``make_step``'s four results, as
    plain closures over one ``FilterModel`` (PyTorch runs eagerly: there is
    nothing to jit)."""
    model = make_model(config, grid_map, voxel_map)

    def predict(state, delta, draws: Draws | None = None):
        return model.predict(state, delta, draws)

    def correct(state, ranges, angles, draws: Draws | None = None):
        return model.correct(state, ranges, angles, draws)

    def step(state, ranges, angles, delta, draws: Draws | None = None):
        return model.step(state, ranges, angles, delta, draws)

    return predict, correct, step, model.log_field


def make_run(config, grid_map):
    """The trajectory runner of ``make_model(config, grid_map)``."""
    return make_model(config, grid_map).run
