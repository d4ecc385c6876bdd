"""The multi-rank filter over ``torch.distributed`` (port of
``mcmh_localization_tpu/parallel/distributed.py``).

Each rank of a 1-D mesh (``parallel/sharding.py::make_mesh``) holds one
device and ``nl = n_max / D`` rows of ``particles``, ``prev_particles``
and ``weights``: the JAX global array's addressable shard.  ``count``,
``w_slow``, ``w_fast``, ``delta``, ``anchor`` and ``anchor_streak`` are the
global values, the same on every rank, and ``count`` stays a multiple of D.

One scan of ``_dist_step`` is the JAX shard_map body:

  * the motion proposal, fully local;
  * scoring: the corr and beam score fields are built theta-sharded (each
    rank builds nbins / D bins, one tiled all_gather puts the stack back
    together: ``models/range_table.py::_sharded_bin_stack``); the exact,
    range-table, ray-march and 3-D scorers are per particle and local;
  * weight normalization, the augmented-MCL signal, the anchor refresh, the
    estimate and the ESS: scalar psum / pmax / pmin, and one (3, 3) psum;
  * per-rank ("island") resampling to one count, adopted by a pmax, with
    the island KLD's epsilon x D; then a fixed block moves one rank round
    the ring.  No collective moves O(N) particle data.

The JAX program's data-dependent choices stay on the device, as in
``filter/step.py``: the window origin is a tensor (``_dist_window_origin``)
that the corr and beam fields read from device memory, the island
injection shifts by the device-held count, and the gates (the injection,
the KLD escalation) are ``ops/graph.py::run_if``.  A rank that takes
another branch around a collective hangs the group, so every gate reads
values that are the same on every rank (psum'd sums, the replicated
scalars) or holds no collective (the island's own KLD escalation).  On an
NCCL group ``DistModel.run`` replays one captured step a scan
(``filter/captured.py``), its collectives inside the graph; on a gloo
group (the CPU) it is a loop of eager steps, where ``run_if`` is a host
``if``.

Random draws: each rank's ``FilterState.key`` is its own generator, seeded
from ``(seed, rank)`` by ``filter/state.py::split_seed`` (JAX folds the
axis index into one key); a step's ``draws`` (``filter/step.py::Draws`` at
the rank's ``nl`` shapes) replace them, so a test can feed JAX's per-shard
draws.  The resampler's draws are made at static shapes before its gates
(``filter/step.py::_resample_draws`` at the island's sizes), so a replay
and an eager step move the stream alike.

The collectives live at the top of this module and count what they move
(``collective_counts``; a captured step's count once at its capture and
again at each replay).  They act on the rank's own tensors: NCCL on cards,
gloo on the CPU.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from mcmh_localization_tpu_torch.filter.estimate import (
    PoseEstimate,
    cluster_mass,
    row_at,
)
from mcmh_localization_tpu_torch.filter.init import init_uniform
from mcmh_localization_tpu_torch.filter.mh import asymmetric_mh, symmetric_mh
from mcmh_localization_tpu_torch.filter.state import (
    FilterState,
    make_generator,
    split_seed,
)
from mcmh_localization_tpu_torch.filter.step import (
    Draws,
    StepInfo,
    _anchor_center,
    _beam_count,
    _make_scorer,
    _p_random,
    _predict,
    _resample_draws,
    _resolved_impl,
    as_f32,
    make_model,
    run_steps,
    state_size,
    window_origin_at,
)
from mcmh_localization_tpu_torch.models.motion import invert_delta, motion_density
from mcmh_localization_tpu_torch.models.sensor import wrap_score_with_validity
from mcmh_localization_tpu_torch.ops.graph import run_if
from mcmh_localization_tpu_torch.ops.resampling import (
    kld_resample,
    multinomial_resample_indices,
    systematic_resample_particles,
)
from mcmh_localization_tpu_torch.parallel.sharding import shard_state
from mcmh_localization_tpu_torch.utils.angles import normalize_angle_about
from mcmh_localization_tpu_torch.utils.f32 import scalar

# ---------------------------------------------------------------------------
# the collectives: every rank of ``group`` calls each one in the same order
# ---------------------------------------------------------------------------

# per collective: [calls, bytes moved, the most bytes one call moved]
_moved: dict[str, list[int]] = {}


def _count(name: str, nbytes: int) -> None:
    rec = _moved.setdefault(name, [0, 0, 0])
    rec[0] += 1
    rec[1] += nbytes
    rec[2] = max(rec[2], nbytes)


def collective_counts() -> dict[str, tuple[int, int, int]]:
    """(calls, bytes, largest call's bytes) per collective since the last
    reset, counting the bytes this rank puts into each call: an
    all_reduce's tensor, its share of an all_gather, its ring block."""
    return {k: tuple(v) for k, v in _moved.items()}


def reset_collective_counts() -> None:
    _moved.clear()


@contextlib.contextmanager
def collectives_tallied():
    """Count the collectives called inside into a tally of their own,
    which it yields, and not into ``collective_counts``: a captured step's
    (``filter/captured.py``), which each replay adds (``add_collectives``)."""
    global _moved
    outer, _moved = _moved, {}
    try:
        yield _moved
    finally:
        _moved = outer


def add_collectives(tally: dict, times: int = 1) -> None:
    """Add ``times`` replays of a captured step's ``tally``."""
    for name, (calls, nbytes, most) in tally.items():
        rec = _moved.setdefault(name, [0, 0, 0])
        rec[0] += calls * times
        rec[1] += nbytes * times
        rec[2] = max(rec[2], most)


def axis_size(group) -> int:
    return dist.get_world_size(group)


def axis_index(group) -> int:
    """This rank's index within ``group``."""
    return dist.get_rank(group)


def _all_reduce(x: torch.Tensor, op, group, name: str) -> torch.Tensor:
    _count(name, x.numel() * x.element_size())
    dist.all_reduce(x, op=op, group=group)
    return x


# psum, pmax and pmin reduce ``x`` in place and return it: every caller
# passes a fresh temporary (a reduction's result, a stack, a where)

def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks."""
    return _all_reduce(x, dist.ReduceOp.SUM, group, "psum")


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.MAX, group, "pmax")


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.MIN, group, "pmin")


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    _count("all_gather", x.numel() * x.element_size())
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def ppermute_ring(x: torch.Tensor, group) -> torch.Tensor:
    """The ring shift: rank r sends ``x`` to rank (r + 1) % D and returns
    what rank (r - 1) % D sent."""
    d, r = axis_size(group), axis_index(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    _count("ppermute", x.numel() * x.element_size())
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + 1) % d),
                      group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - 1) % d), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# ---------------------------------------------------------------------------
# collective-aware numerics (filter/step.py's single-device versions with
# psum / pmax reductions)
# ---------------------------------------------------------------------------

def softmax_weights_dist(scores, mask, group) -> torch.Tensor:
    """Globally normalized softmax over the ranks' scores
    (``ops/resampling.py::softmax_weights`` with pmax and psum)."""
    scores = torch.where(mask, scores, -torch.inf)
    m = pmax(scores.max(), group)
    w = torch.where(mask, torch.exp(scores - m), 0.0)
    return w / psum(w.sum(), group)


def estimate_pose_dist(particles, weights, mask, group) -> PoseEstimate:
    """``filter/estimate.py::estimate_pose`` over the ranks' rows: the
    weight total, the mean sums and the covariance are psum'd."""
    w = torch.where(mask, weights, 0.0)
    v1 = psum(w.sum(), group)
    wn = w / torch.clamp(v1, min=1e-30)
    sums = psum(torch.stack([
        (particles[:, 0] * wn).sum(), (particles[:, 1] * wn).sum(),
        (torch.cos(particles[:, 2]) * wn).sum(),
        (torch.sin(particles[:, 2]) * wn).sum(), (wn * wn).sum()]), group)
    mean_xy = sums[:2]
    mean_theta = torch.atan2(sums[3], sums[2])
    mean = torch.cat([mean_xy, mean_theta[None]])
    res3 = torch.stack([
        particles[:, 0] - mean_xy[0],
        particles[:, 1] - mean_xy[1],
        normalize_angle_about(particles[:, 2], mean_theta),
    ], dim=0)
    res3 = torch.where(mask[None, :], res3, 0.0)
    denom = torch.clamp(1.0 - sums[4], min=1e-12)
    cov = psum((res3 * wn[None, :]) @ res3.T, group) / denom
    return PoseEstimate(mean=mean, cov=cov)


def _global_top_pose(particles, w, group) -> torch.Tensor:
    """The pose of the highest weight over all ranks: the local argmax,
    its pmax, the first rank holding it by a pmin of the rank, and that
    rank's pose by a psum (no particle data moves)."""
    w_best, i = w.max(dim=0)    # the first maximum, as argmax
    wmax = pmax(w_best.clone(), group)   # w_best is read below
    ax = axis_index(group)
    is_max = w_best >= wmax
    first = pmin(torch.where(is_max, ax, 2 ** 30).to(torch.int32), group)
    keep = is_max & (first == ax)
    return psum(torch.where(keep, row_at(particles, i), 0.0), group)


def estimate_pose_cluster_dist(particles, weights, mask, group, radius_xy,
                               radius_theta, anchor=None) -> PoseEstimate:
    """``filter/estimate.py::estimate_pose_cluster`` over the ranks: the
    cluster centre is the global top pose, or ``anchor`` (replicated)."""
    w = torch.where(mask, weights, 0.0)
    if anchor is None:
        anchor = _global_top_pose(particles, w, group)
    dx = particles[:, 0] - anchor[0]
    dy = particles[:, 1] - anchor[1]
    dth = torch.abs(normalize_angle_about(particles[:, 2], anchor[2]))
    near = (dx * dx + dy * dy <= radius_xy * radius_xy) & (dth <= radius_theta)
    return estimate_pose_dist(particles, weights, near & mask, group)


# ---------------------------------------------------------------------------
# the step of one rank
# ---------------------------------------------------------------------------

def _dist_window_origin(state: FilterState, mask, grid_map, config, group,
                        n_theta: int | None = None) -> torch.Tensor:
    """(3,) int32 (oy0, ox0, kstart), ``filter/step.py::_window_origin``
    over the ranks: the cloud's position and heading sums are psum'd (the
    theta centre pooled over both scored sets under MH), or the replicated
    anchor is read.  Either way the origin is the same on every rank, so
    every rank builds the same window; it stays on the device, where the
    corr and beam fields read it."""
    if config.window_center == "anchor":
        return window_origin_at(*_anchor_center(state, config), grid_map,
                                config, n_theta)
    sets = ((state.particles, state.prev_particles) if config.use_mh
            else (state.particles,))
    sums = psum(torch.stack([
        mask.sum().to(torch.float32),
        torch.where(mask, state.particles[:, 0], 0.0).sum(),
        torch.where(mask, state.particles[:, 1], 0.0).sum(),
        sum(torch.where(mask, torch.cos(p[:, 2]), 0.0).sum() for p in sets),
        sum(torch.where(mask, torch.sin(p[:, 2]), 0.0).sum() for p in sets),
    ]), group)
    n = torch.clamp(sums[0], min=1.0)
    return window_origin_at(sums[1] / n, sums[2] / n,
                            torch.atan2(sums[4], sums[3]), grid_map, config,
                            n_theta)


def _refresh_anchor_dist(state: FilterState, mask, ranges, config, group):
    """``filter/step.py::refresh_anchor`` over the ranks: the candidate is
    the global top pose, the cluster masses are psum'd and the evidence
    veto's top weights pmax'd.  Returns (anchor, anchor_mass, streak)."""
    rxy, rth = config.cluster_radius_xy, config.cluster_radius_theta
    p, anchor = state.particles, state.anchor
    w = torch.where(mask, state.weights, 0.0)
    cand = _global_top_pose(p, w, group).to(torch.float32)
    m_cand, m_cur = psum(torch.stack([
        cluster_mass(p, state.weights, cand, rxy, rth, mask),
        cluster_mass(p, state.weights, anchor, rxy, rth, mask)]), group)
    d_xy = torch.hypot(cand[0] - anchor[0], cand[1] - anchor[1])
    d_th = torch.abs(normalize_angle_about(cand[2], anchor[2]))
    same_mode = (d_xy <= rxy) & (d_th <= rth)
    migrate = m_cand > config.anchor_hysteresis * m_cur
    if config.anchor_score_margin > 0.0:
        d2 = (p[:, 0] - anchor[0]) ** 2 + (p[:, 1] - anchor[1]) ** 2
        inc = (d2 <= rxy ** 2) & (
            torch.abs(normalize_angle_about(p[:, 2], anchor[2])) <= rth)
        w_inc_top, w_cand_top = pmax(torch.stack([
            torch.where(inc, w, 0.0).max(), w.max()]), group)
        # the margin is per beam; ranges are replicated, so the local
        # beam count is the global one
        scale = (torch.clamp(_beam_count(ranges, config), min=1).to(torch.float32)
                 if config.score_aggregation == "sum" else 1.0)
        migrate = migrate & (w_inc_top < w_cand_top * torch.exp(
            torch.as_tensor(-config.anchor_score_margin * scale)))
    challenge = migrate & ~same_mode
    streak = torch.where(challenge, state.anchor_streak + 1, 0).to(torch.int32)
    migrate = migrate & (streak >= config.anchor_commit_scans)
    adopt = same_mode | migrate
    return (torch.where(adopt, cand, anchor).to(torch.float32),
            torch.where(adopt, m_cand, m_cur),
            torch.where(migrate, 0, streak).to(torch.int32))


def island_kld_sizes(config, n_dev: int) -> tuple[int, int]:
    """(min_particles, eval_window) of an island's KLD draw: the global
    values over the D ranks, the window kept above the island's minimum
    (JAX :562-596)."""
    min_l = max(config.min_particles // n_dev, 1)
    window = (max(config.kld_eval_window // n_dev, min_l + 1)
              if config.kld_eval_window else 0)
    return min_l, window


def _island_resample(state: FilterState, mask, count_l, grid_map, config,
                     group, n_dev: int, d: Draws):
    """Each rank resamples its own rows (JAX :676-775); returns (state,
    p_random).  ``count_l`` = count / D, the same on every rank.  ``d``
    holds every draw (``filter/step.py::_resample_draws``)."""
    nl = state.n_max
    dev = state.device
    gen = state.key
    slot = torch.arange(nl, device=dev)
    if not config.use_adaptive:
        return state.replace(particles=systematic_resample_particles(
            state.particles, state.weights, nl, count=count_l,
            r=d.resample_r, generator=gen)), scalar(0.0, dev)
    p_random = _p_random(state, config)
    n_drop_l = (p_random * count_l.to(torch.float32)).to(torch.int32)
    if config.injection_refill:
        # the fresh block scales with the island's capacity, so a fitness
        # collapse regrows each island's count toward nl
        n_random_l = (p_random * float(nl)).to(torch.int32)
    else:
        n_random_l = n_drop_l

    def randoms(n, cells=d.inject_cells, jitter=d.inject_jitter,
                theta=d.inject_theta):
        return init_uniform(n, grid_map, generator=gen, cells=cells,
                            jitter=jitter, theta=theta)

    if config.adaptive_resampler == "kld":
        min_l, eval_window = island_kld_sizes(config, n_dev)
        samples, n_kept = kld_resample(
            state.particles, state.weights,
            max_samples=nl,
            min_particles=min_l,
            bin_size_xy=config.kld_bin_size_xy,
            bin_size_theta=config.kld_bin_size_theta,
            # the Fox bound is global: the island stops when the global
            # count m * D passes chi2(k) / (2 eps), i.e. m past
            # chi2(k) / (2 eps D); an unscaled eps would keep the bound
            # above nl and the island stop would never fire
            epsilon=config.kld_epsilon * n_dev,
            z=config.kld_z,
            count=count_l - n_drop_l,
            eval_window=eval_window,
            stop_rule=("new_bin" if config.ref_compat_kld_newbin_stop
                       else "every_sample"),
            r=d.kld_r, noise=d.kld_noise, noise_tail=d.kld_noise_tail,
            generator=gen,
        )
        # the stop rule above is the island's own: its escalation gate
        # holds no collective, so the ranks may take it apart; every rank
        # adopts the largest island count (never fewer particles than the
        # KLD bound asks for anywhere)
        n_kept = torch.minimum(n_kept, count_l - n_drop_l)
        new_count_l = torch.clamp(pmax(n_random_l + n_kept, group), min_l,
                                  nl).to(torch.int32)

        def inject():
            # the randoms take the first slots (reference order); the kept
            # samples shift behind them by the device-held n_random_l
            shifted = samples[(slot - n_random_l) % nl]
            return [torch.where((slot < n_random_l)[:, None], randoms(nl),
                                shifted)]

        # p_random and count_l are replicated: every rank takes the branch
        (particles,) = run_if(n_random_l > 0, inject, [samples], donate=True)
        weights = torch.where(slot < new_count_l,
                              1.0 / (new_count_l * n_dev).to(torch.float32),
                              0.0)
        return (state.replace(particles=particles, weights=weights,
                              count=new_count_l * n_dev), p_random)
    if config.adaptive_resampler == "simple":
        idx = multinomial_resample_indices(state.weights, nl,
                                           u=d.multinomial_u, generator=gen)
        particles = torch.where((slot < count_l - n_drop_l)[:, None],
                                state.particles[idx.to(torch.int64)],
                                randoms(nl))
    else:  # "lvr"
        resampled = systematic_resample_particles(
            state.particles, state.weights, nl, count=count_l,
            r=d.resample_r, generator=gen)
        particles = torch.where((d.lvr_coins < p_random)[:, None],
                                randoms(nl), resampled)
    weights = torch.where(mask, 1.0 / torch.clamp(state.count, min=1), 0.0
                          ).to(torch.float32)
    return state.replace(particles=particles, weights=weights), p_random


def _dist_step(state: FilterState, ranges, angles, delta, *, grid_map,
               log_field, config, group, n_dev: int, migrate: int,
               draws: Draws | None = None):
    """One scan on this rank's rows (JAX ``_dist_step``, :438-791).  The
    step always resamples: the ESS gate is single-device only."""
    d = draws if draws is not None else Draws()
    nl = state.n_max
    count_l = state.count // n_dev
    mask = torch.arange(nl, device=state.device) < count_l

    # -- predict, fully local
    state = _predict(state, delta, grid_map, config, d)
    prev = state.prev_particles

    # -- correct: a global softmax over theta-sharded field scores
    impl = _resolved_impl(config, state.device)
    field = impl in ("corr", "field")
    wo = (_dist_window_origin(state, mask, grid_map, config, group,
                              n_theta=(config.beam_table_n_theta
                                       if impl == "field" else None))
          if config.corr_window_cells and field else None)
    score = _make_scorer(ranges, angles, grid_map, log_field, config, impl,
                         wo, shard_group=group)
    if config.motion_validity == "score" and not field:
        score = wrap_score_with_validity(score, grid_map, config, ranges)

    # inactive rows collapse onto row 0 (active on every rank: count_l >= 1)
    anchor0 = state.particles[0]
    p_sc = torch.where(mask[:, None], state.particles, anchor0)
    if config.use_mh:
        prev_sc = torch.where(mask[:, None], prev, anchor0)
        s_both = score(torch.cat([p_sc, prev_sc]))  # one field build
        s_post = s_both[:nl]
        weights_post = softmax_weights_dist(s_post, mask, group)
        weights_pre = softmax_weights_dist(s_both[nl:], mask, group)
        if config.asymmetric:
            # raw densities, normalized over all ranks' rows
            fwd = motion_density(prev, state.particles, state.delta,
                                 config.alpha, normalize=False)
            bwd = motion_density(
                state.particles, prev,
                invert_delta(state.delta,
                             ref_compat=config.ref_compat_backward_delta),
                config.alpha, normalize=False)
            fwd = fwd / torch.clamp(psum(fwd.sum(), group), min=1e-30)
            bwd = bwd / torch.clamp(psum(bwd.sum(), group), min=1e-30)
            particles, weights, accepted = asymmetric_mh(
                prev, state.particles, weights_post, weights_pre, fwd, bwd,
                ref_compat_guard=config.ref_compat_assym_guard,
                u=d.mh_u, generator=state.key)
        else:
            particles, weights, accepted = symmetric_mh(
                prev, state.particles, weights_post, weights_pre,
                u=d.mh_u, generator=state.key)
        accept_rate = (psum(torch.where(mask, accepted, False).sum(), group)
                       / torch.clamp(state.count, min=1))
        state = state.replace(particles=particles)
    else:
        s_post = score(p_sc)
        weights = softmax_weights_dist(s_post, mask, group)
        accept_rate = scalar(1.0, state.device)

    weights = torch.where(mask, weights, 0.0)
    weights = weights / torch.clamp(psum(weights.sum(), group), min=1e-30)
    if config.use_adaptive:
        if config.ref_compat_w_avg:
            w_avg = (psum(weights.sum(), group)
                     / torch.clamp(state.count, min=1))
        else:
            per_beam = (s_post / torch.clamp(_beam_count(ranges, config), min=1)
                        if config.score_aggregation == "sum" else s_post)
            w_avg = (psum(torch.where(mask, torch.exp(per_beam), 0.0).sum(),
                          group) / torch.clamp(state.count, min=1))
        state = state.replace(
            w_slow=state.w_slow + config.alpha_slow * (w_avg - state.w_slow),
            w_fast=state.w_fast + config.alpha_fast * (w_avg - state.w_fast),
        )
    state = state.replace(weights=weights)

    # -- window anchor refresh on the pre-resample weights
    new_anchor, anchor_mass, new_streak = _refresh_anchor_dist(
        state, mask, ranges, config, group)
    state = state.replace(anchor=new_anchor, anchor_streak=new_streak)

    # -- estimate before resampling
    if config.estimate_mode in ("cluster", "anchor"):
        est = estimate_pose_cluster_dist(
            state.particles, state.weights, mask, group,
            config.cluster_radius_xy, config.cluster_radius_theta,
            anchor=state.anchor if config.estimate_mode == "anchor" else None)
    else:
        est = estimate_pose_dist(state.particles, state.weights, mask, group)
    ess = 1.0 / torch.clamp(psum((state.weights * state.weights).sum(), group),
                            min=1e-30)

    # -- island resampling (every draw made first, at the island's static
    # shapes), then the ring migration
    d = _resample_draws(state, grid_map, config, d,
                        *island_kld_sizes(config, n_dev))
    state, p_random = _island_resample(state, mask, count_l, grid_map, config,
                                       group, n_dev, d)
    if migrate > 0 and n_dev > 1:
        block = ppermute_ring(state.particles[:migrate], group)
        state = state.replace(
            particles=torch.cat([block, state.particles[migrate:]]))

    info = StepInfo(
        estimate=est, ess=ess, accept_rate=accept_rate, count=state.count,
        p_random=p_random, w_slow=state.w_slow, w_fast=state.w_fast,
        anchor_mass=anchor_mass,
    )
    return state, info


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------

class DistModel:
    """A config + map bound into init / step / run on this rank's rows of
    a 1-D mesh (JAX ``DistModel``).  ``nl`` rows a rank, ``migrate`` of
    them sent round the ring each scan."""

    def __init__(self, config, grid_map, mesh, axis: str = "data",
                 migration_fraction: float = 0.125, voxel_map=None):
        self.config = config
        self.grid_map = grid_map
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.n_dev = mesh.size()
        self.nl = state_size(config) // self.n_dev
        self.migrate = int(self.nl * migration_fraction)
        self.base = make_model(config, grid_map, voxel_map=voxel_map)
        self.log_field = self.base.log_field
        self._graphs: dict = {}

    @property
    def device(self) -> torch.device:
        return self.grid_map.device

    def init(self, seed: int = 0, initial_pose=None,
             initial_cov=None) -> FilterState:
        """Every rank builds the single-device initial state from ``seed``,
        keeps its rows and takes its own generator, seeded from (seed,
        rank)."""
        full = self.base.init(seed, initial_pose=initial_pose,
                              initial_cov=initial_cov)
        rank = axis_index(self.group)
        gen = make_generator(split_seed(seed, self.n_dev)[rank], self.device)
        return shard_state(full, self.mesh, self.axis).replace(key=gen)

    @property
    def replays_graph(self) -> bool:
        """True where ``run`` replays a captured step: on a card, over a
        group whose collectives NCCL carries (captured into the graph).  A
        gloo group runs on the CPU: its ``run`` is the eager loop."""
        return (self.device.type == "cuda"
                and "nccl" in str(dist.get_backend(self.group)))

    def captured(self, state, beams: int):
        """The ``CapturedStep`` of this rank's step for ``state``'s rows
        and scans of ``beams`` ranges, made at first use; it captures at
        its first run (every rank at the same scan: the capture's warm-up
        step calls the collectives, the capture records them)."""
        from mcmh_localization_tpu_torch.filter.captured import CapturedStep

        key = (state.n_max, beams)
        if key not in self._graphs:
            self._graphs[key] = CapturedStep(self, state, beams)
        return self._graphs[key]

    @staticmethod
    def tally():
        """The scope in which a capture counts this model's collectives
        (``collectives_tallied``)."""
        return collectives_tallied()

    @staticmethod
    def add_tallies(tally: dict, times: int) -> None:
        add_collectives(tally, times)

    def step(self, state, ranges, angles, delta, draws: Draws | None = None):
        return _dist_step(
            state, as_f32(ranges, self.device), as_f32(angles, self.device),
            delta, grid_map=self.grid_map, log_field=self.log_field,
            config=self.config, group=self.group, n_dev=self.n_dev,
            migrate=self.migrate, draws=draws)

    def run(self, state, ranges_seq, angles, deltas):
        """A trajectory, one step per scan; (final state, stacked StepInfo,
        the same on every rank).  On an NCCL group (``replays_graph``) one
        replay of the captured step a scan, bitwise the eager steps on the
        same generators; on a gloo group the eager loop (``run_eager``)."""
        if not self.replays_graph:
            return self.run_eager(state, ranges_seq, angles, deltas)
        ranges_seq = as_f32(ranges_seq, self.device)
        return self.captured(state, ranges_seq.shape[1]).run(
            state, ranges_seq, as_f32(angles, self.device),
            as_f32(deltas, self.device))

    def run_eager(self, state, ranges_seq, angles, deltas):
        """``run`` as a loop of eager steps: the captured run's plain
        version."""
        return run_steps(self, state, ranges_seq, angles, deltas)


def round_up(x: int, n: int) -> int:
    """``x`` rounded up to a multiple of ``n``."""
    return -(-x // n) * n


def round_counts(config, n_dev: int):
    """``config`` with its particle counts rounded up to multiples of the
    mesh size (JAX :692-702), so every island has the same size and
    ``min_particles`` is at least one particle a rank."""
    return config.replace(
        num_particles=round_up(config.num_particles, n_dev),
        max_particles=round_up(state_size(config), n_dev),
        min_particles=max(round_up(config.min_particles, n_dev), n_dev),
    )


def make_dist_model(config, grid_map, mesh, axis: str = "data",
                    migration_fraction: float = 0.125,
                    voxel_map=None) -> DistModel:
    """The multi-rank filter (all six modes; the likelihood-field, beam and
    3-D lidar sensors) on this rank's mesh.  The particle counts round up
    to multiples of the mesh size, so every island has the same size."""
    if config.sensor_model not in ("likelihood_field", "beam", "lidar3d"):
        raise ValueError(f"unknown sensor_model {config.sensor_model!r}")
    return DistModel(round_counts(config, mesh.size()), grid_map, mesh, axis,
                     migration_fraction, voxel_map)
