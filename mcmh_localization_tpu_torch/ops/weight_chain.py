"""The filter step's weight chain: from the scores of the proposed and
previous sets to the ESS.

``filter/step.py::_correct`` scores both sets in one call, then hands the
scores here: the two softmaxes (with the carried log weights), the
Metropolis-Hastings accept (asymmetric with the motion densities forward
and backward, symmetric, or none), the accept rate, the normalised
weights, the augmented-MCL averages w_slow / w_fast, the window anchor's
refresh, the pose estimate ("mean", "cluster" or "anchor") and the ESS.

On the card the chain is ``csrc/weight_chain.cu``: four passes (five for
``estimate_mode="anchor"``) at every size, where PyTorch took about 290
launches a scan.  The JAX package leaves the chain to XLA
(``mcmh_localization_tpu/filter/step.py:651-715``); no Pallas kernel is
replaced.  The plain version, ``weight_chain_plain``, is the PyTorch
chain itself (``softmax_weights``, ``asymmetric_mh`` / ``symmetric_mh``
with ``motion_density``, ``refresh_anchor``, ``estimate_pose`` /
``estimate_pose_cluster``, ``effective_sample_size``), which CPU tensors
take.  The MH uniforms are one ``torch.rand((n_max,))`` from the state's
generator on either path, at the same place in the stream; no kernel
draws.  The kernels take each slot's arithmetic operation by operation
as the plain chain does, and their sums in another order (per-block
partials folded in block order, bit for bit the same from call to
call): the scalars, and each weight through its normaliser, differ from
the plain chain's in the last bits, and an accept at u == alpha to the
last bit can flip.

Both versions stamp the stage ``mh`` (``utils/profiling.py``) where the
selected set is written; the caller stamps ``estimate`` after.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmh_localization_tpu_torch.filter.estimate import (
    PoseEstimate,
    cluster_mass,
    estimate_pose,
    estimate_pose_cluster,
    row_at,
)
from mcmh_localization_tpu_torch.filter.mh import asymmetric_mh, symmetric_mh
from mcmh_localization_tpu_torch.models.motion import invert_delta, motion_density
from mcmh_localization_tpu_torch.ops import _cuda
from mcmh_localization_tpu_torch.ops.resampling import (
    effective_sample_size,
    softmax_weights,
)
from mcmh_localization_tpu_torch.utils import profiling
from mcmh_localization_tpu_torch.utils.angles import normalize_angle_about
from mcmh_localization_tpu_torch.utils.f32 import scalar

# csrc/weight_chain.cu's out slots
_OUT = 20
_ANCHOR, _MASS, _MEAN, _COV, _ESS = 3, 6, 7, 10, 19


class ChainResult(NamedTuple):
    """The state's new fields and the scan's StepInfo fields."""

    particles: torch.Tensor      # (n_max, 3) the selected set
    weights: torch.Tensor        # (n_max,) normalised, 0 past count
    w_slow: torch.Tensor
    w_fast: torch.Tensor
    anchor: torch.Tensor         # (3,)
    anchor_streak: torch.Tensor  # () int32
    anchor_mass: torch.Tensor
    estimate: PoseEstimate
    ess: torch.Tensor
    accept_rate: torch.Tensor


def beam_count(ranges: torch.Tensor, config) -> torch.Tensor:
    """The scan's beams that scored: finite and short of max_range, every
    ``config.step``-th."""
    sig = ranges[:: config.step] if config.step > 1 else ranges
    return (torch.isfinite(sig) & (sig < config.max_range)).sum()


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


def _transition_probabilities(state, config):
    fwd = motion_density(state.prev_particles, state.particles, state.delta,
                         config.alpha)
    bwd_delta = invert_delta(state.delta,
                             ref_compat=config.ref_compat_backward_delta)
    bwd = motion_density(state.particles, state.prev_particles, bwd_delta,
                         config.alpha)
    return fwd, bwd


def weight_chain_plain(s_both, state, ranges, config, u=None) -> ChainResult:
    """The chain in PyTorch: ``s_both`` the (2 n_max,) scores of the
    proposed then the previous set under MH (else the (n_max,) proposed
    set's), ``state`` the FilterState they were scored on, ``ranges`` the
    scan, ``u`` the (n_max,) MH uniforms (drawn from ``state.key`` when
    None)."""
    mask = state.active_mask
    carry_on = config.resample_ess_threshold < 1.0
    log_carry = (torch.log(torch.clamp(state.weights, min=1e-30))
                 if carry_on else 0.0)
    if config.use_mh:
        n_max = state.n_max
        s_post = s_both[:n_max]
        weights_post = softmax_weights(s_post + log_carry, mask)
        weights_pre = softmax_weights(s_both[n_max:] + log_carry, mask)
        if config.asymmetric:
            fwd, bwd = _transition_probabilities(state, config)
            particles, weights, accepted = asymmetric_mh(
                state.prev_particles, state.particles, weights_post,
                weights_pre, fwd, bwd,
                ref_compat_guard=config.ref_compat_assym_guard,
                u=u, generator=state.key)
        else:
            particles, weights, accepted = symmetric_mh(
                state.prev_particles, state.particles, weights_post,
                weights_pre, u=u, generator=state.key)
        accept_rate = (torch.where(mask, accepted, False).sum()
                       / torch.clamp(state.count, min=1))
        state = state.replace(particles=particles)
    else:
        s_post = s_both
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
            per_beam = (s_post / torch.clamp(beam_count(ranges, config), min=1)
                        if config.score_aggregation == "sum" else s_post)
            w_avg = (torch.where(mask, torch.exp(per_beam), 0.0).sum()
                     / torch.clamp(state.count, min=1))
        state = state.replace(
            w_slow=state.w_slow + config.alpha_slow * (w_avg - state.w_slow),
            w_fast=state.w_fast + config.alpha_fast * (w_avg - state.w_fast),
        )
    state = state.replace(weights=weights)

    # -- window anchor refresh on the pre-resample weights
    scale = (torch.clamp(beam_count(ranges, config), min=1).to(torch.float32)
             if config.score_aggregation == "sum" else 1.0)
    new_anchor, anchor_mass, new_streak = refresh_anchor(
        state.particles, state.weights, state.anchor, state.anchor_streak,
        config, mask, score_scale=scale)

    # -- estimate before resampling (:327)
    if config.estimate_mode in ("cluster", "anchor"):
        est = estimate_pose_cluster(
            state.particles, state.weights, mask,
            radius_xy=config.cluster_radius_xy,
            radius_theta=config.cluster_radius_theta,
            anchor=new_anchor if config.estimate_mode == "anchor" else None)
    else:
        est = estimate_pose(state.particles, state.weights, mask)
    ess = effective_sample_size(state.weights)
    return ChainResult(
        particles=state.particles, weights=state.weights,
        w_slow=state.w_slow, w_fast=state.w_fast, anchor=new_anchor,
        anchor_streak=new_streak, anchor_mass=anchor_mass, estimate=est,
        ess=ess, accept_rate=accept_rate)


def launches(config) -> int:
    """The kernels one chain launches: four passes, five for
    estimate_mode "anchor"."""
    return 5 if config.estimate_mode == "anchor" else 4


def weight_chain(s_both, state, ranges, config, u=None) -> ChainResult:
    """The chain (see ``weight_chain_plain`` for the arguments): CPU
    tensors take the plain version, CUDA tensors the kernels."""
    if s_both.device.type == "cpu":
        return weight_chain_plain(s_both, state, ranges, config, u)
    return weight_chain_cuda(s_both, state, ranges, config, u)


def weight_chain_cuda(s_both, state, ranges, config, u=None) -> ChainResult:
    """The chain on the card: ``csrc/weight_chain.cu``'s passes.  Raises
    where a tensor is not on the card."""
    n = state.n_max
    mh = 0 if not config.use_mh else (2 if config.asymmetric else 1)
    need = [s_both, state.weights, state.particles, state.prev_particles,
            state.delta, state.count, state.w_slow, state.w_fast,
            state.anchor, state.anchor_streak, ranges]
    _cuda.require_cuda("weight_chain", *need)
    if s_both.shape != ((2 * n,) if mh else (n,)):
        raise ValueError(f"weight_chain: s_both has shape "
                         f"{tuple(s_both.shape)} for n_max={n}")
    if (state.count.dtype != torch.int32
            or state.anchor_streak.dtype != torch.int32):
        raise ValueError("weight_chain: count and anchor_streak must be int32")
    if any(t.dtype != torch.float32 for t in need
           if t is not state.count and t is not state.anchor_streak):
        raise ValueError("weight_chain: the scores, sets, weights, delta, "
                         "averages, anchor and ranges must be float32")
    if ranges.dim() != 1:
        raise ValueError("weight_chain: ranges must be 1-D")
    dev = s_both.device
    if mh:
        if u is None:
            u = torch.rand((n,), generator=state.key, device=dev)
        _cuda.require_cuda("weight_chain", u)
        if u.shape != (n,) or u.dtype != torch.float32:
            raise ValueError("weight_chain: u must be (n_max,) float32")
    lib = _cuda.library()
    f32 = dict(dtype=torch.float32, device=dev)
    p_out = torch.empty((n, 3), **f32) if mh else state.particles
    w_out = torch.empty((n,), **f32)
    out = torch.empty((_OUT,), **f32)
    streak = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty((lib.mcmh_weight_chain_scratch_floats(n),), **f32)
    a1, a2, a3, a4 = config.alpha
    rxy = config.cluster_radius_xy
    args = _cuda.ChainArgs(
        s_both.data_ptr(), state.weights.data_ptr(),
        state.particles.data_ptr(), state.prev_particles.data_ptr(),
        state.delta.data_ptr(), u.data_ptr() if mh else None,
        state.count.data_ptr(), state.w_slow.data_ptr(),
        state.w_fast.data_ptr(), state.anchor.data_ptr(),
        state.anchor_streak.data_ptr(), ranges.data_ptr(),
        p_out.data_ptr(), w_out.data_ptr(), out.data_ptr(),
        streak.data_ptr(), scratch.data_ptr(),
        n, ranges.shape[0], config.step, mh,
        int(config.ref_compat_assym_guard),
        int(config.resample_ess_threshold < 1.0), int(config.use_adaptive),
        int(config.ref_compat_w_avg),
        int(config.score_aggregation == "sum"),
        ("mean", "cluster", "anchor").index(config.estimate_mode),
        int(config.anchor_score_margin > 0.0),
        int(config.ref_compat_backward_delta), config.anchor_commit_scans,
        a1, a2, a3, a4, config.alpha_slow, config.alpha_fast, rxy, rxy * rxy,
        config.cluster_radius_theta, config.anchor_hysteresis,
        -config.anchor_score_margin, config.max_range)
    stream = _cuda.stream_of(s_both)
    _cuda.check_launch("weight_chain",
                       lib.mcmh_weight_chain_mh(args, stream), 2)
    profiling.stamp("mh")
    _cuda.check_launch("weight_chain",
                       lib.mcmh_weight_chain_estimate(args, stream),
                       launches(config) - 2)
    adaptive = config.use_adaptive
    return ChainResult(
        particles=p_out, weights=w_out,
        w_slow=out[0] if adaptive else state.w_slow,
        w_fast=out[1] if adaptive else state.w_fast,
        anchor=out[_ANCHOR:_ANCHOR + 3], anchor_streak=streak,
        anchor_mass=out[_MASS],
        estimate=PoseEstimate(mean=out[_MEAN:_MEAN + 3],
                              cov=out[_COV:_COV + 9].view(3, 3)),
        ess=out[_ESS], accept_rate=out[2])
