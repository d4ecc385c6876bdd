"""The filter step's weight chain (``ops/weight_chain.py``): its plain
version against the composition ``filter/step.py::_correct`` made of the
chain's functions before it moved there (the softmaxes, the MH, the
augmented-MCL averages, the anchor refresh, the estimate and the ESS),
bit for bit; and the wrapper's device rule and launch plan.  The CUDA
kernels (``csrc/weight_chain.cu``) are held to the plain version on the
card by ``chip_smoke.py``'s ``[weight_chain]`` phase."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.filter.estimate import (  # noqa: E402
    estimate_pose,
    estimate_pose_cluster,
)
from mcmh_localization_tpu_torch.filter.mh import (  # noqa: E402
    asymmetric_mh,
    symmetric_mh,
)
from mcmh_localization_tpu_torch.filter.state import FilterState  # noqa: E402
from mcmh_localization_tpu_torch.models.motion import (  # noqa: E402
    invert_delta,
    motion_density,
)
from mcmh_localization_tpu_torch.ops import _cuda  # noqa: E402
from mcmh_localization_tpu_torch.ops import weight_chain as wc  # noqa: E402
from mcmh_localization_tpu_torch.ops.resampling import (  # noqa: E402
    effective_sample_size,
    softmax_weights,
)
from mcmh_localization_tpu_torch.utils.f32 import scalar  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

N_MAX, COUNT = 96, 77

# every variant _correct takes: (mode, FilterConfig fields)
VARIANTS = {
    "amh_guard_carry": ("AMHAMCL", dict(resample_ess_threshold=0.9)),
    "amh_noguard": ("AMHAMCL", dict(ref_compat_assym_guard=False)),
    "amh_noguard_carry_sum": ("AMHAMCL", dict(
        ref_compat_assym_guard=False, resample_ess_threshold=0.9,
        score_aggregation="sum")),
    "amh_sum_refill": ("AMHAMCL", dict(score_aggregation="sum",
                                       injection_refill=True)),
    "amh_ref_w_avg": ("AMHAMCL", dict(ref_compat_w_avg=True,
                                      ref_compat_assym_guard=False)),
    "amh_ref_bwd": ("AMHAMCL", dict(ref_compat_backward_delta=True,
                                    ref_compat_assym_guard=False)),
    "amh_not_adaptive": ("AMHMCL", dict(ref_compat_assym_guard=False)),
    "symmetric": ("MHAMCL", dict(resample_ess_threshold=0.9)),
    "symmetric_not_adaptive": ("MHMCL", {}),
    "no_mh": ("AMCL", {}),
    "no_mh_carry_sum": ("AMCL", dict(resample_ess_threshold=0.9,
                                     score_aggregation="sum")),
    "no_mh_not_adaptive": ("MCL", {}),
    "cluster": ("AMHAMCL", dict(estimate_mode="cluster",
                                ref_compat_assym_guard=False)),
    "anchor": ("AMHAMCL", dict(estimate_mode="anchor",
                               ref_compat_assym_guard=False,
                               cluster_radius_xy=0.3)),
    "anchor_margin_sum": ("AMHAMCL", dict(
        estimate_mode="anchor", anchor_score_margin=0.5,
        score_aggregation="sum", ref_compat_assym_guard=False)),
    "margin_mean_commit": ("AMHAMCL", dict(
        anchor_score_margin=0.05, anchor_commit_scans=2,
        anchor_hysteresis=1.5, ref_compat_assym_guard=False)),
}


def _config(name):
    mode, kw = VARIANTS[name]
    return FilterConfig(mode=mode, num_particles=COUNT, min_particles=20,
                        max_particles=N_MAX, **kw)


def _inputs(seed, n=N_MAX, count=COUNT, ties=True):
    """(state, s_both, ranges, u): two clouds around two modes with a
    padded tail, carried weights, scores with their largest two equal on
    two active slots that both accept (u = 0), and a scan with invalid
    beams."""
    rng = np.random.default_rng(seed)
    prev = np.concatenate([
        rng.normal((0.5, -0.3, 0.4), (0.2, 0.2, 0.3), (n // 2, 3)),
        rng.normal((2.0, 1.0, -2.9), (0.3, 0.3, 0.4), (n - n // 2, 3))])
    delta = np.array([0.12, 0.08, -0.05])
    th = prev[:, 2] + delta[0] + rng.normal(0, 0.05, n)
    step = delta[1] + rng.normal(0, 0.02, n)
    cur = np.stack([prev[:, 0] + step * np.cos(th),
                    prev[:, 1] + step * np.sin(th),
                    th + delta[2] + rng.normal(0, 0.05, n)], axis=1)
    cur[:, 2] = (cur[:, 2] + np.pi) % (2 * np.pi) - np.pi
    w = rng.dirichlet(np.ones(count))
    weights = np.zeros(n)
    weights[:count] = w
    scores = rng.normal(-3.0, 1.5, 2 * n)
    u = rng.uniform(size=n)
    if ties:
        top = scores.max() + 1.0
        scores[[5, 11]] = top
        weights[[5, 11]] = weights[:count].max()
        u[[5, 11]] = 0.0
    ranges = rng.uniform(0.2, 6.0, 40)
    ranges[::7] = np.inf
    f = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))  # noqa: E731
    gen = torch.Generator().manual_seed(seed)
    state = FilterState(
        particles=f(cur), prev_particles=f(prev), weights=f(weights),
        count=torch.tensor(count, dtype=torch.int32), w_slow=f(0.3),
        w_fast=f(0.2), delta=f(delta), anchor=f(cur[3]),
        anchor_streak=torch.tensor(1, dtype=torch.int32), key=gen)
    return state, f(scores), f(ranges), f(u)


def _parent_chain(s_both, state, ranges, config, u):
    """``_correct``'s chain as it was composed in the step, from the
    scores to the ESS."""
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
            fwd = motion_density(state.prev_particles, state.particles,
                                 state.delta, config.alpha)
            bwd_delta = invert_delta(
                state.delta, ref_compat=config.ref_compat_backward_delta)
            bwd = motion_density(state.particles, state.prev_particles,
                                 bwd_delta, config.alpha)
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
    weights = torch.where(mask, weights, 0.0)
    weights = weights / torch.clamp(weights.sum(), min=1e-30)
    sig = ranges[:: config.step] if config.step > 1 else ranges
    beams = (torch.isfinite(sig) & (sig < config.max_range)).sum()
    if config.use_adaptive:
        if config.ref_compat_w_avg:
            w_avg = weights.sum() / torch.clamp(state.count, min=1)
        else:
            per_beam = (s_post / torch.clamp(beams, min=1)
                        if config.score_aggregation == "sum" else s_post)
            w_avg = (torch.where(mask, torch.exp(per_beam), 0.0).sum()
                     / torch.clamp(state.count, min=1))
        state = state.replace(
            w_slow=state.w_slow + config.alpha_slow * (w_avg - state.w_slow),
            w_fast=state.w_fast + config.alpha_fast * (w_avg - state.w_fast))
    state = state.replace(weights=weights)
    scale = (torch.clamp(beams, min=1).to(torch.float32)
             if config.score_aggregation == "sum" else 1.0)
    new_anchor, anchor_mass, new_streak = wc.refresh_anchor(
        state.particles, state.weights, state.anchor, state.anchor_streak,
        config, mask, score_scale=scale)
    state = state.replace(anchor=new_anchor, anchor_streak=new_streak)
    if config.estimate_mode in ("cluster", "anchor"):
        est = estimate_pose_cluster(
            state.particles, state.weights, mask,
            radius_xy=config.cluster_radius_xy,
            radius_theta=config.cluster_radius_theta,
            anchor=state.anchor if config.estimate_mode == "anchor" else None)
    else:
        est = estimate_pose(state.particles, state.weights, mask)
    ess = effective_sample_size(state.weights)
    return wc.ChainResult(
        particles=state.particles, weights=state.weights,
        w_slow=state.w_slow, w_fast=state.w_fast, anchor=state.anchor,
        anchor_streak=state.anchor_streak, anchor_mass=anchor_mass,
        estimate=est, ess=ess, accept_rate=accept_rate)


def _fields(r: wc.ChainResult) -> dict:
    out = r._asdict()
    est = out.pop("estimate")
    return {**out, "mean": est.mean, "cov": est.cov}


@pytest.mark.parametrize("draw", ["given_u", "drawn_u"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_plain_chain_bitwise_the_parent_composition(name, draw):
    """Every variant, on a padded set (count < n_max) with a tie for the
    largest weight: every field bit for bit, the generator moved alike."""
    config = _config(name)
    state, scores, ranges, u = _inputs(7)
    if not config.use_mh:
        scores = scores[:N_MAX].contiguous()
    given = u if draw == "given_u" else None
    want_state = state.replace(key=torch.Generator().manual_seed(7))
    want = _parent_chain(scores, want_state, ranges, config, given)
    got = wc.weight_chain(scores, state, ranges, config, u=given)
    for k, v in _fields(want).items():
        g = _fields(got)[k]
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert torch.equal(g, v), (k, g, v)
    assert torch.equal(state.key.get_state(), want_state.key.get_state())
    if name == "amh_guard_carry" and draw == "given_u":
        # the tie: both top slots accept, the first one is the candidate
        w = got.weights
        assert w[5] == w[11] == w.max() and int(torch.argmax(w)) == 5


def test_plain_chain_variants_differ():
    """The variants do reach different branches: the estimates, weights
    and anchors of the cases are not all one."""
    state, scores, ranges, u = _inputs(3, ties=False)
    seen = set()
    for name in VARIANTS:
        config = _config(name)
        s = scores if config.use_mh else scores[:N_MAX].contiguous()
        r = wc.weight_chain_plain(s, state, ranges, config, u)
        seen.add((tuple(r.estimate.mean.tolist()), float(r.weights.sum()),
                  tuple(r.anchor.tolist()), float(r.w_fast)))
    assert len(seen) >= 10


def _meta_inputs(n, config):
    meta = dict(device="meta")
    f = lambda *s: torch.empty(s, dtype=torch.float32, **meta)  # noqa: E731
    i = torch.empty((), dtype=torch.int32, **meta)
    state = FilterState(
        particles=f(n, 3), prev_particles=f(n, 3), weights=f(n), count=i,
        w_slow=f(), w_fast=f(), delta=f(3), anchor=f(3),
        anchor_streak=torch.empty((), dtype=torch.int32, **meta),
        key=torch.Generator())
    return state, f(2 * n if config.use_mh else n), f(360), f(n)


def test_wrapper_refuses_what_is_not_on_the_card(monkeypatch):
    """A tensor that is neither on the CPU nor on the card raises; the
    plain chain never runs for it."""
    def plain(*a, **k):
        raise AssertionError("the plain chain ran for a non-CPU tensor")

    monkeypatch.setattr(wc, "weight_chain_plain", plain)
    config = _config("amh_guard_carry")
    state, scores, ranges, u = _meta_inputs(1000, config)
    with pytest.raises(ValueError, match="CUDA device"):
        wc.weight_chain(scores, state, ranges, config, u=u)


class _FakeLib:
    """csrc/weight_chain.cu's entry points, recording each call."""

    def __init__(self):
        self.calls = []

    def mcmh_weight_chain_scratch_floats(self, n):
        return 32 + 12 * min(1024, -(-n // 256)) + n

    def mcmh_weight_chain_mh(self, args, stream):
        self.calls.append(("mh", args))
        return 0

    def mcmh_weight_chain_estimate(self, args, stream):
        self.calls.append(("estimate", args))
        return 0


@pytest.mark.parametrize("n", [5000, 130_048, 1_000_000])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_wrapper_launches_the_kernels(monkeypatch, name, n):
    """On a card's tensors (meta tensors and a stand-in library here) the
    wrapper calls none of the plain chain's functions, launches four
    passes (five for "anchor") at every size, counts them as
    ``weight_chain`` and hands the config's flags over."""
    config = _config(name)
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)

    def forbidden(*a, **k):
        raise AssertionError("a plain chain function ran on the card path")

    for f in ("weight_chain_plain", "softmax_weights", "asymmetric_mh",
              "symmetric_mh", "motion_density", "refresh_anchor",
              "estimate_pose", "estimate_pose_cluster",
              "effective_sample_size"):
        monkeypatch.setattr(wc, f, forbidden)
    _cuda.reset_launch_counts()
    state, scores, ranges, u = _meta_inputs(n, config)
    try:
        r = wc.weight_chain(scores, state, ranges, config, u=u)
        launched = _cuda.launch_counts().get("weight_chain", 0)
    finally:
        _cuda.reset_launch_counts()
    assert launched == wc.launches(config) <= 5
    assert launched == (5 if config.estimate_mode == "anchor" else 4)
    assert [c[0] for c in lib.calls] == ["mh", "estimate"]
    args = lib.calls[0][1]
    assert args is lib.calls[1][1] and args.n == n
    assert args.mh == (0 if not config.use_mh
                       else 2 if config.asymmetric else 1)
    assert args.carry == int(config.resample_ess_threshold < 1.0)
    assert args.sum_agg == int(config.score_aggregation == "sum")
    assert args.est_mode == ("mean", "cluster", "anchor").index(
        config.estimate_mode)
    assert args.margin_on == int(config.anchor_score_margin > 0)
    assert args.adaptive == int(config.use_adaptive)
    assert args.ref_w_avg == int(config.ref_compat_w_avg)
    assert args.range_step == config.step and args.n_ranges == 360
    assert r.estimate.cov.shape == (3, 3) and r.weights.shape == (n,)
    assert (r.particles is state.particles) == (not config.use_mh)


def test_beam_count_is_the_step_count():
    """``filter/step.py::_beam_count`` (the distributed step's) is the
    chain's count: finite beams short of max_range, every step-th."""
    from mcmh_localization_tpu_torch.filter.step import _beam_count

    r = torch.tensor([1.0, float("inf"), 4.99, 5.0, float("nan"), 0.3, 7.0])
    for step in (1, 2, 3):
        config = FilterConfig(step=step, max_range=5.0)
        want = sum(1 for x in r[::step].tolist()
                   if np.isfinite(x) and x < 5.0)
        assert int(wc.beam_count(r, config)) == want
        assert int(_beam_count(r, config)) == want


def test_smoke_phase_helpers_on_the_cpu():
    """``chip_smoke.py``'s ``[weight_chain]`` helpers: the four cells'
    inputs (a padded count) on the CPU, the plain chain against itself
    reads no error and passes the checks, a weight off by 1e-4 or a
    flipped accept beyond the bound fails them, and the byte count is the
    inputs read once and the outputs written once."""
    import chip_smoke as cs

    for tag, _ in cs.CHAIN_SHAPES:
        cfg = cs.chain_config(tag)
        state, s, ranges, u = cs.chain_inputs(700, cfg, torch.device("cpu"), 5)
        assert int(state.count) == 600 and s.shape == (1400,)
        r = wc.weight_chain_plain(s, state, ranges, cfg, u)
        err = cs.chain_errors(r, r, 600)
        assert err["flips"] == 0 and err["weights"] == 0.0
        cs.check_chain(tag, err, 600)
        bad = r._replace(weights=r.weights * (1 + 1e-4))
        with pytest.raises(RuntimeError, match="weights error"):
            cs.check_chain(tag, cs.chain_errors(bad, r, 600), 600)
        flipped = r._replace(particles=r.particles + 1.0)
        with pytest.raises(RuntimeError, match="flipped accepts"):
            cs.check_chain(tag, cs.chain_errors(flipped, r, 600), 600)
    small = cs.chain_config("small")
    assert cs.chain_bytes(10, small, 360) == 10 * 56 + 4 * 360
    big = cs.chain_config("big")
    assert cs.chain_bytes(10, big, 360) == 10 * 52 + 4 * 360
    for kw in cs.CHAIN_VARIANTS.values():
        cs.chain_config("small", **kw)
