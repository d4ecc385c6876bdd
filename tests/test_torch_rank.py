"""Kernel 3's contract: ``rank_in_sorted`` and ``expand_sorted`` take the raw
segment bound, which may dip, and rank against its running max, bitwise as
the JAX functions do on ``jax.lax.cummax`` of it; and ``kld_resample``'s
one bound per resample draws the samples of the two-bound form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu.ops.rank_pallas import (  # noqa: E402
    expand_sorted as j_expand,
    rank_in_sorted as j_rank,
)
from mcmh_localization_tpu_torch.ops import resampling as tres  # noqa: E402
from mcmh_localization_tpu_torch.ops.rank import (  # noqa: E402
    expand_sorted,
    rank_in_sorted,
)
from tests.test_torch_ops import _weights, torch_one_thread  # noqa: E402,F401

N = 16384


def _raw_bound(kind, rng, count):
    """The port's raw bound of ``kind`` weights, with dips injected: at
    segment edges (the bound one or two below its predecessor, as a cumsum
    that lost an ulp across an integer gives), inside flat runs, and a few
    deep ones."""
    w = torch.from_numpy(_weights(kind, N, rng))
    r = torch.tensor(np.float32(rng.random()))
    b = tres._segment_bounds(w, N, count, r).numpy().copy()
    edges = np.flatnonzero(np.diff(b) > 0) + 1
    for i in rng.choice(edges, size=min(64, edges.size), replace=False):
        b[i] = max(b[i - 1] - rng.integers(1, 3), 0)
    flat = np.flatnonzero(np.diff(b) == 0) + 1
    for i in rng.choice(flat, size=min(16, flat.size), replace=False):
        b[i] = max(b[i] - 1, 0)
    b[rng.integers(1, N, 3)] = 0
    dips = int((np.diff(b) < 0).sum())
    assert dips > 10
    return b.astype(np.int32)


@pytest.mark.parametrize("kind", ["exponential", "concentrated",
                                  "leading-zeros"])
@pytest.mark.parametrize("count", [None, 5000], ids=["full", "count_lt_out"])
def test_rank_and_expand_on_raw_bound_bitwise_vs_jax_cummax(kind, count):
    rng = np.random.default_rng(7)
    raw = _raw_bound(kind, rng, count)
    particles = rng.normal(size=(N, 3)).astype(np.float32)
    mono = jax.lax.cummax(jnp.asarray(raw))
    cnt = None if count is None else jnp.int32(count)
    keep = N if count is None else count  # the XLA path has no tail rule
    got_idx = rank_in_sorted(torch.from_numpy(raw), N, count=count).numpy()
    got_exp = expand_sorted(torch.from_numpy(raw), torch.from_numpy(particles),
                            N, count=count).numpy()
    for path, kw in (("xla", {}), ("interpret", dict(interpret=True))):
        want_idx = np.asarray(j_rank(mono, N, count=cnt, **kw))
        want_exp = np.asarray(j_expand(mono, jnp.asarray(particles), N,
                                       count=cnt, **kw))
        n = N if path == "interpret" else keep  # the kernel's tail rule
        np.testing.assert_array_equal(got_idx[:n], want_idx[:n], err_msg=path)
        np.testing.assert_array_equal(got_exp[:n], want_exp[:n], err_msg=path)
    # the tail repeats the last active slot
    if count is not None:
        assert (got_idx[count:] == got_idx[count - 1]).all()
    np.testing.assert_array_equal(got_exp, particles[got_idx])


def test_rank_of_raw_bound_is_first_raw_entry_past_the_slot():
    """The kernel's reasoning: the rank of v in the running max is the
    index of the first raw bound[j] > v."""
    rng = np.random.default_rng(3)
    raw = _raw_bound("exponential", rng, None)
    got = rank_in_sorted(torch.from_numpy(raw), N).numpy()
    v = np.arange(N)
    first = np.array([np.argmax(raw > x) if (raw > x).any() else N - 1
                      for x in v[::97]])
    np.testing.assert_array_equal(got[::97], np.minimum(first, N - 1))


@pytest.mark.parametrize("num_out", [1024, 6000, N])
def test_one_bound_ranks_like_the_bound_at_num_out(num_out):
    """For v < num_out <= max_samples, min(b, num_out) <= v iff b <= v: the
    bound at max_samples gives the draws of the bound at num_out."""
    rng = np.random.default_rng(num_out)
    w = torch.from_numpy(_weights("exponential", N, rng))
    r = torch.tensor(np.float32(rng.random()))
    parts = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    for count in (None, 3500):
        stride = N if count is None else count
        one = tres._segment_bounds(w, N, stride, r)
        own = tres._segment_bounds(w, num_out, stride, r)
        assert torch.equal(expand_sorted(one, parts, num_out, count=stride),
                           expand_sorted(own, parts, num_out, count=stride))


@pytest.mark.parametrize("case", ["monolithic", "stage1_stop", "escalated"])
def test_kld_one_bound_matches_two_bound_form(monkeypatch, case):
    """kld_resample draws every expansion from one bound at max_samples;
    the two-bound form computed a bound at each draw's size.  Same draws,
    same samples and n_kept, bitwise."""
    rng = np.random.default_rng(["monolithic", "stage1_stop",
                                 "escalated"].index(case))
    n_max, min_p, count = 4096, 600, 3500
    if case != "monolithic":
        monkeypatch.setattr(tres, "_KLD_STAGE1", 1024)
    spread = 3.0 if case == "escalated" else 0.15
    parts = torch.from_numpy(np.stack(
        [rng.normal(1.0, spread, n_max), rng.normal(-0.5, spread, n_max),
         rng.normal(0.3, 0.05, n_max)], 1).astype(np.float32))
    w = _weights("concentrated" if case == "stage1_stop" else "exponential",
                 n_max, rng)
    weights = torch.from_numpy(w)
    w1 = 1024 if case != "monolithic" else n_max
    draws = dict(r=torch.tensor(np.float32(rng.random())),
                 noise=torch.from_numpy(rng.normal(
                     size=(w1, 3)).astype(np.float32)),
                 noise_tail=(torch.from_numpy(rng.normal(
                     size=(n_max - w1, 3)).astype(np.float32))
                     if w1 < n_max else None))
    kw = dict(bin_size_xy=0.2, bin_size_theta=0.1745, epsilon=0.03, z=2.0,
              count=torch.tensor(count, dtype=torch.int32), **draws)
    s_one, k_one = tres.kld_resample(parts, weights, n_max, min_p, **kw)

    expand = tres.expand_sorted

    def own_bound(bound, particles, num_out, count=None):
        return expand(tres._segment_bounds(weights, num_out, count,
                                           draws["r"]),
                      particles, num_out, count=count)

    monkeypatch.setattr(tres, "expand_sorted", own_bound)
    s_two, k_two = tres.kld_resample(parts, weights, n_max, min_p, **kw)
    assert int(k_one) == int(k_two)
    assert torch.equal(s_one, s_two)
    if case == "escalated":
        assert int(k_one) > 1024
    if case == "stage1_stop":
        assert min_p <= int(k_one) <= 1024


# ---------------------------------------------------------------------------
# kernel 4 under the weight patterns that stress its load balance
# ---------------------------------------------------------------------------

PATTERNS = ["uniform", "heavy first", "heavy last", "heavy middle",
            "1% of particles", "zero runs", "dips injected"]
# (num_out, count, the bound's stride): a full draw; count < num_out (the
# tail repeats slot count - 1); num_out < R, the KLD stage-1 shape scaled
# down (a bound at stride R clamped at num_out)
SHAPES = {"full": (N, None, N), "count_lt_out": (N, N // 3 + 5, N // 3 + 5),
          "out_lt_r": (N // 8, N, N)}


def _pattern_bound(kind, rng, num_out, stride):
    """The raw bound of a systematic draw over weights of ``kind`` (the
    patterns of chip_smoke.py::rank_bound, at this size)."""
    w = np.zeros(N)
    if kind == "uniform":
        w[:] = 1.0
    elif kind.startswith("heavy"):
        w[{"heavy first": 0, "heavy last": N - 1, "heavy middle": N // 2}[kind]] = 1.0
    elif kind == "1% of particles":
        w[rng.choice(N, N // 100, replace=False)] = 1.0
    elif kind == "zero runs":
        w = ((np.arange(N) // (N // 20)) % 3 == 1).astype(np.float64)
    else:
        w = rng.exponential(size=N)
    w = torch.from_numpy((w / w.sum()).astype(np.float32))
    r = torch.tensor(np.float32(rng.random()))
    b = tres._segment_bounds(w, num_out, stride, r).numpy().copy()
    if kind == "dips injected":
        edges = np.flatnonzero(np.diff(b) > 0) + 1
        for i in rng.choice(edges, size=min(256, edges.size), replace=False):
            b[i] = max(b[i - 1] - rng.integers(1, 3), 0)
        assert (np.diff(b) < 0).sum() > 10
    return b.astype(np.int32)


def _kernel4_model(bound, num_out, count, tile, window, piece):
    """csrc/rank.cu's kernel 4 in numpy, one tile at a time: each particle's
    slot range from the running max, a light tile's marks and max-scan, a
    heavy tile's pieces with their first and last owner, each piece a fill
    or an expansion from M.  -1 where no block wrote."""
    r = bound.size
    big = np.iinfo(np.int64).max
    mono = np.maximum.accumulate(bound.astype(np.int64))
    cap = num_out - 1 if count is None else min(count - 1, num_out - 1)
    prev = np.concatenate([[np.iinfo(np.int64).min], mono[:-1]])
    b = mono.copy()
    b[-1] = big
    past = prev > cap
    lo = np.where(past, big, np.maximum(prev, 0))
    hi = np.where(past, big, np.where(b > cap, num_out, b))
    live = hi > lo
    out = np.full(num_out, -1, np.int64)
    pieces = []
    for t0 in range(0, r, tile):
        s = slice(t0, min(t0 + tile, r))
        if not live[s].any():
            continue
        lo_t, hi_t, live_t = lo[s], hi[s], live[s]
        first, last = lo_t[live_t].min(), hi_t[live_t].max()
        if last - first <= window:
            marks = np.full(last - first, -1, np.int64)
            marks[lo_t[live_t] - first] = np.flatnonzero(live_t)
            out[first:last] = t0 + np.maximum.accumulate(marks)
            continue
        start = np.full(tile, big)
        start[:lo_t.size] = lo_t
        for s0 in range(first, last, piece):
            s1 = min(last, s0 + piece)
            j0, j1 = (t0 + np.searchsorted(start, x, side="right") - 1
                      for x in (s0, s1 - 1))
            pieces.append((s0, s1, j0, j1))
    for s0, s1, j0, j1 in pieces:
        idx = np.full(piece, np.iinfo(np.int64).min)
        idx[0] = j0
        for j in range(j0 + 1, j1 + 1):
            idx[mono[j - 1] - s0] = max(idx[mono[j - 1] - s0], j)
        out[s0:s1] = np.maximum.accumulate(idx)[:s1 - s0]
    return out, len(pieces)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", PATTERNS)
def test_rank_patterns_bitwise_vs_jax_interpret(kind, shape):
    """Kernel 4's contract under each pattern: the port (the plain version
    on the CPU) and JAX's kernel in interpret mode on jax.lax.cummax of the
    same raw bound, bitwise, tail included."""
    num_out, count, stride = SHAPES[shape]
    rng = np.random.default_rng(PATTERNS.index(kind))
    raw = _pattern_bound(kind, rng, num_out, stride)
    got = rank_in_sorted(torch.from_numpy(raw), num_out, count=count).numpy()
    want = np.asarray(j_rank(jax.lax.cummax(jnp.asarray(raw)), num_out,
                             count=None if count is None else jnp.int32(count),
                             interpret=True))
    np.testing.assert_array_equal(got, want)
    if count is not None and count < num_out:
        assert (got[count:] == got[count - 1]).all()


@pytest.mark.parametrize("layout", [(256, 512, 64), (4096, 8192, 4096)],
                         ids=["scaled", "kernel"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", PATTERNS)
def test_kernel4_partition_model_matches_plain(kind, shape, layout):
    """The kernel's reasoning, in numpy at its own tile, window and piece
    sizes and at a scaled-down set that makes more tiles heavy: every slot
    written once, equal to the plain version."""
    num_out, count, stride = SHAPES[shape]
    rng = np.random.default_rng(PATTERNS.index(kind))
    raw = _pattern_bound(kind, rng, num_out, stride)
    got, n_pieces = _kernel4_model(raw, num_out, count, *layout)
    want = rank_in_sorted(torch.from_numpy(raw), num_out, count=count).numpy()
    np.testing.assert_array_equal(got, want)
    if kind.startswith("heavy") and num_out > layout[1]:
        assert n_pieces > 0  # the heavy path ran
