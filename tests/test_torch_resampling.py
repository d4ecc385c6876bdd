"""The port's resampling (ops/resampling.py) against the JAX package on
shared weights and draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.ops import resampling as jres  # noqa: E402
from mcmh_localization_tpu_torch.ops import resampling as tres  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401


def _t(x):
    return torch.from_numpy(np.array(x))


def test_softmax_and_ess_match_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(0, 30, 5000).astype(np.float32)
    mask = np.arange(5000) < 3700
    want = np.asarray(jres.softmax_weights(jnp.asarray(s), jnp.asarray(mask)))
    got = tres.softmax_weights(_t(s), _t(mask)).numpy()
    # f32 sums in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    assert (got[~mask] == 0).all()
    np.testing.assert_allclose(
        float(tres.effective_sample_size(_t(want))),
        float(jres.effective_sample_size(jnp.asarray(want))), rtol=1e-5)


def _integer_weights(n, rng, kind):
    """Integer-valued f32 weights: every cumsum order is exact, so both
    sides get the same segment bounds (kld_resample normalizes inside)."""
    w = {"spread": rng.integers(1, 9, n),
         "peaked": np.where(rng.random(n) < 0.02, 64, 0)}[kind]
    w[0] = max(w[0], 1)
    return w.astype(np.float32)


def test_systematic_indices_match_jax():
    rng = np.random.default_rng(1)
    n = 8192
    w = _integer_weights(n, rng, "spread")
    key = jax.random.PRNGKey(5)
    for count in (None, 6000):
        c = None if count is None else jnp.int32(count)
        want = np.asarray(jres.systematic_resample_indices(key, jnp.asarray(w),
                                                           n, count=c))
        r = jax.random.uniform(key, (), minval=0.0, maxval=1.0)
        got = tres.systematic_resample_indices(_t(w), n, count=count,
                                               r=_t(r)).numpy()
        keep = n if count is None else count
        np.testing.assert_array_equal(got[:keep], want[:keep])


def _kld_draws(key, n_max, w1):
    """The JAX kld_resample's draws, from its key splits (:366-376)."""
    k_idx, k_noise, k_tail = jax.random.split(key, 3)
    rows = w1 if w1 < n_max else n_max
    return dict(
        r=_t(jax.random.uniform(k_idx, (), minval=0.0, maxval=1.0)),
        noise=_t(jax.random.normal(k_noise, (rows, 3), jnp.float32)),
        noise_tail=(_t(jax.random.normal(k_tail, (n_max - w1, 3),
                                         jnp.float32))
                    if w1 < n_max else None),
    )


def _cloud(n, rng, spread):
    return np.stack([rng.normal(1.0, spread, n), rng.normal(-0.5, spread, n),
                     rng.uniform(-np.pi, np.pi, n) if spread > 1
                     else rng.normal(0.3, 0.05, n)], 1).astype(np.float32)


CASES = ["monolithic", "stage1_stop", "escalated", "eval_window", "new_bin",
         "min_eq_max"]


@pytest.mark.parametrize("case", CASES)
def test_kld_resample_matches_jax_on_shared_draws(monkeypatch, case):
    """n_kept equal and the kept samples equal, on the JAX segment bounds
    (a cumsum in another order can move a bound by one) and the JAX jitter
    normals."""
    rng = np.random.default_rng(CASES.index(case))
    n_max, min_p = 4096, 600
    kw = dict(bin_size_xy=0.2, bin_size_theta=0.1745, epsilon=0.03, z=2.0)
    spread = 0.15
    eval_window, stop_rule = 0, "every_sample"
    if case != "monolithic":
        # the stage-1 prefix is 131072 draws; shrink it to reach the
        # escalating path at test size
        monkeypatch.setattr(jres, "_KLD_STAGE1", 1024)
        monkeypatch.setattr(tres, "_KLD_STAGE1", 1024)
    if case == "escalated":
        spread = 3.0                       # diffuse: no stop in the prefix
    if case == "eval_window":
        eval_window = 1500
    if case == "new_bin":
        stop_rule = "new_bin"
    if case == "min_eq_max":
        min_p = n_max
    parts = _cloud(n_max, rng, spread)
    w = _integer_weights(n_max, rng, "spread" if case != "stage1_stop"
                         else "peaked")
    count = 3500
    key = jax.random.PRNGKey(11)
    k_idx = jax.random.split(key, 3)[0]

    def jax_bounds(weights, num_out, count=None, r=None):
        c = None if count is None else jnp.asarray(np.asarray(count))
        return torch.from_numpy(np.array(jres._segment_bounds(
            k_idx, jnp.asarray(weights.numpy()), num_out, c)))

    monkeypatch.setattr(tres, "_segment_bounds", jax_bounds)
    s_j, k_j = jres.kld_resample(
        key, jnp.asarray(parts), jnp.asarray(w), n_max, min_p, count=jnp.int32(count),
        eval_window=eval_window, stop_rule=stop_rule, **kw)
    w1 = max(1024 if case != "monolithic" else 131072, min_p + min_p // 4)
    if case in ("eval_window", "min_eq_max"):
        w1 = n_max                         # one full draw
    s_t, k_t = tres.kld_resample(
        _t(parts), _t(w), n_max, min_p, count=torch.tensor(count, dtype=torch.int32),
        eval_window=eval_window, stop_rule=stop_rule,
        **_kld_draws(key, n_max, w1), **kw)
    n_kept = int(k_j)
    assert int(k_t) == n_kept
    keep = min(n_kept, count)
    # XLA may fuse the jitter's multiply-add into one rounding: samples
    # agree to an ulp of their magnitude (1e-6 relative, 1e-7 near zero).  Inside its jitted escalation the JAX package
    # recomputes the bounds with another fusion of ceil(c * count - r), which
    # can move a bound by one: at most 0.5% of the kept rows may hold
    # another particle
    a, b = s_t.numpy()[:keep], np.asarray(s_j)[:keep]
    moved = np.abs(a - b).max(axis=1) > 1e-5
    assert moved.mean() <= 0.005
    np.testing.assert_allclose(a[~moved], b[~moved], rtol=1e-6, atol=1e-7)
    if case == "escalated":
        assert n_kept > 1024               # the full draw decided the stop
    if case in ("stage1_stop", "monolithic"):
        assert min_p <= n_kept < count     # the stop fired


@pytest.mark.parametrize("n", [1, 7, 1024, 1025, 70_000, 1_100_000])
def test_resampling_cdf_has_one_fixed_association(n):
    """The resampling CDF's cumsum (utils/f32.py::cumsum) sums in one order
    on every device and run: on the card the 1-D torch.cumsum does not (two
    runs differed by an ulp, so a checkpoint resume did not replay its
    estimates bitwise; ROADMAP §3).  At every length around its row of
    1024 it is the exact sum within f32 rounding, it repeats bitwise, and
    the segment bound is built on it."""
    from mcmh_localization_tpu_torch.utils import f32

    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.exponential(size=n).astype(np.float32))
    got = f32.cumsum(x)
    assert got.shape == (n,) and got.dtype == torch.float32
    assert torch.equal(got, f32.cumsum(x.clone()))
    exact = np.cumsum(x.numpy().astype(np.float64))
    assert np.abs(got.numpy() - exact).max() <= 1e-6 * exact[-1]
    w = x / x.sum()
    r = torch.tensor(np.float32(0.37))
    c = f32.cumsum(w)
    c = c / torch.clamp(c[-1], min=1e-30)
    want = torch.clamp(torch.ceil(c * float(n) - r), 0, n).to(torch.int32)
    assert torch.equal(tres._segment_bounds(w, n, None, r), want)
