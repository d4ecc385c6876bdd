"""The port's monotone take (kernel 8, ops/take.py), the systematic
resampling impls, multinomial indices and the step's systematic, "simple"
and "lvr" resamplers against the JAX package on shared draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter import state as jstate  # noqa: E402
from mcmh_localization_tpu.filter import step as jstep  # noqa: E402
from mcmh_localization_tpu.ops import resampling as jres  # noqa: E402
from mcmh_localization_tpu.ops.take_pallas import (  # noqa: E402
    take_rows_monotone as j_take,
)
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import (  # noqa: E402
    STATE_FIELDS,
    state_from_numpy,
)
from mcmh_localization_tpu_torch.filter import step as tstep  # noqa: E402
from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map  # noqa: E402
from mcmh_localization_tpu_torch.ops import resampling as tres  # noqa: E402
from mcmh_localization_tpu_torch.ops.take import take_rows_monotone  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def torch_map(house_occupancy, house_map):
    # built from the python resolution, as the JAX map is: its free-cell
    # centers then equal the JAX map's bitwise
    return build_grid_map(house_occupancy, 0.05, (-4.8, -4.8),
                          distance=np.asarray(house_map.distance),
                          device="cpu")


def uniform_draws(key, n, free_cells):
    """filter/init.py::init_uniform's draws from its key splits (:39-49)."""
    k_cell, k_off, k_theta = jax.random.split(key, 3)
    return dict(
        inject_cells=_t(jax.random.randint(k_cell, (min(n, 65536),), 0,
                                           free_cells)),
        inject_jitter=_t(jax.random.uniform(k_off, (n, 2), minval=-0.5,
                                            maxval=0.5)),
        inject_theta=_t(jax.random.uniform(k_theta, (n,), minval=-jnp.pi,
                                           maxval=jnp.pi)),
    )


def _integer_weights(n, rng, count=None):
    """Integer-valued f32 weights, zero past ``count``: every cumsum order
    is exact, so both sides get the same draw."""
    w = rng.integers(1, 9, n).astype(np.float32)
    if count is not None:
        w[count:] = 0.0
    return w


# ---------------------------------------------------------------------------
# kernel 8: the monotone take
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["runs", "concentrated"])
def test_take_rows_monotone_bitwise_vs_jax(kind):
    """Bitwise equal to JAX take_rows_monotone in interpret mode (whose
    span check sends the concentrated index, with its wide tiles, to the
    XLA take) and to the plain XLA take."""
    rng = np.random.default_rng(2)
    n, m = 20000, 20000
    src = rng.normal(size=(n, 3)).astype(np.float32)
    if kind == "runs":
        idx = np.sort(rng.integers(0, n, m))
    else:                                   # a concentrated-weight draw
        w = np.where(rng.random(n) < 0.002, 500.0, 1e-6).astype(np.float32)
        idx = np.asarray(jres.systematic_resample_indices(
            jax.random.PRNGKey(1), jnp.asarray(w), m))
    idx = idx.astype(np.int32)
    got = take_rows_monotone(_t(src), _t(idx)).numpy()
    np.testing.assert_array_equal(got, src[idx])
    for interpret in (True, None):
        want = np.asarray(j_take(jnp.asarray(src), jnp.asarray(idx),
                                 interpret=interpret))
        np.testing.assert_array_equal(got, want)
    assert (np.diff(idx) == 0).any()        # runs of repeated rows


def test_systematic_impls_agree_with_jax():
    """"fused" (expansion), "gather" and "mxu" (take kernel) give one draw,
    bitwise, equal to the JAX draw on the same offset."""
    rng = np.random.default_rng(3)
    n, count = 6000, 4500
    parts = rng.normal(size=(n, 3)).astype(np.float32)
    w = _integer_weights(n, rng, count)
    key = jax.random.PRNGKey(7)
    r = _t(jax.random.uniform(key, (), minval=0.0, maxval=1.0))
    want = np.asarray(jres.systematic_resample_particles(
        key, jnp.asarray(parts), jnp.asarray(w), n, count=jnp.int32(count)))
    outs = {impl: tres.systematic_resample_particles(
        _t(parts), _t(w), n, count=count, r=r, impl=impl).numpy()
        for impl in ("fused", "gather", "mxu")}
    for impl, got in outs.items():
        np.testing.assert_array_equal(got, outs["fused"], err_msg=impl)
        np.testing.assert_array_equal(got[:count], want[:count], err_msg=impl)


def test_multinomial_indices_match_jax():
    rng = np.random.default_rng(4)
    n = 5000
    w = _integer_weights(n, rng, 3000)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jres.multinomial_resample_indices(key, jnp.asarray(w), n))
    got = tres.multinomial_resample_indices(
        _t(w), n, u=_t(jax.random.uniform(key, (n,)))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() < 3000


# ---------------------------------------------------------------------------
# the step's resamplers
# ---------------------------------------------------------------------------

RESAMPLERS = {
    "systematic": dict(mode="MHMCL"),
    "systematic_gated": dict(mode="MCL", resample_ess_threshold=0.9),
    "simple": dict(mode="AMCL", adaptive_resampler="simple"),
    "lvr": dict(mode="AMHAMCL", adaptive_resampler="lvr"),
}


def resample_draws(key, cfg, n_max, free_cells):
    """The draws of the JAX resamplers from their key (step.py:407-466)."""
    if not cfg.use_adaptive:
        return dict(resample_r=_t(jax.random.uniform(key, (), minval=0.0,
                                                     maxval=1.0)))
    if cfg.adaptive_resampler == "simple":
        k_rs, k_rand = jax.random.split(key)
        return dict(multinomial_u=_t(jax.random.uniform(k_rs, (n_max,))),
                    **uniform_draws(k_rand, n_max, free_cells))
    k_rs, k_rand, k_coin = jax.random.split(key, 3)
    return dict(resample_r=_t(jax.random.uniform(k_rs, (), minval=0.0,
                                                 maxval=1.0)),
                lvr_coins=_t(jax.random.uniform(k_coin, (n_max,))),
                **uniform_draws(k_rand, n_max, free_cells))


@pytest.mark.parametrize("case", list(RESAMPLERS))
def test_step_resamplers_match_jax(house_map, torch_map, case):
    """Particles bitwise (integer weights: the same draw on both sides),
    weights and p_random as the JAX resampler gives them."""
    cfg_kw = dict(num_particles=3000, max_particles=3000, min_particles=100,
                  min_injection_prob=0.02, **RESAMPLERS[case])
    jcfg, tcfg = JConfig(**cfg_kw), FilterConfig(**cfg_kw)
    rng = np.random.default_rng(5)
    n_max, count = 3000, 2600
    parts = np.stack([rng.uniform(-3, 3, n_max), rng.uniform(-3, 3, n_max),
                      rng.uniform(-np.pi, np.pi, n_max)], 1).astype(np.float32)
    js = jstate.make_state(jnp.asarray(parts[:count]), count,
                           jax.random.PRNGKey(0), n_max)
    js = js.replace(weights=jnp.asarray(_integer_weights(n_max, rng, count)),
                    w_slow=jnp.float32(1.0), w_fast=jnp.float32(0.7))
    key = jax.random.PRNGKey(11)
    if jcfg.use_adaptive:
        fn = {"simple": jstep._resample_amcl_simple,
              "lvr": jstep._resample_amcl_lvr}[jcfg.adaptive_resampler]
        js2, p_j = fn(key, js, house_map, jcfg)
        t_fn = {"simple": tstep._resample_amcl_simple,
                "lvr": tstep._resample_amcl_lvr}[jcfg.adaptive_resampler]
    else:
        js2, p_j = jstep._resample_systematic(key, js, jcfg)
        t_fn = tstep._resample_systematic
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in STATE_FIELDS},
                          device="cpu")
    d = tstep.Draws(**resample_draws(key, jcfg, n_max,
                                     house_map.free_xy.shape[0]))
    ts2, p_t = t_fn(ts, torch_map, tcfg, d)
    np.testing.assert_array_equal(ts2.particles.numpy()[:count],
                                  np.asarray(js2.particles)[:count])
    np.testing.assert_allclose(ts2.weights.numpy(), np.asarray(js2.weights),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(p_t), float(p_j), rtol=1e-6)
    assert int(ts2.count) == int(js2.count) == count
    if jcfg.use_adaptive:
        assert float(p_j) > 0.2            # the random replacements ran
