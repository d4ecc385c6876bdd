"""The port's checkpoints, quaternion helpers, 6x6 covariance packing,
map->odom re-anchoring and ``make_step`` / ``make_run`` against the JAX
package's, on the same inputs, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu import viz as jviz  # noqa: E402
from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter.estimate import (  # noqa: E402
    covariance_6x6 as j_cov6,
)
from mcmh_localization_tpu.filter.step import make_model as j_make_model  # noqa: E402
from mcmh_localization_tpu.utils import angles as jangles  # noqa: E402
from mcmh_localization_tpu.utils.checkpoint import (  # noqa: E402
    save_state as j_save,
)
from mcmh_localization_tpu_torch import viz  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import (  # noqa: E402
    STATE_FIELDS,
    grid_map_from_numpy,
)
from mcmh_localization_tpu_torch.filter import make_run, make_step  # noqa: E402
from mcmh_localization_tpu_torch.filter.estimate import covariance_6x6  # noqa: E402
from mcmh_localization_tpu_torch.filter.state import make_generator  # noqa: E402
from mcmh_localization_tpu_torch.filter.step import Draws, make_model  # noqa: E402
from mcmh_localization_tpu_torch.utils import (  # noqa: E402
    quaternion_from_yaw,
    yaw_from_quaternion,
)
from mcmh_localization_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_state,
    save_state,
    seed_from_jax_key,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

CFG = dict(mode="AMHAMCL", num_particles=300, min_particles=50,
           max_particles=400, initialized=True, initial_pose=(1.0, -1.0, 0.0),
           max_range=5.0)


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


# ---------------------------------------------------------------------------
# quaternions, the 6x6 packing, map->odom
# ---------------------------------------------------------------------------

YAWS = [0.0, 0.5, -2.9, np.pi - 1e-3, 3.0]


@pytest.mark.parametrize("yaw", YAWS)
def test_quaternion_helpers_match_jax(yaw):
    q = quaternion_from_yaw(yaw)
    jq = jangles.quaternion_from_yaw(yaw)
    for got, want in zip(q, jq):
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    got = float(yaw_from_quaternion(*(float(c) for c in q)))
    want = float(jangles.yaw_from_quaternion(*(float(c) for c in jq)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, (yaw + np.pi) % (2 * np.pi) - np.pi,
                               atol=1e-6)


def test_quaternion_helpers_elementwise_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(4, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=0)
    got = yaw_from_quaternion(*map(torch.from_numpy, q)).numpy()
    want = np.asarray(jangles.yaw_from_quaternion(*map(jnp.asarray, q)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    yaw = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    for a, b in zip(quaternion_from_yaw(torch.from_numpy(yaw)),
                    jangles.quaternion_from_yaw(jnp.asarray(yaw))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_covariance_6x6_matches_jax_exactly():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(3, 3)).astype(np.float32)
    cov = a @ a.T
    got = covariance_6x6(torch.from_numpy(cov)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_cov6(jnp.asarray(cov))))
    assert got.dtype == np.float32


POSES = [((1.0, -1.0, 0.3), (0.2, 0.1, -0.4)),
         ((-3.2, 2.5, 3.1), (1.5, -0.7, -3.0)),
         ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))]


@pytest.mark.parametrize("est,odom", POSES)
def test_map_to_odom_transform_matches_jax(est, odom):
    t, q = viz.map_to_odom_transform(est, odom)
    jt, jq = jviz.map_to_odom_transform(est, odom)
    assert t.dtype == np.float64 and q.dtype == np.float64
    np.testing.assert_allclose(t, jt, rtol=0, atol=1e-12)
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-12)
    np.testing.assert_allclose(viz._pose_to_matrix(*est),
                               jviz._pose_to_matrix(*est), rtol=0, atol=1e-12)


def test_tf_reanchorer_matches_jax():
    r, jr = viz.TFReanchorer(stale_after=0.5), jviz.TFReanchorer(stale_after=0.5)
    assert r.on_estimate((1.0, 0.0, 0.0)) is None
    stamps = [(10.0, 10.2), (11.0, 11.0), (12.0, 12.6), (13.0, None)]
    rng = np.random.default_rng(2)
    for odom_stamp, est_stamp in stamps:
        odom = tuple(rng.normal(size=3))
        est = tuple(rng.normal(size=3))
        r.on_odom(*odom, stamp=odom_stamp)
        jr.on_odom(*odom, stamp=odom_stamp)
        got, want = r.on_estimate(est, est_stamp), jr.on_estimate(est, est_stamp)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.keys() == want.keys()
            for k in ("translation", "rotation"):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)
    assert len(r.transforms) == len(jr.transforms) == 3
    assert r.latest()["stamp"] == jr.latest()["stamp"]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _jax_state(house_map, steps=2):
    """A JAX state some scans in (weights, counts and the bookkeeping no
    longer at their initial values)."""
    from tests.test_filter import _simulate

    jm = j_make_model(JConfig(**CFG), house_map)
    st = jm.init(jax.random.PRNGKey(5))
    poses = np.float32([[1.0, -1.0, 0.0], [1.05, -1.0, 0.02],
                        [1.1, -0.99, 0.04]])
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    for t in range(1, steps + 1):
        st, _ = jm.step(st, scans[t], angles, deltas[t])
    return st


def test_jax_checkpoint_loads_bitwise_but_the_key(house_map, tmp_path):
    js = _jax_state(house_map)
    path = str(tmp_path / "jax.npz")
    j_save(path, js)
    ts = load_state(path, device="cpu")
    for f in STATE_FIELDS:
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    # the generator: seeded from the key's words by the stated rule
    key = np.asarray(jax.random.key_data(js.key))
    assert seed_from_jax_key(key) == (int(key[0]) << 32) | int(key[1])
    ref = make_generator(seed_from_jax_key(key), "cpu")
    assert torch.equal(ts.key.get_state(), ref.get_state())
    assert torch.equal(load_state(path, device="cpu").key.get_state(),
                       ref.get_state())


def test_legacy_jax_checkpoint_fallbacks_match_jax(house_map, tmp_path):
    """A checkpoint without the anchor and the streak (pre-round-4/5): the
    fallbacks give JAX's values, bitwise."""
    from mcmh_localization_tpu.utils.checkpoint import load_state as j_load

    js = _jax_state(house_map)
    full = str(tmp_path / "full.npz")
    j_save(full, js)
    with np.load(full) as z:
        legacy = {k: z[k] for k in z.files if k not in ("anchor", "anchor_streak")}
    path = str(tmp_path / "legacy.npz")
    np.savez_compressed(path, **legacy)
    want, got = j_load(path), load_state(path, device="cpu")
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.anchor_streak.dtype == torch.int32


def test_port_checkpoint_round_trip_is_bitwise(torch_map, tmp_path):
    model = make_model(FilterConfig(**CFG), torch_map)
    st = model.init(3)
    st = model.predict(st, torch.tensor([0.1, 0.05, 0.02]))
    torch.rand(17, generator=st.key)  # the stream some way along
    path = str(tmp_path / "port.npz")
    save_state(path, st)
    with np.load(path) as z:
        assert "key" not in z and "torch_generator_state" in z
    back = load_state(path, device="cpu")
    for f in STATE_FIELDS:
        a, b = getattr(st, f), getattr(back, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert torch.equal(back.key.get_state(), st.key.get_state())
    assert back.key is not st.key
    assert torch.equal(torch.rand(5, generator=back.key),
                       torch.rand(5, generator=st.key))


def test_checkpoint_refuses_another_devices_generator(torch_map, tmp_path):
    st = make_model(FilterConfig(**CFG), torch_map).init(0)
    path = str(tmp_path / "port.npz")
    save_state(path, st)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["torch_generator_device"] = np.array("cuda")
    np.savez_compressed(path, **arrays)
    with pytest.raises(ValueError, match="generator"):
        load_state(path, device="cpu")


def test_jax_cannot_load_a_port_checkpoint(torch_map, tmp_path):
    """The direction that does not work: a port checkpoint has no key."""
    from mcmh_localization_tpu.utils.checkpoint import load_state as j_load

    path = str(tmp_path / "port.npz")
    save_state(path, make_model(FilterConfig(**CFG), torch_map).init(0))
    with pytest.raises(KeyError):
        j_load(path)


# ---------------------------------------------------------------------------
# make_step / make_run
# ---------------------------------------------------------------------------

def _draws(n, rng, free, retries):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    u = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32))  # noqa: E731
    return Draws(motion=f(retries, n, 3), mh_u=u(n), kld_r=u(), kld_noise=f(n, 3),
                 inject_cells=torch.from_numpy(rng.integers(0, free, n)),
                 inject_jitter=u(n, 2) - 0.5, inject_theta=u(n) * 6.0 - 3.0)


def test_make_step_and_make_run_match_the_model(house_map, torch_map):
    from tests.test_filter import _simulate

    cfg = FilterConfig(**CFG)
    predict, correct, step, log_field = make_step(cfg, torch_map)
    model = make_model(cfg, torch_map)
    assert torch.equal(log_field, model.log_field)
    poses = np.float32([[1.0, -1.0, 0.0], [1.05, -1.0, 0.02],
                        [1.1, -0.99, 0.04]])
    scans, angles, deltas = (torch.from_numpy(np.array(a)) for a in
                             _simulate(house_map, poses, max_range=5.0))
    rng = np.random.default_rng(4)
    n = 400
    draws = _draws(n, rng, torch_map.free_xy.shape[0], cfg.motion_retries)
    s0 = model.init(1)
    a = model.predict(s0, deltas[1], draws)
    b = predict(s0, deltas[1], draws)
    assert torch.equal(a.particles, b.particles)
    (ca, ia), (cb, ib) = (model.correct(a, scans[1], angles, draws),
                          correct(b, scans[1], angles, draws))
    assert torch.equal(ca.particles, cb.particles)
    assert torch.equal(ia.estimate.mean, ib.estimate.mean)
    (sa, _), (sb, _) = (model.step(s0, scans[1], angles, deltas[1], draws),
                        step(s0, scans[1], angles, deltas[1], draws))
    assert torch.equal(sa.particles, sb.particles)
    assert torch.equal(sa.weights, sb.weights)
    # make_run: the model's run from the same seed gives the same trajectory
    run = make_run(cfg, torch_map)
    ra, infa = run(model.init(2), scans[1:], angles, deltas[1:])
    rb, infb = model.run(model.init(2), scans[1:], angles, deltas[1:])
    assert torch.equal(ra.particles, rb.particles)
    assert torch.equal(infa.estimate.mean, infb.estimate.mean)
