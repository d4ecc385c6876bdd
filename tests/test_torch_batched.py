"""The port's batched fleet (``parallel/batched.py``) against the JAX
package's: twins of tests/test_batched.py, ``stack_maps`` exactly, and one
scan of a fleet on the JAX draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter.step import make_model as j_make_model  # noqa: E402
from mcmh_localization_tpu.maps.grid_map import (  # noqa: E402
    build_grid_map as j_build_grid_map,
)
from mcmh_localization_tpu.parallel import batched as jbatched  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import (  # noqa: E402
    STATE_FIELDS,
    state_from_numpy,
)
from mcmh_localization_tpu_torch.filter.state import copy_generator  # noqa: E402
from mcmh_localization_tpu_torch.filter.step import Draws, make_model  # noqa: E402
from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map  # noqa: E402
from mcmh_localization_tpu_torch.parallel.batched import (  # noqa: E402
    make_batched_model,
    make_multimap_model,
    stack_maps,
    stack_states,
    state_row,
)
from tests.test_filter import _simulate, _square_trajectory, _wrap  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

RES, ORIGIN = 0.05, (-4.8, -4.8)


def _t(x):
    return torch.from_numpy(np.array(x))


def _walled(occ):
    """tests/test_batched.py's second map: the house with an extra wall."""
    occ2 = occ.copy()
    occ2[100:160, 60] = 100
    return occ2


@pytest.fixture(scope="module")
def maps(house_occupancy):
    """The house and the walled house, each built by both packages from the
    same python resolution and origin."""
    occs = [house_occupancy, _walled(house_occupancy)]
    return ([j_build_grid_map(o, RES, ORIGIN, edt_impl="scipy") for o in occs],
            [build_grid_map(o, RES, ORIGIN, device="cpu") for o in occs])


def test_stack_maps_matches_jax(maps):
    """Two maps with different free counts: every stacked field equals
    JAX's exactly (the shorter free table tiled the same way)."""
    jmaps, tmaps = maps
    f = [m.free_xy.shape[0] for m in tmaps]
    assert f[0] != f[1]
    want = jbatched.stack_maps(jmaps)
    got = stack_maps(tmaps)
    for name in ("occupancy", "distance", "origin", "resolution", "free_xy",
                 "free_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.free_xy.shape == (2, max(f), 2)
    assert (got.res, got.origin_xy) == (tmaps[0].res, tmaps[0].origin_xy)


def test_stack_maps_refuses_other_shapes_and_resolutions(maps, house_occupancy):
    _, tmaps = maps
    with pytest.raises(ValueError, match="shapes differ"):
        stack_maps([tmaps[0], build_grid_map(house_occupancy[:-8], RES, ORIGIN,
                                             device="cpu")])
    with pytest.raises(ValueError, match="resolutions or origins"):
        stack_maps([tmaps[0], build_grid_map(house_occupancy, 0.1, ORIGIN,
                                             device="cpu")])


def test_stack_states_refuses_a_shared_generator(maps):
    _, tmaps = maps
    model = make_model(FilterConfig(mode="MCL", num_particles=64,
                                    initialized=True),
                       tmaps[0])
    st = model.init(0)
    with pytest.raises(ValueError, match="share a generator"):
        stack_states([st, st])
    both = stack_states([st, st.replace(key=copy_generator(st.key))])
    assert both.particles.shape == (2, 64, 3)
    assert state_row(both, 1).key is both.key[1]


def test_batched_three_robots_track(house_map, maps):
    """Twin of tests/test_batched.py::test_batched_three_robots_track: the
    same config and trajectories, each robot within 0.35 m at the end."""
    _, tmaps = maps
    kw = dict(mode="MHMCL", num_particles=128, initialized=True,
              max_range=5.0, initial_pose=(1.0, -1.0, np.pi / 2))
    trajs = []
    for shift in (0, 2, 4):
        trajs.append(_square_trajectory(12 + shift)[shift:][:12])
    scans_all, deltas_all = [], []
    for poses in trajs:
        scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
        scans_all.append(np.asarray(scans))
        deltas_all.append(np.asarray(deltas))
    ranges_seq = np.stack(scans_all, axis=1)     # (T, B, M)
    deltas_seq = np.stack(deltas_all, axis=1)    # (T, B, 3)

    model = make_batched_model(FilterConfig(**kw), tmaps[0], batch=3)
    states = model.init(0, initial_poses=[_wrap(t[0]) for t in trajs])
    assert states.particles.shape == (3, 128, 3)
    assert len({id(k) for k in states.key}) == 3
    states, infos = model.run(states, ranges_seq, np.asarray(angles),
                              deltas_seq)
    est = infos.estimate.mean.numpy()            # (T, B, 3)
    assert est.shape == (12, 3, 3)
    assert states.particles.shape == (3, 128, 3)
    for b, poses in enumerate(trajs):
        true = _wrap(poses[-1])
        err = np.hypot(est[-1, b, 0] - true[0], est[-1, b, 1] - true[1])
        assert err < 0.35, (b, est[-1, b], true)


def _mcl_draws(key, n_max, retries):
    """The JAX MCL step's draws from its key: the motion retries
    (step.py:83) and the systematic offset (step.py:551, :407)."""
    key, sub = jax.random.split(key)
    motion = jax.random.normal(sub, (retries, n_max, 3), jnp.float32)
    _, _, k_rs = jax.random.split(key, 3)
    return Draws(motion=_t(motion),
                 resample_r=_t(jax.random.uniform(k_rs, (), minval=0.0,
                                                  maxval=1.0)))


MCL = dict(mode="MCL", num_particles=64, initialized=True, max_range=5.0,
           initial_pose=(1.0, -1.0, np.pi / 2))


def test_batched_matches_individual(house_map, maps):
    """Twin of tests/test_batched.py::test_batched_matches_individual: MCL,
    64 particles, two robots.  In the port, the batched run equals two
    individual runs bitwise (each on a copy of its robot's generator).
    Against JAX, one batched scan on the JAX states and each robot's JAX
    draws matches the JAX batched step at
    tests/test_torch_filter.py::test_one_scan_matches_jax_on_shared_draws'
    tolerances."""
    _, tmaps = maps
    poses = _square_trajectory(4)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    scans, angles, deltas = (np.asarray(x) for x in (scans, angles, deltas))

    base = make_model(FilterConfig(**MCL), tmaps[0])
    starts = [base.init(seed) for seed in (7, 8)]
    outs = []
    for st in starts:
        s = st.replace(key=copy_generator(st.key))
        for t in range(scans.shape[0]):
            s, info = base.step(s, _t(scans[t]), _t(angles), _t(deltas[t]))
        outs.append(info.estimate.mean)
    model = make_batched_model(FilterConfig(**MCL), tmaps[0], batch=2)
    states = stack_states([st.replace(key=copy_generator(st.key))
                           for st in starts])
    ranges_seq = np.broadcast_to(scans[:, None], (scans.shape[0], 2,
                                                  scans.shape[1]))
    deltas_seq = np.broadcast_to(deltas[:, None], (deltas.shape[0], 2, 3))
    states, infos = model.run(states, ranges_seq, angles, deltas_seq)
    for b in range(2):
        assert torch.equal(infos.estimate.mean[-1, b], outs[b])

    # one scan on the JAX draws
    jcfg = JConfig(**MCL)
    jbase = j_make_model(jcfg, house_map)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    jstates = [jbase.init(k) for k in keys]
    jmodel = jbatched.make_batched_model(jcfg, house_map, batch=2)
    js = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)
    r1 = jnp.broadcast_to(scans[1], (2, scans.shape[1]))
    d1 = jnp.broadcast_to(deltas[1], (2, 3))
    js2, jinfo = jmodel.step(js, r1, jnp.asarray(angles), d1)
    ts = stack_states([state_from_numpy(
        {f: np.asarray(getattr(s, f)) for f in STATE_FIELDS}, device="cpu")
        for s in jstates])
    draws = [_mcl_draws(s.key, 64, jcfg.motion_retries) for s in jstates]
    ts2, tinfo = model.step(ts, np.asarray(r1), angles, np.asarray(d1),
                            draws=draws)
    np.testing.assert_allclose(tinfo.estimate.mean.numpy(),
                               np.asarray(jinfo.estimate.mean), atol=1e-4)
    np.testing.assert_allclose(tinfo.ess.numpy(), np.asarray(jinfo.ess),
                               rtol=1e-4, atol=1e-6)
    w_j, w_t = np.asarray(js2.weights), ts2.weights.numpy()
    np.testing.assert_allclose(w_t, w_j, rtol=1e-4, atol=1e-4 * w_j.max())
    moved = np.abs(np.asarray(js2.particles) - ts2.particles.numpy()).max(
        axis=2) > 1e-4
    assert moved.mean() <= 0.005, moved.mean()


def test_multimap_two_robots_two_maps(house_map, maps):
    """Twin of tests/test_batched.py::test_multimap_two_robots_two_maps: two
    robots on the house and the walled house in one batched filter, each
    within 0.35 m at the end; each robot's field is its own map's."""
    jmaps, tmaps = maps
    poses = _square_trajectory(8)
    scans1, angles, deltas1 = _simulate(jmaps[0], poses, max_range=5.0)
    scans2, _, deltas2 = _simulate(jmaps[1], poses, max_range=5.0)
    ranges_seq = np.stack([np.asarray(scans1), np.asarray(scans2)], axis=1)
    deltas_seq = np.stack([np.asarray(deltas1), np.asarray(deltas2)], axis=1)
    cfg = FilterConfig(mode="MHMCL", num_particles=128, initialized=True,
                       max_range=5.0, initial_pose=(1.0, -1.0, np.pi / 2))
    model = make_multimap_model(cfg, stack_maps(tmaps), batch=2)
    assert model.config.likelihood_impl == "jnp"
    states = model.init(0)
    states, infos = model.run(states, ranges_seq, np.asarray(angles),
                              deltas_seq)
    est = infos.estimate.mean.numpy()
    true = _wrap(poses[-1])
    for b in range(2):
        err = np.hypot(est[-1, b, 0] - true[0], est[-1, b, 1] - true[1])
        assert err < 0.35, (b, est[-1, b], true)
