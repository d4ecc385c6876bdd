"""The port's particle-axis sharding (``parallel/sharding.py``) on gloo
CPU ranks: twins of tests/test_sharding.py.  The sharded step is
``make_model``'s step bit for bit, and on JAX's draws it tracks JAX's
sharded step at test_sharding.py's tolerances (rtol 1e-4, atol 1e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter.step import make_model as j_make_model  # noqa: E402
from mcmh_localization_tpu.parallel.sharding import (  # noqa: E402
    make_mesh as j_make_mesh,
    make_sharded_model as j_make_sharded_model,
    shard_state as j_shard_state,
)
from mcmh_localization_tpu_torch.convert import STATE_FIELDS  # noqa: E402
from mcmh_localization_tpu_torch.parallel import sharding  # noqa: E402
from tests import torch_ranks  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(D)``: a pool of D gloo ranks, started once per module."""
    pools = {}

    def get(world):
        if world not in pools or not pools[world].alive:
            pools[world] = torch_ranks.RankPool(
                world, tmp_path_factory.mktemp(f"store{world}"))
        return pools[world]

    yield get
    for pool in pools.values():
        pool.close()


@pytest.fixture(scope="module")
def house(house_map):
    return {"occupancy": np.asarray(house_map.occupancy),
            "resolution": float(house_map.resolution),
            "origin": np.asarray(house_map.origin),
            "distance": np.asarray(house_map.distance)}


def _inputs(house_map, t=4):
    from tests.test_filter import _simulate, _square_trajectory

    poses = _square_trajectory(t_steps=t)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    return np.asarray(scans), np.asarray(angles), np.asarray(deltas)


def _step_draws(key, cfg, n, free_cells):
    """A single-device JAX step's draws from its key
    (``tests/test_torch_filter.py::_scan_draws``, the motion draw of each
    retry under "reject") as numpy arrays."""
    import dataclasses

    from tests.test_torch_filter import _scan_draws

    d = _scan_draws(key, n, max(131072, cfg.min_particles * 5 // 4),
                    free_cells)
    if cfg.motion_validity != "score":
        sub = jax.random.split(key)[1]
        d.motion = torch.from_numpy(np.array(jax.random.normal(
            sub, (cfg.motion_retries, n, 3), jnp.float32)))
    return {f.name: None if getattr(d, f.name) is None
            else getattr(d, f.name).numpy() for f in dataclasses.fields(d)}


def test_sharded_step_matches_single_device(house_map, house, ranks):
    """Four MHAMCL steps at D = 4: every rank's rows of the sharded run are
    the single-device run's rows bitwise (one generator, copied); from
    JAX's initial state on JAX's draws, the gathered rows and the estimate
    match JAX's sharded step on a 4-device mesh."""
    scans, angles, deltas = _inputs(house_map)
    kw = dict(mode="MHAMCL", num_particles=256, min_particles=32,
              max_particles=256, initialized=True,
              initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0)
    jcfg = JConfig(**kw)
    mesh = j_make_mesh(jax.devices()[:4])
    js = j_make_model(jcfg, house_map).init(jax.random.PRNGKey(0))
    state_np = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    jsharded = j_make_sharded_model(jcfg, house_map, mesh)
    js = j_shard_state(js, mesh)
    draws = []
    for t in range(scans.shape[0]):
        draws.append(_step_draws(js.key, jcfg, 256,
                                 house_map.free_xy.shape[0]))
        js, jinfo = jsharded.step(js, scans[t], angles, deltas[t])

    out = ranks(4).run(torch_ranks.sharded_steps, house, kw, scans, angles,
                       deltas, state_np, draws)
    for r in out:
        assert r["max_particles"] % 4 == 0
        assert r["counts"][0] == r["counts"][1]
        for f in ("particles", "prev_particles", "weights"):
            np.testing.assert_array_equal(r["sharded"][f], r["single"][f])
        np.testing.assert_array_equal(r["means"][0], r["means"][1])
    got = np.concatenate([r["jax_draws"]["particles"] for r in out])
    np.testing.assert_allclose(got, np.asarray(js.particles), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out[0]["jax_draws"]["mean"],
                               np.asarray(jinfo.estimate.mean), rtol=1e-4,
                               atol=1e-5)
    assert out[0]["jax_draws"]["count"] == int(js.count)


def test_sharded_particles_actually_sharded(house, ranks):
    """Each of 4 ranks holds a (256 / 4, 3) block; the count is replicated."""
    kw = dict(mode="MCL", num_particles=256, initialized=True,
              initial_pose=(1.0, -1.0, 0.0), max_range=5.0)
    out = ranks(4).run(torch_ranks.sharded_init, house, kw, 1)
    assert len(out) == 4
    assert all(r["shape"] == (256 // 4, 3) and r["weights"] == (64,)
               for r in out)
    assert len({r["count"] for r in out}) == 1


def test_sharded_run_scan(house_map, house, ranks):
    scans, angles, deltas = _inputs(house_map, t=5)
    kw = dict(mode="AMHAMCL", num_particles=240, min_particles=32,
              max_particles=320, initialized=True,
              initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0)
    out = ranks(4).run(torch_ranks.sharded_run, house, kw, scans, angles,
                       deltas, 2)
    est = out[0]["mean"]
    assert est.shape == (5, 3)
    assert np.isfinite(est).all()
    assert out[0]["max_particles"] % 4 == 0
    for r in out[1:]:
        np.testing.assert_array_equal(r["mean"], est)


def test_adaptive_padding(house, ranks):
    """501 slots pad to 504 on 8 ranks, as on JAX's 8-device mesh."""
    kw = dict(mode="AMCL", num_particles=100, min_particles=10,
              max_particles=501, max_range=5.0)
    out = ranks(8).run(torch_ranks.sharded_init, house, kw, 0)
    assert all(r["max_particles"] == 504 for r in out)
    assert all(r["shape"] == (504 // 8, 3) for r in out)


def test_sharded_corr_impl(house_map, house, ranks):
    """The corr scorer under particle-axis sharding (field built on every
    rank, lookups on the gathered set): finite after 3 steps, still 64 rows
    a rank."""
    scans, angles, deltas = _inputs(house_map, t=3)
    kw = dict(mode="MCL", num_particles=256, initialized=True,
              initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
              likelihood_impl="corr", corr_n_theta=60)
    out = ranks(4).run(torch_ranks.sharded_run, house, kw, scans, angles,
                       deltas, 0, True)
    for r in out:
        assert np.isfinite(r["mean"]).all()
        assert r["rows"] == (64, 3)


def test_make_mesh_needs_a_process_group():
    """No process group here: ``make_mesh`` raises, starting none."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        sharding.make_mesh()
    assert not dist.is_initialized()


class _Mesh:
    """Stands in for ``DeviceMesh``: records the device type asked for."""

    def __init__(self, device_type, ranks, mesh_dim_names):
        self.device_type = device_type


@pytest.mark.parametrize("backend, card, want", [
    ("cpu:gloo,cuda:nccl", True, "cuda"),   # no backend named, a card
    ("undefined", True, "cuda"),            # the same on other versions
    ("cpu:gloo,cuda:nccl", False, "cpu"),
    ("nccl", True, "cuda"),
    ("gloo", True, "cuda"),
    ("gloo", False, "cpu"),
    ("cpu:gloo", True, "cpu"),              # the caller's group names the CPU
    ("nccl", False, None),                  # carries CUDA alone, no card
])
def test_make_mesh_device_follows_the_card_not_the_backend_name(
        monkeypatch, backend, card, want):
    """The mesh lies on the card wherever there is one and the group
    carries CUDA tensors, whatever the backend's name reads: a group
    started with no backend named ("cpu:gloo,cuda:nccl", or "undefined")
    gives a CUDA mesh on a host with a card, not a CPU one."""
    import torch.distributed as dist
    import torch.distributed.device_mesh as device_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(device_mesh, "DeviceMesh", _Mesh)
    if want is None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh()
    else:
        assert sharding.make_mesh().device_type == want


@pytest.mark.parametrize("backend, card, device, want", [
    ("cpu:gloo,cuda:nccl", True, None, "cuda:0"),
    ("nccl", True, None, "cuda:0"),
    ("cpu:gloo,cuda:nccl", True, "cpu", "cpu"),
    ("gloo", False, "cpu", "cpu"),
    ("gloo", False, None, "no CUDA device is available"),
    ("cpu:gloo", True, None, "cannot carry tensors on cuda:0"),
    ("nccl", True, "cpu", "cannot carry tensors on cpu"),
])
def test_rank_device_is_the_card_unless_named(monkeypatch, backend, card,
                                              device, want):
    """``rank_device``: the current card by default, raising without one
    (no CPU fallback) and where the group cannot carry its tensors."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    if want in ("cuda:0", "cpu"):
        assert str(sharding.rank_device(device)) == want
    else:
        with pytest.raises(RuntimeError, match=want):
            sharding.rank_device(device)
