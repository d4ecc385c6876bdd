"""A zero-scan trajectory: every ``run`` of the port returns the state it
was given and an empty StepInfo with JAX's shapes and dtypes, as JAX's
``lax.scan`` of length 0 does (the single model, its captured step's T = 0
branch, the batched fleet, and the sharded and distributed models on a
one-rank gloo group)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter.step import make_model as j_make_model  # noqa: E402
from mcmh_localization_tpu.parallel import batched as jbatched  # noqa: E402
from mcmh_localization_tpu.parallel.distributed import (  # noqa: E402
    make_dist_model as j_make_dist_model,
)
from mcmh_localization_tpu.parallel.sharding import (  # noqa: E402
    make_mesh as j_make_mesh,
    make_sharded_model as j_make_sharded_model,
    shard_state as j_shard_state,
)
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.filter.captured import (  # noqa: E402
    STATE_TENSORS,
    CapturedStep,
)
from mcmh_localization_tpu_torch.filter.step import (  # noqa: E402
    StepInfo,
    concat_infos,
    make_model,
    stack_infos,
)
from mcmh_localization_tpu_torch.parallel.batched import (  # noqa: E402
    make_batched_model,
)
from tests import torch_ranks  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401
from tests.test_torch_sharding import house, ranks  # noqa: E402,F401

M = 36
KW = {
    "AMHAMCL": dict(mode="AMHAMCL", num_particles=64, min_particles=32,
                    max_particles=128, initialized=True,
                    initial_pose=(1.0, 1.0, 0.4), max_range=5.0),
    "MCL": dict(mode="MCL", num_particles=64, initialized=True,
                initial_pose=(1.0, 1.0, 0.4), max_range=5.0,
                motion_validity="score"),
}


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


def _fields(infos) -> dict:
    """Each StepInfo field's (shape, dtype name), JAX's or the port's."""
    out = {f: getattr(infos, f) for f in StepInfo._fields if f != "estimate"}
    out.update(mean=infos.estimate.mean, cov=infos.estimate.cov)
    return {f: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for f, x in out.items()}


def _empty_inputs(batch=()):
    angles = np.linspace(-np.pi, np.pi, M).astype(np.float32)
    return (np.zeros((0, *batch, M), np.float32), angles,
            np.zeros((0, *batch, 3), np.float32))


def _jax_run(run, state, batch=()):
    scans, angles, deltas = _empty_inputs(batch)
    _, infos = run(state, jnp.asarray(scans), jnp.asarray(angles),
                   jnp.asarray(deltas))
    return _fields(infos)


def _same_state(a, b) -> bool:
    return (all(torch.equal(getattr(a, f), getattr(b, f))
                for f in STATE_TENSORS)
            and torch.equal(a.key.get_state(), b.key.get_state()))


@pytest.mark.parametrize("mode", list(KW))
def test_single_run_of_zero_scans_matches_jax(house_map, torch_map, mode):
    """``FilterModel.run`` (and ``run_eager``) at T = 0: the state as it
    was, the generator unmoved, and a StepInfo whose every field has JAX's
    shape and dtype exactly: (0, 3) mean, (0, 3, 3) cov, (0,) int32 count,
    (0,) float32 scalars."""
    jm = j_make_model(JConfig(**KW[mode]), house_map)
    want = _jax_run(jm.run, jm.init(jax.random.PRNGKey(0)))
    assert want["count"] == ((0,), "int32") and want["cov"][0] == (0, 3, 3)
    model = make_model(FilterConfig(**KW[mode]), torch_map)
    scans, angles, deltas = (torch.from_numpy(x) for x in _empty_inputs())
    for run in (model.run, model.run_eager):
        st = model.init(0)
        key = st.key.get_state()
        new, infos = run(st, scans, angles, deltas)
        assert _fields(infos) == want
        assert _same_state(new, st) and torch.equal(st.key.get_state(), key)


def test_captured_run_of_zero_scans_replays_nothing(torch_map):
    """``CapturedStep.run``'s zero-scan branch (the captured step itself
    needs the card): clones of the state, the generator unmoved, an empty
    StepInfo, and no capture made."""
    model = make_model(FilterConfig(**KW["AMHAMCL"]), torch_map)
    st = model.init(0)
    key = st.key.get_state()
    cs = CapturedStep.__new__(CapturedStep)
    cs.model, cs.n_max, cs.beams, cs.graph = model, st.n_max, M, None
    scans, angles, deltas = (torch.from_numpy(x) for x in _empty_inputs())
    new, infos = cs.run(st, scans, angles, deltas)
    assert cs.graph is None
    assert _same_state(new, st) and torch.equal(st.key.get_state(), key)
    assert all(getattr(new, f) is not getattr(st, f) for f in STATE_TENSORS)
    eager = model.run_eager(model.init(0), scans, angles, deltas)[1]
    assert _fields(infos) == _fields(eager)


def test_stack_and_concat_of_nothing():
    """No StepInfos stack (or concatenate) to the empty StepInfo, with a
    batch axis behind the scan axis where one is asked for."""
    for fn in (stack_infos, concat_infos):
        got = _fields(fn([], device="cpu", batch=(3,)))
        assert got["mean"] == ((0, 3, 3), "float32")
        assert got["cov"] == ((0, 3, 3, 3), "float32")
        assert got["count"] == ((0, 3), "int32")
        assert got["ess"] == ((0, 3), "float32")


def test_batched_run_of_zero_scans_matches_jax(house_map, torch_map):
    """The batched fleet at T = 0: JAX's vmapped run's (0, B, ...) fields,
    the fleet's states as they were."""
    b = 3
    cfg = KW["MCL"]
    jfleet = jbatched.make_batched_model(JConfig(**cfg), house_map, b)
    want = _jax_run(jfleet.run, jfleet.init(jax.random.PRNGKey(0)), (b,))
    assert want["mean"] == ((0, b, 3), "float32")
    fleet = make_batched_model(FilterConfig(**cfg), torch_map, b)
    st = fleet.init(0)
    keys = [k.get_state() for k in st.key]
    scans, angles, deltas = (torch.from_numpy(x) for x in _empty_inputs((b,)))
    new, infos = fleet.run(st, scans, angles, deltas)
    assert _fields(infos) == want
    assert all(torch.equal(getattr(new, f), getattr(st, f))
               for f in STATE_TENSORS)
    assert all(torch.equal(k.get_state(), k0)
               for k, k0 in zip(new.key, keys))


@pytest.mark.parametrize("mode", list(KW))
def test_sharded_and_dist_runs_of_zero_scans_match_jax(house_map, house,
                                                       ranks, mode):
    """The sharded and the distributed models on a one-rank gloo group at
    T = 0, against JAX's sharded and shard_map runs on a one-device mesh:
    every field's shape and dtype equal, the state as it was."""
    jcfg = JConfig(**KW[mode])
    mesh = j_make_mesh(jax.devices()[:1])
    js = j_make_model(jcfg, house_map).init(jax.random.PRNGKey(0))
    want = {
        "sharded": _jax_run(j_make_sharded_model(jcfg, house_map, mesh).run,
                            j_shard_state(js, mesh)),
        "dist": _jax_run(j_make_dist_model(jcfg, house_map, mesh).run,
                         j_shard_state(js, mesh)),
    }
    angles = _empty_inputs()[1]
    (got,) = ranks(1).run(torch_ranks.zero_scan_runs, house, KW[mode], angles)
    for name in ("sharded", "dist"):
        assert got[name]["infos"] == want[name], name
        assert got[name]["state_equal"] and got[name]["key_unmoved"], name
