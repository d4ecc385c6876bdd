"""The port's entry-point twin (``graft_entry.py``) against
``__graft_entry__.py::entry``: the flagship AMHAMCL step on its procedural
room, run on the CPU and held to the JAX step on the JAX draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as jentry  # noqa: E402
from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter.step import (  # noqa: E402
    _correct as j_correct,
    _predict as j_predict,
)
from mcmh_localization_tpu.maps.grid_map import (  # noqa: E402
    build_grid_map as j_build_grid_map,
)
from mcmh_localization_tpu.models.sensor import (  # noqa: E402
    log_likelihood_field as j_log_field,
)
from mcmh_localization_tpu_torch import graft_entry  # noqa: E402
from mcmh_localization_tpu_torch.convert import (  # noqa: E402
    STATE_FIELDS,
    state_from_numpy,
)
from mcmh_localization_tpu_torch.filter.step import _correct, _predict  # noqa: E402
from mcmh_localization_tpu_torch.filter.step import make_model  # noqa: E402
from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map  # noqa: E402
from tests.test_torch_filter import _scan_draws  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401


def _t(x):
    return torch.from_numpy(np.array(x))


def test_entry_runs_on_the_cpu():
    """Twin of tests/test_graft_entry.py::test_entry_compiles_and_runs:
    ``fn(*args)`` on the CPU gives a finite estimate with 4096 particles;
    the config is the flagship AMHAMCL the JAX entry point builds."""
    fn, args = graft_entry.entry(device="cpu")
    state, info = fn(*args)
    assert np.isfinite(info.estimate.mean.numpy()).all()
    assert state.particles.shape[0] == 4096
    cfg = graft_entry.entry_config()
    want = JConfig(mode="AMHAMCL", num_particles=4096, min_particles=256,
                   max_particles=4096, initialized=True,
                   initial_pose=(0.0, 0.0, 0.3))
    assert {f: getattr(cfg, f) for f in want.__dataclass_fields__} == {
        f: getattr(want, f) for f in want.__dataclass_fields__}


def test_entry_runs_on_the_card_unless_told_otherwise():
    """``entry()`` builds on the card; without one it raises (no CPU
    fallback), and ``device="cpu"`` builds on the CPU."""
    if torch.cuda.is_available():  # decided here, never at import
        _, args = graft_entry.entry()
        assert args[0].particles.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graft_entry.entry()
    _, args = graft_entry.entry(device="cpu")
    assert all(t.device.type == "cpu" for t in args[1:])


def test_entry_step_matches_jax_on_shared_draws():
    """One step of the entry's ``fn`` from JAX's initial state (carried
    across with ``state_from_numpy``), on JAX's example scan and the JAX
    step's draws, against the JAX entry's step, at
    tests/test_torch_filter.py::test_one_scan_matches_jax_on_shared_draws'
    tolerances.  The JAX map is JAX's ``build_grid_map`` on the same
    occupancy (``__graft_entry__._build_map`` reads the reference's map
    where it exists); the port's example scan is JAX's within the ray
    march's step."""
    n = graft_entry.ROOM_CELLS
    occ = graft_entry.room_occupancy(n)
    jmap = j_build_grid_map(occ, graft_entry.ROOM_RES, (-n * 0.05, -n * 0.05),
                            edt_impl="scipy")
    jcfg = JConfig(mode="AMHAMCL", num_particles=4096, min_particles=256,
                   max_particles=4096, initialized=True,
                   initial_pose=(0.0, 0.0, 0.3))
    js, ranges, angles, delta = jentry._example_inputs(jmap, jcfg, n_beams=360)
    jlog = j_log_field(jmap, jcfg)
    js2, jinfo = j_correct(j_predict(js, delta, jmap, jcfg), ranges, angles,
                           jmap, jlog, jcfg)

    fn, (_, t_ranges, t_angles, t_delta) = graft_entry.entry(device="cpu")
    # torch.linspace and jnp.linspace round an ulp apart
    np.testing.assert_allclose(t_angles.numpy(), np.asarray(angles), rtol=0,
                               atol=2.5e-7)
    np.testing.assert_array_equal(t_delta.numpy(), np.asarray(delta))
    # the ray march steps 0.01 m: an ulp of cos/sin may move a hit a step
    assert np.abs(t_ranges.numpy() - np.asarray(ranges)).max() <= 0.0100001

    n_max = 4096
    draws = _scan_draws(js.key, n_max, max(131072, 256 + 256 // 4),
                        jmap.free_xy.shape[0])
    sub = jax.random.split(js.key)[1]
    draws.motion = _t(jax.random.normal(sub, (jcfg.motion_retries, n_max, 3),
                                        jnp.float32))
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in STATE_FIELDS},
                          device="cpu")
    tmap = build_grid_map(occ, graft_entry.ROOM_RES, (-n * 0.05, -n * 0.05),
                          device="cpu")
    model = make_model(graft_entry.entry_config(), tmap)
    ts2, tinfo = _correct(
        _predict(ts, _t(delta), tmap, model.config, draws), _t(ranges),
        _t(angles), tmap, model.log_field, model.config, draws)

    count = int(jinfo.count)
    assert int(tinfo.count) == count
    np.testing.assert_allclose(tinfo.estimate.mean.numpy(),
                               np.asarray(jinfo.estimate.mean), atol=1e-4)
    for f in ("ess", "w_slow", "w_fast", "p_random", "anchor_mass",
              "accept_rate"):
        np.testing.assert_allclose(float(getattr(tinfo, f)),
                                   float(getattr(jinfo, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    w_j, w_t = np.asarray(js2.weights), ts2.weights.numpy()
    np.testing.assert_allclose(w_t, w_j, rtol=1e-4, atol=1e-4 * w_j.max())
    p_j, p_t = np.asarray(js2.particles)[:count], ts2.particles.numpy()[:count]
    moved = np.abs(p_j - p_t).max(axis=1) > 1e-4
    assert moved.mean() <= 0.005, moved.mean()


def test_dryrun_multichip_on_four_gloo_ranks(tmp_path):
    """Twin of tests/test_graft_entry.py's dry run: the five parts pass on
    4 gloo ranks with ``device="cpu"``; asked for 8 ranks of those 4, every
    rank raises; with no device named it asks for the card and, there
    being none, raises rather than run on the CPU."""
    from tests import torch_ranks

    pool = torch_ranks.RankPool(4, tmp_path)
    try:
        assert pool.run(torch_ranks.dryrun, 4) == ["ok"] * 4
        for msg in pool.run(torch_ranks.dryrun, 8):
            assert "needs a process group of 8 ranks, have 4" in msg
        for msg in pool.run(torch_ranks.dryrun, 4, None):
            assert "no CUDA device is available" in msg
    finally:
        pool.close()


def test_dryrun_multichip_raises_without_a_group():
    """With no process group the dry run raises: it starts none and falls
    back to no other device."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="needs a process group of 1"):
        graft_entry.dryrun_multichip(1)
    assert not dist.is_initialized()
