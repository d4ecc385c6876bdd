"""The port's metrics, profiling and visualization utilities against the
JAX package's (tests/test_utils_viz.py), on the CPU: twins of the metrics,
marker, plot and initial-pose tests, JSONL lines equal to
JAX's for the same StepInfo values, particle markers equal to JAX's on the
same particles, a torch.profiler trace, and ``sample_check`` on a map on
the CPU."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu import viz as jviz  # noqa: E402
from mcmh_localization_tpu.filter.estimate import PoseEstimate as JEst  # noqa: E402
from mcmh_localization_tpu.filter.step import StepInfo as JInfo  # noqa: E402
from mcmh_localization_tpu.utils import metrics as jmetrics  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.filter.estimate import PoseEstimate  # noqa: E402
from mcmh_localization_tpu_torch.filter.step import StepInfo, make_model  # noqa: E402
from mcmh_localization_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsLogger,
    read_metrics,
    summarize,
)
from mcmh_localization_tpu_torch.utils import profiling  # noqa: E402
from mcmh_localization_tpu_torch.utils.profiling import span, trace  # noqa: E402
from mcmh_localization_tpu_torch.viz import (  # noqa: E402
    latched_initial_pose,
    particle_markers,
    plot_particles,
    sample_check,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


@pytest.fixture(scope="module")
def model_and_inputs(house_map, torch_map):
    """The JAX module's ``_model_and_inputs``: the port's model, the scans
    ray-cast by the JAX package."""
    from tests.test_filter import _simulate, _square_trajectory

    cfg = FilterConfig(
        mode="MHAMCL", num_particles=128, min_particles=32, max_particles=128,
        initialized=True, initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
    )
    model = make_model(cfg, torch_map)
    scans, angles, deltas = _simulate(house_map, _square_trajectory(6),
                                      max_range=5.0)
    return model, np.asarray(scans), np.asarray(angles), np.asarray(deltas)


def test_metrics_logger(tmp_path, model_and_inputs):
    model, scans, angles, deltas = model_and_inputs
    s = model.init(1)
    path = str(tmp_path / "metrics.jsonl")
    with MetricsLogger(path) as log:
        for t in range(3):
            s, info = model.step(s, scans[t], angles, deltas[t])
            log.log_step(info, wall_ms=1.5)
    recs = read_metrics(path)
    assert len(recs) == 3
    assert {"step", "est", "ess", "accept_rate", "count", "ms"} <= set(recs[0])
    summ = summarize(path)
    assert summ["steps"] == 3
    assert summ["count_mean"] == 128


def test_metrics_log_run(tmp_path, model_and_inputs):
    model, scans, angles, deltas = model_and_inputs
    s = model.init(2)
    s, infos = model.run(s, scans, angles, deltas)
    path = str(tmp_path / "run.jsonl")
    with MetricsLogger(path) as log:
        log.log_run(infos, times=np.arange(scans.shape[0]) * 0.2)
    recs = read_metrics(path)
    assert len(recs) == scans.shape[0]
    assert recs[-1]["t"] == 0.2 * (scans.shape[0] - 1)


def _values(rng, t):
    return {
        "mean": rng.normal(0, 2, (t, 3)).astype(np.float32),
        "cov": np.tile(np.eye(3, dtype=np.float32), (t, 1, 1)),
        "ess": rng.uniform(1, 500, t).astype(np.float32),
        "accept_rate": rng.uniform(0, 1, t).astype(np.float32),
        "count": rng.integers(50, 500, t).astype(np.int32),
        "p_random": rng.uniform(0, 1e-3, t).astype(np.float32),
        "w_slow": rng.uniform(0, 1e-3, t).astype(np.float32),
        "w_fast": rng.uniform(0, 1e-3, t).astype(np.float32),
        "anchor_mass": rng.uniform(0, 1, t).astype(np.float32),
    }


def _infos(vals, port: bool):
    """A StepInfo of the given values for the port or for JAX."""
    scalars = {k: v for k, v in vals.items() if k not in ("mean", "cov")}
    if port:
        return StepInfo(
            PoseEstimate(torch.from_numpy(vals["mean"]),
                         torch.from_numpy(vals["cov"])),
            **{k: torch.from_numpy(np.asarray(v)) for k, v in scalars.items()})
    return JInfo(JEst(jnp.asarray(vals["mean"]), jnp.asarray(vals["cov"])),
                 **{k: jnp.asarray(v) for k, v in scalars.items()})


def test_metrics_lines_equal_jax(tmp_path):
    """The JSONL schema is JAX's: the same StepInfo values give the same
    lines, through log_run and log_step."""
    vals = _values(np.random.default_rng(0), 5)
    for tag, logger, port in (("port", MetricsLogger, True),
                              ("jax", jmetrics.MetricsLogger, False)):
        with logger(str(tmp_path / f"{tag}.jsonl")) as log:
            log.log_run(_infos(vals, port), times=np.arange(5) * 0.2)
            for i in range(2):
                one = _infos({k: v[i] for k, v in vals.items()}, port)
                log.log_step(one, wall_ms=2.5, extra={"tag": i})
    got = (tmp_path / "port.jsonl").read_text()
    assert got == (tmp_path / "jax.jsonl").read_text()
    assert len(got.splitlines()) == 7
    assert (summarize(str(tmp_path / "port.jsonl"))
            == jmetrics.summarize(str(tmp_path / "jax.jsonl")))


def test_trace_writes_a_chrome_trace(tmp_path):
    profiling.enable()
    try:
        with trace(str(tmp_path / "prof")):
            with span("scan"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    finally:
        profiling.enable(False)
        profiling.reset()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "scan" in names


def test_particle_markers_filtering(torch_map):
    particles = np.array(
        [[1.0, 1.0, 0.5], [99.0, 99.0, 0.0], [1.2, 1.0, -0.5]], dtype=np.float32
    )
    weights = np.array([0.6, 0.3, 0.1])
    m = particle_markers(particles, weights, torch_map)
    assert len(m.positions) == 2
    assert m.colors.shape == (2, 3)
    assert m.colors[0, 0] > 0.99 and m.colors[0, 2] < 0.01
    np.testing.assert_allclose(np.linalg.norm(m.quaternions, axis=1), 1.0, atol=1e-6)


def test_particle_markers_match_jax(house_map, torch_map):
    """The same particles (as tensors, cut to a count) give JAX's glyphs."""
    rng = np.random.default_rng(1)
    parts = np.stack([rng.uniform(-5, 5, 400), rng.uniform(-5, 5, 400),
                      rng.uniform(-3, 3, 400)], 1).astype(np.float32)
    w = rng.uniform(0, 1, 400).astype(np.float32)
    got = particle_markers(torch.from_numpy(parts), torch.from_numpy(w),
                           torch_map, count=torch.tensor(300))
    want = jviz.particle_markers(parts, w, house_map, count=300)
    assert 0 < len(got.positions) < 300
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


def test_plot_particles(tmp_path, torch_map):
    rng = np.random.default_rng(0)
    particles = np.stack(
        [rng.uniform(-3, 3, 50), rng.uniform(-3, 3, 50), rng.uniform(-3, 3, 50)],
        axis=1,
    ).astype(np.float32)
    weights = np.full(50, 0.02)
    out = plot_particles(
        torch_map, torch.from_numpy(particles), weights,
        estimate=(0.0, 0.0, 0.0), path=str(tmp_path / "p.png"),
    )
    assert os.path.exists(out)


def test_sample_check(tmp_path, house_occupancy, capsys):
    """sample_check on a map loaded onto the CPU: every sampled pose lies
    on a free cell, and the plot is written."""
    from tests.test_torch_sim_eval import _write_map_yaml

    yaml = _write_map_yaml(tmp_path, house_occupancy, 0.05, (-4.8, -4.8))
    out = sample_check(yaml, n=200, seed=3, out=str(tmp_path / "pb.png"),
                       device="cpu")
    assert os.path.exists(out)
    assert "sampled 200 poses, 200 valid" in capsys.readouterr().out


def test_latched_initial_pose():
    msg = latched_initial_pose(-2.0, -0.5, 0.3)
    assert msg["position"][:2] == (-2.0, -0.5)
    assert msg["covariance"][0] == 0.25 and msg["covariance"][35] == 0.0685
    qz, qw = msg["orientation"][2], msg["orientation"][3]
    assert abs(2 * np.arctan2(qz, qw) - 0.3) < 1e-6
    want = jviz.latched_initial_pose(-2.0, -0.5, 0.3)
    np.testing.assert_array_equal(msg["covariance"], want["covariance"])
    assert {k: v for k, v in msg.items() if k != "covariance"} == {
        k: v for k, v in want.items() if k != "covariance"}
