"""The port's tracing (``utils/profiling.py``) on the CPU: off, every hook
is a shared no-op; on, the online localizer's spans carry their parents
and scan numbers, its host syncs count the read sites the CPU path passes,
the step's stage clock stamps every stage once a scan, and the filter's
state is bitwise the same with tracing on and off; under torch.profiler the
spans sit on the trace, nested as they ran."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.filter.captured import STATE_TENSORS  # noqa: E402
from mcmh_localization_tpu_torch.filter.online import (  # noqa: E402
    OnlineLocalizer,
)
from mcmh_localization_tpu_torch.ops import graph as cgraph  # noqa: E402
from mcmh_localization_tpu_torch.ops.trace_stamp import trace_stamp  # noqa: E402
from mcmh_localization_tpu_torch.utils import profiling  # noqa: E402
from tests.test_torch_online import (  # noqa: E402
    ANGLES,
    SINGLE,
    STAGED,
    _advance,
    _scan,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

SCANS = 4
ODOM = 3
SCAN_CHILDREN = ("online.scan.inputs", "online.scan.replay",
                 "online.scan.estimate")


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


@pytest.fixture(scope="module")
def scans(house_map):
    """(odometry poses (SCANS, ODOM, 3), scans (SCANS, beams)) of a short
    drive from the localizers' initial pose."""
    pose = np.array([1.0, -1.0, 0.0])
    odom, ranges = [], []
    for _ in range(SCANS):
        row = []
        for _ in range(ODOM):
            pose = _advance(pose, 0.04)
            row.append(pose.copy())
        odom.append(row)
        ranges.append(_scan(house_map, pose))
    return np.asarray(odom), np.asarray(ranges)


@pytest.fixture
def tracing():
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.enable(False)
        profiling.reset()


def _localizer(torch_map, staged: bool) -> OnlineLocalizer:
    if staged:
        return OnlineLocalizer(FilterConfig(**STAGED), torch_map, seed=3,
                               staged=True, tracking_capacity=1024,
                               tracking_ess_threshold=0.9)
    return OnlineLocalizer(FilterConfig(**SINGLE), torch_map, seed=3)


def _drive(loc, scans):
    odom, ranges = scans
    loc.on_odom(1.0, -1.0, 0.0)
    ests = []
    for row, r in zip(odom, ranges):
        for m in row:
            loc.on_odom(*m)
        ests.append(loc.on_scan(r, ANGLES))
    return ests


def test_off_is_one_shared_noop():
    profiling.enable(False)
    profiling.reset()
    a, b = profiling.span("x"), profiling.span("y", scan=3)
    assert a is b
    with a:
        with b:
            profiling.count("host_sync")
            profiling.stamp("score")
    rec = profiling.records()
    assert rec["name"].size == 0 and rec["names"] == []
    got = profiling.collect()
    assert got["spans"] == {} and got["counters"] == {}


def test_span_columns_grow_and_nest(tracing):
    """Past the preallocated columns the records grow, and parents, scans
    and self times stay right."""
    tracing._spans._alloc(4)
    for s in range(6):
        with profiling.span("outer", scan=s):
            with profiling.span("inner"):
                profiling.count("k", 2)
    rec = profiling.records()
    names = np.asarray(rec["names"])[rec["name"]]
    assert list(names) == ["outer", "inner"] * 6
    assert list(rec["scan"]) == [s for s in range(6) for _ in (0, 1)]
    assert list(rec["parent"]) == [p for i in range(6) for p in (-1, 2 * i)]
    got = profiling.collect()
    outer, inner = got["spans"]["outer"], got["spans"]["inner"]
    assert outer["count"] == inner["count"] == 6
    assert outer["total_ns"] == outer["self_ns"] + inner["total_ns"]
    assert got["counters"] == {"k": 12}


def test_reset_refuses_open_spans(tracing):
    with profiling.span("open"):
        with pytest.raises(RuntimeError, match="spans are open"):
            profiling.reset()


@pytest.mark.parametrize("stage", [0, 1, 4])
def test_trace_stamp_plain_accounts_one_stage(stage):
    """Stage 0 opens a scan and only counts; a later stage adds the time
    since the last stamp."""
    buf = torch.zeros(11, dtype=torch.int64)
    buf[10] = 1
    trace_stamp(buf, stage, 5)
    assert int(buf[5 + stage]) == 1
    assert int(buf[10]) > 1
    assert int(buf[stage]) == (0 if stage == 0 else int(buf[10]) - 1)
    assert int(buf[:5].sum()) == int(buf[stage])


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "single"])
def test_online_spans_scans_and_host_syncs(torch_map, scans, staged,
                                           tracing, monkeypatch):
    loc = _localizer(torch_map, staged)
    loc.warmup(scans[1][0], ANGLES)
    gates = []
    plain = cgraph._host_predicate
    monkeypatch.setattr(cgraph, "_host_predicate",
                        lambda p: gates.append(1) or plain(p))
    profiling.reset()
    _drive(loc, scans)
    rec = profiling.records()
    names = np.asarray(rec["names"])[rec["name"]]
    parent, scan = rec["parent"], rec["scan"]
    assert (rec["end_ns"] >= rec["start_ns"]).all()
    children = SCAN_CHILDREN + (("online.scan.policy",) if staged else ())
    for s in range(SCANS):
        mine = scan == s
        at = lambda n: np.flatnonzero(mine & (names == n))  # noqa: E731
        (top,) = at("online.on_scan")
        assert parent[top] == -1
        for child in children:
            (i,) = at(child)
            assert parent[i] == top
        odom = at("online.on_odom")
        # the very first message only seeds the odometry
        assert len(odom) == ODOM + (1 if s == 0 else 0)
        assert (parent[odom] == -1).all()
        for child in ("online.odom.motion", "online.odom.predict"):
            idx = at(child)
            assert len(idx) == ODOM
            assert set(parent[idx]) <= set(odom)
    assert set(scan) == set(range(SCANS))
    got = profiling.collect()
    spans = got["spans"]
    assert all(v["self_ns"] >= 0 for v in spans.values())
    assert spans["online.on_scan"]["count"] == SCANS
    inner = sum(spans[c]["total_ns"] for c in children)
    assert (spans["online.on_scan"]["total_ns"]
            == spans["online.on_scan"]["self_ns"] + inner)
    # the reads the CPU path passes: the eager gates, the estimate, and
    # the staged policy's scalars
    assert gates
    assert got["counters"]["host_sync"] == (
        len(gates) + SCANS * (2 if staged else 1))
    assert loc.scan_count == SCANS


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "single"])
def test_stage_counts_equal_the_scans(torch_map, scans, staged, tracing):
    loc = _localizer(torch_map, staged)
    profiling.reset()
    _drive(loc, scans)
    stages = profiling.collect()["stages"]
    labels = {"big", "small"} if staged else {"step"}
    ran = {k: v for k, v in stages.items() if v["begin"]["count"]}
    assert set(ran) <= labels
    for st in profiling.STAGES:
        assert sum(v[st]["count"] for v in ran.values()) == SCANS
        assert all(v[st]["ns"] >= 0 for v in ran.values())
    assert sum(v["begin"]["ns"] for v in ran.values()) == 0
    assert sum(v["score"]["ns"] for v in ran.values()) > 0


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "single"])
def test_state_bitwise_with_tracing_on_and_off(torch_map, scans, staged):
    runs = []
    for on in (False, True):
        profiling.reset()
        profiling.enable(on)
        try:
            loc = _localizer(torch_map, staged)
            ests = _drive(loc, scans)
        finally:
            profiling.enable(False)
        runs.append((loc.state, ests, loc.state.key.get_state()))
    profiling.reset()
    (a, ea, ga), (b, eb, gb) = runs
    for f in STATE_TENSORS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(ga, gb)
    for u, v in zip(ea, eb):
        assert u["pose3"] == v["pose3"]
        np.testing.assert_array_equal(u["covariance"], v["covariance"])


def test_profiler_trace_nests_predict_in_on_odom(torch_map, scans, tracing,
                                                 tmp_path):
    loc = _localizer(torch_map, staged=False)
    with profiling.trace(str(tmp_path)):
        _drive(loc, (scans[0][:2], scans[1][:2]))
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    spans = [e for e in events["traceEvents"] if "dur" in e]
    odom = [e for e in spans if e.get("name") == "online.on_odom"]
    predict = [e for e in spans if e.get("name") == "online.odom.predict"]
    assert len(odom) == 2 * ODOM + 1 and len(predict) == 2 * ODOM
    for p in predict:
        assert any(o["tid"] == p["tid"] and o["ts"] <= p["ts"]
                   and p["ts"] + p["dur"] <= o["ts"] + o["dur"]
                   for o in odom)
