"""The benchmark's plain reference of the beam score field
(``benchmark/sensors/beam.py``) against the port: its range table against
``build_range_table``, its scorer against ``beam_field_scores`` on the
window's edges, its first and last bins, escapees, poses off the map and
on cells that are not free, and a scan with no valid beam; each fault of a
reference's window or coarse field making the comparison fail; the
benchmark's ``house_beam_100k.kidnap`` on the CPU at test sizes, correct,
and not correct on a table one bin off; the reference loading nothing of
the port or of JAX; the roofline's counts; and the port's tracing of the
beam field (the tables' span, the coarse build counted every scan)."""

import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import world
from benchmark.counts import beam_field, peaks
from benchmark.reference import filter as ref
from mcmh_localization_tpu_torch.config import FilterConfig
from mcmh_localization_tpu_torch.filter.step import make_model, window_origin_at
from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map
from mcmh_localization_tpu_torch.models.range_table import (
    beam_field_scores,
    build_range_table,
    make_beam_tables,
)
from mcmh_localization_tpu_torch.utils import profiling
from mcmh_localization_tpu_torch.utils.angles import normalize_angle
from tests.test_torch_ops import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
beam = world.sensor("beam")

# a 48 x 48 room at 0.05 m: walls, a block, a wall inside, unknown cells
N_CELLS, RES, ORIGIN = 48, 0.05, (-1.2, -1.2)
K, WIN, BINS, KC = 16, 16, 8, 8
ANCHOR, DELTA = (0.1, 0.2, 2.5), (0.05, 0.02, -0.03)
# f32 sums of up to 360 terms in two orders (the program sums by table
# bin, then over bins; the reference beam by beam): each add rounds at
# 6e-8 of the running sum, so the two differ by well under 1e-5 of the
# largest score
TOL = 1e-5


def _occ() -> np.ndarray:
    occ = np.zeros((N_CELLS, N_CELLS), np.int8)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = 100
    occ[10:14, 20:30] = 100
    occ[25, 25:40] = 100
    occ[30:40, 8:10] = -1
    return occ


def _filter(**kw) -> dict:
    f = dict(mode="AMHAMCL", num_particles=2048, min_particles=2048,
             max_particles=2048, sigma_hit=0.3, z_hit=0.75, z_rand=0.25,
             max_range=1.0, sensor_model="beam", beam_impl="field",
             beam_table_n_theta=K, corr_window_cells=WIN,
             corr_theta_window_bins=BINS, corr_coarse_factor=4,
             corr_coarse_n_theta=KC, coarse_gate_escapees=0,
             motion_validity="score")
    f.update(kw)
    return f


def _world() -> world.World:
    occ = _occ()
    return world.World(occ, world.distance(occ, RES), RES, ORIGIN)


def _poses(window, n: int = 2048) -> torch.Tensor:
    """Poses over the map and past it, then every pose at the centre of a
    cell on or beside the window's edges at the centre of a bin on or
    beside its first and last bins, and poses on a wall and on an unknown
    cell."""
    g = torch.Generator().manual_seed(7)
    span = N_CELLS * RES + 0.3
    rand = torch.stack([torch.rand(n, generator=g) * span + ORIGIN[0] - 0.15,
                        torch.rand(n, generator=g) * span + ORIGIN[1] - 0.15,
                        torch.rand(n, generator=g) * 2 * math.pi - math.pi], 1)
    oy0, ox0, k0 = (int(v) for v in window)
    cells = lambda c0: [c0 - 1, c0, c0 + WIN - 1, c0 + WIN]  # noqa: E731
    bins = [(k0 + d) % K for d in (-1, 0, BINS - 1, BINS)]
    edge = [(ORIGIN[0] + (x + 0.5) * RES, ORIGIN[1] + (y + 0.5) * RES,
             -math.pi + (b + 0.5) * 2 * math.pi / K)
            for x in cells(ox0) for y in cells(oy0) for b in bins]
    walls = [(ORIGIN[0] + 25.5 * RES, ORIGIN[1] + 11.5 * RES, 0.3),
             (ORIGIN[0] + 8.5 * RES, ORIGIN[1] + 35.5 * RES, -1.0)]
    return torch.cat([rand, torch.tensor(edge + walls, dtype=torch.float32)])


def _scan(kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    angles = torch.linspace(-math.pi, math.pi, 360)
    if kind == "blind":
        return torch.full((360,), 1.0), angles
    g = torch.Generator().manual_seed(3)
    return torch.rand(360, generator=g) * 1.3, angles


@pytest.fixture(scope="module")
def maps():
    w = _world()
    gm = build_grid_map(w.occ, RES, ORIGIN, device="cpu")
    return w, gm, beam.reference_map(w, _filter(), "cpu")


def _window(gm) -> torch.Tensor:
    """The program's (oy0, ox0, kstart) at the anchor after the scan's
    odometry, its heading backed off half the rotation."""
    a = torch.tensor(ANCHOR)
    mt = normalize_angle(a[2] - 0.5 * (DELTA[0] + DELTA[2]))
    return window_origin_at(a[0], a[1], mt, gm, FilterConfig(**_filter()), K)


def _program_scores(gm, f: dict, ranges, angles, poses) -> torch.Tensor:
    cfg = FilterConfig(**f)
    return beam_field_scores(poses, ranges, angles, gm, cfg,
                             make_beam_tables(gm, cfg), K, _window(gm))


def _reference_scores(rmap, f: dict, ranges, angles, poses,
                      anchor=ANCHOR) -> torch.Tensor:
    prog = beam.program(ref.Program(f, f["max_particles"], "single",
                                    f.get("score_aggregation", "mean"), 1.0,
                                    False))
    score = prog.scorer(ranges, angles, rmap, prog, torch.tensor(anchor),
                        torch.tensor(DELTA), torch.float32)
    return score(poses)


def _gap(a, b) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


@pytest.mark.parametrize("kind,keys", [
    ("ranges", {}),
    ("ranges", {"score_aggregation": "sum"}),
    ("ranges", {"motion_validity": "reject"}),
    ("blind", {}),
], ids=["mean-score", "sum", "reject", "no-valid-beam"])
def test_scorer_equals_the_references(maps, kind, keys):
    _, gm, rmap = maps
    f = _filter(**keys)
    ranges, angles = _scan(kind)
    assert _window(gm).tolist() == [20, 18, 10]
    poses = _poses(_window(gm))
    sp = _program_scores(gm, f, ranges, angles, poses)
    sr = _reference_scores(rmap, f, ranges, angles, poses)
    assert _gap(sp, sr) <= TOL
    if kind == "blind":
        assert bool((sr == ref.BLIND).all())
        return
    # every kind of pose is there: in the window, escaped, off the map,
    # on a cell that is not free
    mx = ((poses[:, 0] - ORIGIN[0]) / RES).to(torch.int32)
    my = ((poses[:, 1] - ORIGIN[1]) / RES).to(torch.int32)
    in_map = (mx >= 0) & (mx < N_CELLS) & (my >= 0) & (my < N_CELLS)
    inside = (mx >= 18) & (mx < 18 + WIN) & (my >= 20) & (my < 20 + WIN)
    assert int((in_map & inside).sum()) > 64 and int((in_map & ~inside).sum()) > 64
    assert int((~in_map).sum()) > 16
    if keys.get("motion_validity") != "reject":
        assert int((sr < -90).sum()) > 16


@pytest.mark.parametrize("n_theta,max_range", [(16, 1.0), (96, 2.5)])
def test_range_table_equals_the_programs(maps, n_theta, max_range):
    w, gm, _ = maps
    level = beam.level_table(w.occ, float(np.float32(RES)), n_theta,
                             max_range, "cpu")
    levels = torch.from_numpy(beam.levels_of(max_range))
    assert torch.equal(levels[level], build_range_table(gm, n_theta,
                                                        max_range))


# each fault of a reference's window or coarse field: (filter keys, anchor)
FAULTS = {
    "window-one-cell-over": ({}, (ANCHOR[0] + RES, *ANCHOR[1:])),
    "first-bin-one-over": ({}, (*ANCHOR[:2], ANCHOR[2] + 2 * math.pi / K)),
    "coarse-factor-2": ({"corr_coarse_factor": 2}, ANCHOR),
    "coarse-bins-4": ({"corr_coarse_n_theta": 4}, ANCHOR),
    "escapees-blind": ({"corr_coarse_factor": 0}, ANCHOR),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_reference_fault_fails_the_comparison(maps, fault):
    _, gm, rmap = maps
    keys, anchor = FAULTS[fault]
    ranges, angles = _scan("ranges")
    poses = _poses(_window(gm))
    sp = _program_scores(gm, _filter(), ranges, angles, poses)
    sr = _reference_scores(rmap, _filter(**keys), ranges, angles, poses,
                           anchor)
    assert _gap(sp, sr) > 100 * TOL


def test_no_reference_for_a_gated_or_staged_program():
    for keys, role in (({"coarse_gate_escapees": 8}, "single"),
                       ({"beam_impl": "table"}, "single"), ({}, "big")):
        with pytest.raises(NotImplementedError):
            beam.program(ref.Program(_filter(**keys), 2048, role, "mean",
                                     1.0, False))


# the cell at CPU sizes, in a process of its own (the harness refuses a
# process that has loaded JAX): first the reference alone, then the cell,
# then the cell with the reference's table one bin over
CELL_RUN = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from benchmark import world
from benchmark.reference import filter as ref
mod = world.sensor("beam")
w = mod.build_world({}, world.load("maps", "house"))
f = world.load("configs", "house_beam_100k")["filter"]
mod.program(ref.Program(f, 100000, "single", "mean", 1.0, False))
mod.level_table(w.occ[:64, :64], w.res, 8, 1.0, "cpu")
loaded = sorted({k.split(".")[0] for k in sys.modules}
                & {"jax", "jaxlib", "mcmh_localization_tpu",
                   "mcmh_localization_tpu_torch"})
print(json.dumps({"loaded": loaded}), flush=True)
from benchmark import harness
from benchmark.tests.conftest import SMALL_MAP
ov = {"map": SMALL_MAP,
      "traffic": {"settle_scans": 8, "kidnap_every": 6, "kidnap_min_dist_m": 2.0},
      "run": {"max_scans_per_s": 200, "profiled_scans": 6, "min_window_scans": 16,
              "check": {"scans": 6, "min_scans_per_s": 8, "kidnaps": 1,
                        "after_kidnap": 3}},
      "filter": {"num_particles": 2048, "min_particles": 2048,
                 "max_particles": 2048, "beam_table_n_theta": 16,
                 "corr_window_cells": 16, "corr_theta_window_bins": 8,
                 "corr_coarse_n_theta": 8}}
sensor = world.sensor
for shift in (0, 1):
    def shifted(name, shift=shift):
        m = sensor(name)
        made = m.reference_map
        def reference_map(*a, **kw):
            r = made(*a, **kw)
            return r._replace(field=r.field._replace(
                level=torch.roll(r.field.level, shift, 0)))
        m.reference_map = reference_map
        return m
    world.sensor = shifted
    torch.manual_seed(0)
    out = harness.run_cell("house_beam_100k.kidnap", 5, 1.5, False, "cpu",
                           time.perf_counter(), overrides=ov,
                           log=lambda *a: None)
    print(json.dumps({"shift": shift, "correct": out["correct"],
                      "failed": out["failed"], "checks": out["checks"]}),
          flush=True)
"""


@pytest.fixture(scope="module")
def cell_runs():
    res = subprocess.run([sys.executable, "-c", CELL_RUN, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]


def test_the_reference_loads_nothing_of_the_port_or_jax(cell_runs):
    assert cell_runs[0] == {"loaded": []}


def test_the_cell_reads_correct_at_test_sizes(cell_runs):
    run = cell_runs[1]
    assert run["shift"] == 0 and run["failed"] == 0
    assert run["correct"], run["checks"]


def test_a_table_one_bin_off_reads_not_correct(cell_runs):
    run = cell_runs[2]
    assert run["shift"] == 1 and not run["correct"]


def test_beam_field_counts_by_hand():
    # 2 bins of a 3-cell window, 1 coarse bin of 2 x 2 blocks, 5 valid
    # beams of 6, 4 levels, 8 table bins
    assert beam_field.ops(2, 3, 1, 2, 2, 5, 4) == 5 * (18 + 4 + 8)
    assert beam_field.nbytes(8, 2, 3, 1, 2, 2, 6, 4) == \
        4 * 6 * 5 + 8 * (9 + 4) + 4 * (18 + 4)
    # the cell's shapes: 360 valid beams, 51 levels, 96 table bins; the
    # adds bound it
    ops = beam_field.ops(24, 64, 24, 96, 96, 360, 51)
    assert ops == 360 * (24 * 4096 + 24 * 9216 + 102)
    t, by = peaks.bound_ms(ops, beam_field.nbytes(96, 24, 64, 24, 96, 96,
                                                  360, 51))
    assert by == "operations" and abs(t - ops / 67e9) < 1e-12


def _beam_model(device="cpu"):
    occ = _occ()
    gm = build_grid_map(occ, RES, ORIGIN, device=device)
    return make_model(FilterConfig(**_filter()), gm)


def test_tracing_records_the_tables_and_each_coarse_build():
    profiling.reset()
    profiling.enable()
    try:
        model = _beam_model()
        spans = profiling.collect()["spans"]
        assert spans["setup.beam_tables"]["count"] == 1
        ranges, angles = _scan("ranges")
        st = model.init(0, initial_pose=list(ANCHOR))
        profiling.reset()
        for _ in range(3):
            st, _ = model.correct(st, ranges, angles)
        assert profiling.collect()["bodies"] == {"coarse_build": 3}
    finally:
        profiling.enable(False)
        profiling.reset()


def test_tracing_leaves_the_scores_bitwise(maps):
    _, gm, _ = maps
    ranges, angles = _scan("ranges")
    poses = _poses((20, 18, 10))
    off = _program_scores(gm, _filter(), ranges, angles, poses)
    profiling.enable()
    try:
        on = _program_scores(gm, _filter(), ranges, angles, poses)
    finally:
        profiling.enable(False)
        profiling.reset()
    assert torch.equal(off, on)


def test_the_roofline_reader_times_both_builds_at_the_cells_shapes(
        monkeypatch):
    """The reader on the CPU with a stand-in clock: each build called
    once a scan, a share from the counts."""
    reader = world.metric_reader("kernels.beam_field_roofline")
    calls = []

    def clock(fn, runs=20):
        fn()
        calls.append(fn)
        return 1.0

    monkeypatch.setattr(reader._timing, "device_ms", clock)
    monkeypatch.setattr(reader._timing, "_power_line", lambda: "cpu")
    model = _beam_model()
    g = np.random.default_rng(0)
    gt = np.stack([g.uniform(-0.5, 0.5, 8), g.uniform(-0.5, 0.5, 8),
                   g.uniform(-3, 3, 8)], 1)
    traffic = SimpleNamespace(n_beams=360, angles=None, gt=gt,
                              ranges=g.uniform(0.1, 1.3, (8, 360))
                              .astype(np.float32))
    loc = SimpleNamespace(model=model, config=model.config,
                          grid_map=model.grid_map)
    run = SimpleNamespace(loc=loc, cuda=True, device=torch.device("cpu"),
                          traffic=traffic)
    share = reader.read(run)
    assert len(calls) == 2 * reader.SCANS
    assert 0 < share < 1
    # no beam score field: nothing to read
    run.loc = SimpleNamespace(model=SimpleNamespace(log_field=torch.zeros(2)))
    assert reader.read(run) is None
