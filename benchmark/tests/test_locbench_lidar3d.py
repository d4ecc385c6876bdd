"""The 3-D lidar's cell (``building_lidar3d_100k.vlp16_kidnap``) on the CPU
at a small size: a whole run reads ``correct`` and the bfloat16 control
does not; each fault (the program's sensor one voxel high, a reference
that scores the beams leaving the volume as misses) makes ``correct``
false; the module's scorer agrees with the port's ``lidar3d_scores`` on
seeded random poses over a seeded random volume; its map file paints the
building of ``chip_smoke.py``; its reference imports nothing of the port
(the roofline's count is held in ``tests/test_torch_lidar3d_setup.py``)."""

import functools
import time
import types

import numpy as np
import pytest
import torch

from benchmark import harness, world
from benchmark.reference import filter as ref

CELL = "building_lidar3d_100k.vlp16_kidnap"
SEED = 2**31 + 11

# an 8 x 8 x 2 m building of 20 x 80 x 80 voxels at 0.1 m: a floor, outer
# walls, a wall with a door, a table, a hanging shelf and a pillar
SMALL_BUILDING = {
    "name": "small_building", "cells": 80, "layers": 20, "resolution": 0.1,
    "origin": [-4.0, -4.0, 0.0], "nav_z_m": 0.15,
    "boxes": [
        ["occupied", 0, 1, 0, 80, 0, 80], ["occupied", 0, 20, 0, 1, 0, 80],
        ["occupied", 0, 20, 79, 80, 0, 80], ["occupied", 0, 20, 0, 80, 0, 1],
        ["occupied", 0, 20, 0, 80, 79, 80],
        ["occupied", 0, 20, 1, 50, 52, 53], ["free", 1, 20, 30, 38, 52, 53],
        ["occupied", 0, 8, 20, 24, 20, 25],
        ["occupied", 12, 15, 60, 66, 10, 30],
        ["occupied", 0, 20, 60, 63, 40, 43]]}


def small(**filter_keys) -> dict:
    """Overrides that cut the cell to CPU size: the small building, 2000
    particles, 8 rings x 36 azimuths, a 1.5 m lap, few scans."""
    return {
        "map": SMALL_BUILDING,
        "filter": {"num_particles": 2000, "min_particles": 2000,
                   "max_particles": 2000, **filter_keys},
        "traffic": {"n_beams": 288, "azimuths": 36,
                    "ring_elevations_deg": [-15, -11, -7, -3, 1, 5, 9, 13],
                    "side_m": 1.5, "ray_step_m": 0.05, "settle_scans": 8,
                    "kidnap_every": 6, "kidnap_min_dist_m": 2.0},
        "run": {"max_scans_per_s": 200, "profiled_scans": 6,
                "min_window_scans": 16,
                "check": {"scans": 6, "min_scans_per_s": 8, "kidnaps": 1,
                          "after_kidnap": 3}}}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(overrides=None, **kw):
    torch.manual_seed(0)
    return harness.run_cell(CELL, SEED, 1.5, False, "cpu", time.perf_counter(),
                            overrides=overrides or small(),
                            log=lambda *a: None, **kw)


def test_the_cell_reads_correct_and_the_control_does_not():
    out = _run(control=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 4
    prog, ctrl = out["readings"]["program"], out["readings"]["control"]
    assert prog["draws_mismatch"] == 0
    limits = world.load("reference/limits", CELL)
    ok, _ = harness.check.judge(ctrl, limits)
    assert not ok


def test_a_sensor_one_voxel_high_makes_correct_false():
    res = SMALL_BUILDING["resolution"]
    out = _run(small(lidar3d_sensor_z=0.5 + res))
    assert not out["correct"], out["checks"]


def test_volume_exits_scored_as_misses_make_correct_false(monkeypatch):
    """A reference that adds the mixture's floor, log(z_rand / max_range),
    for a valid beam whose endpoint leaves the volume, where the program
    adds 0."""
    real = world.sensor

    def faulty(name):
        mod = real(name)
        if name == "lidar3d":
            def program(prog):
                f = prog.cfg
                miss = float(np.log(f["z_rand"] / f["max_range"]))
                return prog._replace(scorer=functools.partial(
                    mod.volume_scorer, outside=miss))
            mod.program = program
        return mod

    monkeypatch.setattr(world, "sensor", faulty)
    out = _run()
    assert not out["correct"], out["checks"]


# -- the module's scorer against the port's

def _scene(seed, motion_validity="score", aggregation="mean"):
    """A seeded random (6, 30, 40) volume at 0.1 m (10% occupied), its
    navigation layer, a seeded scan of 4 rings x 24 azimuths (some ranges
    past max_range, one not finite) and 400 poses over and past the
    volume."""
    from scipy.ndimage import distance_transform_edt

    rng = np.random.default_rng(seed)
    occ = np.where(rng.random((6, 30, 40)) < 0.1, 100, 0).astype(np.int8)
    lidar3d = world.sensor("lidar3d")
    res, origin = 0.1, (-2.0, -1.5, 0.0)
    vol = lidar3d.Volume(occ, distance_transform_edt(occ <= 50, sampling=res),
                         res, origin, 0.15)
    nav = occ[1]
    w = world.World(nav, world.distance(nav, res), res, origin[:2], vol)
    p = {"azimuths": 24, "ring_elevations_deg": [-10, -3, 4, 11],
         "n_beams": 96, "sensor_z_m": 0.25}
    ranges = torch.from_numpy(rng.uniform(0.1, 4.5, 96).astype(np.float32))
    ranges[5] = float("inf")
    poses = torch.from_numpy(np.stack([
        rng.uniform(-2.3, 2.3, 400), rng.uniform(-1.8, 1.8, 400),
        rng.uniform(-np.pi, np.pi, 400)], 1).astype(np.float32))
    f = {"sigma_hit": 0.3, "z_hit": 0.75, "z_rand": 0.25, "max_range": 4.0,
         "step": 1, "sensor_model": "lidar3d", "lidar3d_sensor_z": 0.25,
         "motion_validity": motion_validity,
         "score_aggregation": aggregation}
    return lidar3d, w, p, ranges, poses, f


def _port_scores(w, p, ranges, poses, f):
    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.maps.voxel_map import (
        build_voxel_map,
        nav_slice,
    )
    from mcmh_localization_tpu_torch.models.sensor import (
        wrap_score_with_validity,
    )
    from mcmh_localization_tpu_torch.models.sensor3d import (
        lidar3d_scores,
        lidar3d_table,
    )

    v = w.own
    vm = build_voxel_map(v.occupancy, v.res, v.origin, device="cpu")
    cfg = FilterConfig(**f)
    table = lidar3d_table(vm, cfg)
    dirs = world.sensor("lidar3d").directions(p)

    def score(q):
        return lidar3d_scores(q, ranges, torch.from_numpy(dirs), vm, cfg,
                              sensor_z=cfg.lidar3d_sensor_z,
                              log_volume=table.levels)
    if cfg.motion_validity == "score":
        score = wrap_score_with_validity(score, nav_slice(vm, z=v.nav_z), cfg,
                                         ranges)
    return score(poses), table.log_volume


def _ref_scores(lidar3d, w, p, ranges, poses, f):
    m = lidar3d.reference_map(w, f, "cpu")
    prog = lidar3d.program(ref.Program(f, poses.shape[0], "single",
                                       f["score_aggregation"], 1.0, False))
    beams = lidar3d.reference_angles(w, p, "cpu")
    return prog.scorer(ranges, beams, m, prog, None, None,
                       torch.float32)(poses)


def _jump(log_volume: torch.Tensor) -> float:
    """The largest difference of the log mixture between face neighbours:
    what one read in the neighbouring voxel moves a beam's term by."""
    return max(float(torch.diff(log_volume, dim=k).abs().max())
               for k in range(3))


@pytest.mark.parametrize("validity,aggregation", [
    ("score", "mean"), ("reject", "mean"), ("score", "sum")])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_scorer_agrees_with_the_port(seed, validity, aggregation):
    lidar3d, w, p, ranges, poses, f = _scene(seed, validity, aggregation)
    got = _ref_scores(lidar3d, w, p, ranges, poses, f)
    want, log_volume = _port_scores(w, p, ranges, poses, f)
    n_valid = int((torch.isfinite(ranges) & (ranges < f["max_range"])).sum())
    per_beam = 1.0 / n_valid if aggregation == "mean" else 1.0
    gap = (got - want).abs()
    # float32 sums of up to 96 terms in two orders (the port in its lanes'
    # order, the reference beam by beam), and the log mixture computed in
    # float64 and rounded once against float32 ops: each term within
    # 2e-7 of the other's, so a score within 1e-5 of the largest term's
    # size a beam
    close = gap <= 1e-5 * max(1.0, per_beam * n_valid)
    # the rest: an endpoint within float32 rounding of a voxel's edge,
    # read in the neighbouring voxel by one side (the port rotates the
    # beam's (u, v) and multiplies by 1 / res, the reference takes
    # cos(theta + a) and divides): at most a pair a pose in 1000 here,
    # each moving the score by one neighbour's difference
    assert close.float().mean() >= 0.99
    assert float(gap.max()) <= 2.0 * _jump(log_volume) * per_beam + 1e-5
    # every pose off a free navigation cell, and only those, reads INVALID
    invalid = want <= -100.0 * (1 if aggregation == "mean" else n_valid)
    assert torch.equal(invalid, got <= -100.0 * (1 if aggregation == "mean"
                                                  else n_valid))
    if validity == "score":
        assert bool(invalid.any())


def test_a_scan_with_no_valid_beam_reads_blind():
    lidar3d, w, p, ranges, poses, f = _scene(0, "reject")
    ranges = torch.full_like(ranges, 9.0)
    got = _ref_scores(lidar3d, w, p, ranges, poses, f)
    want, _ = _port_scores(w, p, ranges, poses, f)
    assert torch.equal(got, torch.full_like(got, ref.BLIND))
    assert torch.equal(got, want)


def test_the_roofline_counts_the_ports_live_beams():
    """The reader's live beams (valid, the endpoint's plane inside the
    volume) are the port's ``scan_beams``'s, on a scan of the small
    building; without a card it reads nothing."""
    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.maps.voxel_map import build_voxel_map
    from mcmh_localization_tpu_torch.models.sensor3d import scan_beams

    reader = world.metric_reader("kernels.voxel_scores_roofline")
    lidar3d = world.sensor("lidar3d")
    conf = world.load("configs", "building_lidar3d_100k")
    p = {**world.load("traffic", "vlp16_kidnap"), **small()["traffic"]}
    w = lidar3d.build_world(conf, SMALL_BUILDING)
    v = w.own
    vm = build_voxel_map(v.occupancy, v.res, v.origin, device="cpu")
    cfg = FilterConfig(**conf["filter"])
    dirs = lidar3d.directions(p)
    poses = torch.tensor([[-1.0, 1.5, 0.3], [2.0, -2.5, -2.0]])
    for r in lidar3d.scanner(w, p, "cpu").clean(poses):
        r = r.clone()
        r[::7] += 2.5          # some past the volume's top, some invalid
        live = scan_beams(r, torch.from_numpy(dirs), vm, cfg,
                          cfg.lidar3d_sensor_z)[3]
        assert reader.live_beams(
            r.double().numpy(), dirs[:, 1].astype(np.float64), cfg.max_range,
            cfg.lidar3d_sensor_z, v.origin[2], v.res, v.occupancy.shape[0]
        ) == int(live.sum())
    run = types.SimpleNamespace(trace=None, loc=types.SimpleNamespace(
        config=cfg))
    assert reader.read(run) is None


@pytest.mark.parametrize("kernel", ["voxel_levels_kernel<1>",
                                    "voxel_f32_kernel"])
def test_the_roofline_reads_the_traced_kernel_over_the_traced_scans(kernel):
    """The share is the bound of the traced scans (the localizer's last
    ``trace.scans``, each at its own live beams) over form (b)'s time in
    the trace, whichever of its two kernels ran; a trace without it, as on
    the CPU or where no 3-D step ran, reads nothing."""
    from mcmh_localization_tpu_torch.config import FilterConfig

    from benchmark import profiled
    from benchmark.counts import peaks, voxel_scores

    reader = world.metric_reader("kernels.voxel_scores_roofline")
    conf = world.load("configs", "building_lidar3d_100k")
    cfg = FilterConfig(**conf["filter"])
    p = world.load("traffic", "vlp16_kidnap")
    dirs = world.sensor("lidar3d").directions(p)
    rng = np.random.default_rng(7)
    ranges = rng.uniform(0.2, 12.0, (40, dirs.shape[0])).astype(np.float32)
    vm = types.SimpleNamespace(origin=(-10.0, -10.0, 0.0), resolution=0.05,
                               depth=60, height=400, width=400)
    slots = 1000
    loc = types.SimpleNamespace(
        config=cfg, scan_count=30, model=types.SimpleNamespace(voxel_map=vm),
        state=types.SimpleNamespace(particles=torch.zeros(slots, 3)))
    traffic = types.SimpleNamespace(ranges=ranges, angles=dirs)

    def summary(ops):
        return profiled.TraceSummary(busy_s=1.0, kernels=10, wall_s=2.0,
                                     scans=5, device_ops=ops, idle_gaps=[])

    ops = [["void (anonymous namespace)::" + kernel + "(float const*, int", 0.004],
           ["void (anonymous namespace)::motion_kernel<false>(MotionArgs)",
            0.5]]
    run = types.SimpleNamespace(trace=summary(ops), loc=loc, traffic=traffic)
    want = 0.0
    for t in range(26, 31):
        live = reader.live_beams(ranges[t].astype(np.float64),
                                 dirs[:, 1].astype(np.float64), cfg.max_range,
                                 cfg.lidar3d_sensor_z, 0.0, 0.05, 60)
        assert 0 < live < dirs.shape[0]
        want += peaks.bound_ms(
            voxel_scores.ops(2 * slots, live, dirs.shape[0]),
            voxel_scores.nbytes(2 * slots, live, dirs.shape[0],
                                60 * 400 * 400))[0]
    assert reader.read(run) == pytest.approx(100.0 * want / 4.0, rel=1e-12)
    run.trace = summary(ops[1:])
    assert reader.read(run) is None


def test_the_map_file_paints_the_building_of_chip_smoke():
    import chip_smoke

    occ = world.sensor("lidar3d").occupancy(world.load("maps", "building"))
    assert np.array_equal(occ, chip_smoke.building_occupancy())


def test_the_reference_imports_nothing_of_the_port():
    """The module's world, scan, angles, map and scorer run without the
    program under test; only ``program_maps`` loads it."""
    from benchmark.tests.test_locbench_imports import _loaded

    body = f"""
import torch
from benchmark import world
from benchmark.reference import filter as ref
lidar3d = world.sensor("lidar3d")
conf = world.load("configs", "building_lidar3d_100k")
conf["filter"].update(max_particles=8, min_particles=8, num_particles=8)
spec = {SMALL_BUILDING!r}
w = lidar3d.build_world(conf, spec)
p = {{**world.load("traffic", "vlp16_kidnap"), "n_beams": 288,
      "azimuths": 36, "ring_elevations_deg": [-15, -11, -7, -3, 1, 5, 9, 13]}}
m = lidar3d.reference_map(w, conf["filter"], "cpu")
beams = lidar3d.reference_angles(w, p, "cpu")
poses = torch.zeros((4, 3))
ranges = lidar3d.scanner(w, p, "cpu").clean(poses)[0]
for prog in ref.programs(conf, lidar3d).values():
    prog.scorer(ranges, beams, m, prog, poses[0], torch.zeros(3),
                torch.float32)(poses)
"""
    assert _loaded(body, ["mcmh_localization_tpu_torch",
                          "mcmh_localization_tpu", "jax"]) == []
