#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

1. Requires CUDA (exits non-zero without it) and prints the card's name
   and power limit as nvidia-smi reports them.
2. Builds the port's CUDA kernels from ``mcmh_localization_tpu_torch/csrc``
   (one nvcc per source, in parallel).
3. ``[kernel]``: compares every kernel with its plain PyTorch version on
   the card at the main paths' shapes and times both (``device_ms``):
   BIG field K=120 384^2 M=360, SMALL/window field K=32 128^2, coarse field
   K=36 96^2 (bitwise, beside a ``conv2d`` yardstick), lookups of 2x1M and
   2x130048 poses (also on the misaligned view ``parts[1:]``),
   ``gather_2d`` on the SMALL window table and the free mask of the
   "reject" retries (FilterConfig()'s and the 100k exact run's; each also
   on a misaligned view of its indices), kernel 2's two fused forms: (a)
   the range-table scorer at the staged beam BIG program's 2 x 1M poses
   (a mixed cloud around START, 360 beams of the house scan, K=96, the
   table's uint8 level form and its per-scan LUT) and the [beam] table
   run's 2 x 1500, then on 2 x 20k poses each other form the dispatch can
   pick: int16 levels (a table of 400 levels; also at 2 x 150k, where the
   pairs read the index from the table), the per-pair f32 form (a table
   of noise), the LUT in three tiles (every beam valid); and (b) the
   3-D lidar scorer at 2 x 100k poses and 5760 beams on the building's
   log-mixture volume in its level form (16-bit indices in 4 x 4 bricks,
   the levels in shared memory, the beams in tiles of 512), then on 2 x
   20k poses the f32 volume, and the beams in one tile (the first 500)
   in both forms (each ``torch.equal`` to its plain version, with the
   lanes a pose it ran with; (a)'s variants in both aggregations), the
   window-score lookup of 2x1M poses (also on a
   misaligned view of 200 003 of them, in the beam op forms at the beam
   path's geometry and 2x100k poses, and its escapee count at 2x1M), the
   exact scorer at 2x1500 and 2x100k poses in both cell forms (bitwise,
   with the lanes a pose it ran with), the 1M resampling expansion
   (bitwise on the path's raw bound and on one with injected dips, beside
   ``torch.cummax`` of that bound), the rank as indices (the same bounds,
   and seven weight patterns, ``RANK_PATTERNS``, at num_out = 1M, 131 072
   and a count under num_out, bitwise; uniform weights and one heavy
   particle timed) and take, and the beam LUT field at the
   beam path's fine
   (B=24, K=96, 64^2) and coarse (B=24, 96^2) builds (beside their
   shared-memory floor: B*K*C four-byte reads at 128 bytes a clock on each
   of the 132 SMs at the top SM clock nvidia-smi reads), its ``_at`` entry
   (the window read in place at a device-held origin: ``torch.equal`` to
   the launch-argument kernel on the window copied out and to its plain
   version at the path's origin and at both corners) at the same two
   builds and at (F)'s 360 table bins (7 chunks), and the bin-LUT kernel
   (``csrc/bin_lut.cu``, the S matrix: ``torch.equal`` to its plain
   version, beside the one-hot ``torch.einsum``) at (C)'s 24 window bins
   and its one offset row, and at (F)'s 360 field bins.  Each row gives
   its bound (the larger of its operations over the f32 rate and its bytes
   over the HBM rate, from this run's inputs), its share of it, the time
   of one PyTorch call computing the same function where there is one,
   and, at the end, its launches per scan on each path.  Every line with a
   time names the card and its power limit.  Then the sizes the kernels
   refused before the size-limit repairs, each ``torch.equal`` to its
   plain version and timed: the bin slices a D-rank theta-sharded build
   runs (D = 2, 4 and 8, where D divides the bins): kernel 1 at BIG (120
   bins) and SMALL (32), kernel 7 at the beam point's fine and coarse
   builds (24 bins each), every rank's slice ``torch.equal`` to the full
   build's rows, rank 0's timed (kernel 1's beside its conv2d yardstick);
   kernel 7 at the fine and coarse builds of
   ``FilterConfig(sensor_model="beam", corr_window_cells=128)`` at its
   defaults (360 table bins, summed in chunks of bins), kernel 6 at 2 x 100k poses on 2160- and 4096-beam
   scans in both cell forms, form (a) at 2 x 20k poses on a 2160-beam
   scan in its level and per-pair forms, and form (b) at 2 x 20k poses on
   a 32-ring x 1024 = 32 768-beam scan.
4. ``[main]``: the staged main path: AMHAMCL, KLD-adaptive at 1M capacity /
   100k minimum, 360 beams, the staged two-program runner with a 0.9
   tracking ESS gate and the windowed corr scorer, on a procedural 384x384
   house map at 0.05 m, over 4x16 scans of a closed circle; both programs
   replay their steps captured in CUDA graphs (``filter/captured.py``;
   ``warmup_staged`` captures them).  Then times the SMALL (tracking) and
   BIG programs.  Checks the run ends in the SMALL program, estimates are
   finite, the final error is under 0.2 m, and the field build, lookup,
   expansion and conditional-node kernels all launched.
   ``[graph]``: each program's captured step against its eager steps over
   16 scans (SMALL from the settled state, BIG from the start with the
   augmented-MCL averages apart, so it injects): every state field, the
   generator and every StepInfo field ``torch.equal``; a captured chunk
   under ``set_sync_debug_mode("error")``; ms/scan by CUDA events, device
   busy, idle share, kernels a scan and host self time under
   torch.profiler, host syncs a scan, the graph's nodes, each gate's
   conditional body and the scans that ran it, and the device time of
   the work the gates run on every scan; then the conditional node's
   kernel alone (32 IF nodes in a graph, equal to 32 host ifs), and the
   stage stamp of a traced step (``csrc/trace_stamp.cu``): rounds of its
   stages around sleep kernels, its counts equal to its plain version's,
   each stage's time against the CUDA events around the same work.
   ``[online]``: the same configuration through the online facade,
   ``OnlineLocalizer(staged=True)``, whose ``on_scan`` replays each
   program's captured correct step: ``warmup`` (the generator's state
   unchanged), then about 48 scans of the circle with three ``on_odom``
   calls before each ``on_scan``; checks the hand-off to SMALL, an error
   under 0.2 m, a checkpoint taken in SMALL whose resume replays the next
   five estimates bitwise, and that the field build, lookup and expansion
   kernels launched; prints the ms per ``on_scan`` of each program.
5. ``[single]``: the single-program flagship (``make_model``): AMHAMCL at
   1M particles, the windowed corr scorer with its coarse fallback
   (ungated), 16 settle + 16 timed scans; error under 0.2 m, the window
   score and coarse build launched; then its KLD-adaptive twin (100k
   minimum) and the 100k point with the default build gate of 8, timed.
6. ``[exact]``: ``FilterConfig()`` with the exact "pallas" scorer and
   motion_validity="reject" in all six modes (1500 particles, min 100, max
   5000), each under 0.25 m over its last 8 scans with the exact scorer
   and ``gather_2d`` launched; then corr vs exact ms/scan at 1500 and 100k
   particles (where "auto"'s crossover lies on this card).
7. ``[beam]``: the ray-cast beam model at the bench's beam point
   (``bench.py:391-398``): AMHAMCL at 100k particles, the windowed beam
   score field (96 table bins, a 64-cell window with 24 theta bins, the
   coarse fallback at 24 bins behind the build gate of 8), 16 settle + 16
   timed scans, error under 0.2 m, the LUT field and the window score
   launched every scan; then its ESS-gated twin (0.9), and the range-table
   scorer at 1500 particles (error under 0.25 m, kernel 2's fused form (a)
   launched every scan) and the "dense" ray march at 1500.  Each replays
   its captured step, and each has a ``[graph]`` row (``graph_check``:
   captured ``torch.equal`` eager, 0 host syncs a captured scan); (C)'s
   from its settled state with 1% of the cloud spread over the map, so the
   coarse build's gate runs the build on some scans and skips it on
   others.  (F) and (D)'s two programs have ``[graph]`` rows too, and
   the captured BIG program's peak device memory is printed with the
   memory reserved and its graph's private pool.
   ``[beam_staged]``: the same beam point at the main path's capacity
   (KLD, 1M max / 100k min, ``make_staged_model`` with a 0.9 tracking ESS
   gate): BIG is the range-table scorer at 1M with "sum" and the
   injection refill, SMALL the windowed field without the coarse fallback;
   the [main] circle and protocol.  Checks a first 16-scan chunk in BIG,
   a hand-off to SMALL, a final error under 0.2 m, form (a) launched on
   every BIG scan, and the peak device memory over the BIG scans under
   the 2.88 GB of one whole (2N, M) f32 tensor; prints BIG and SMALL
   ms/scan.
   ``[lidar3d]``: the 3-D lidar on a procedural 20 x 20 x 3 m building at
   0.05 m (400 x 400 x 60 voxels: a floor, walls with doors, tables below
   1 m, hanging shelves), a VLP-16-class scanner (16 rings from -15 to +15
   degrees x 360 azimuths = 5760 beams, 10 m range, 0.5 m above the pose
   plane, scans from ``simulate_scan3d`` with 0.01 m noise), the
   navigation slice at 0.1 m; AMHAMCL at 100k, "score", 16 settle + 16
   timed scans; error under 0.2 m, form (b) launched every scan; then
   form (b)'s resampled-cloud row: the 2 x 100k poses the filter scores
   on the next tracked scan, in its slot order (``scored_cloud``),
   ``torch.equal`` to the plain version and timed.
   ``[beam_default]``: ``FilterConfig(sensor_model="beam",
   corr_window_cells=128)`` with every other filter field at its default
   (1500 particles, 360 table bins) on the house, 8 settle + 8 timed
   scans: error under 0.25 m, ``lut_field`` launched every scan.
   ``[exact_2160]``: ``FilterConfig()`` on 2160-beam scans of the circle,
   8 settle + 8 timed: mean error over the last 8 under 0.25 m, the exact
   scorer launched every scan.
   ``[batched]``: a fleet of 4 robots (``parallel/batched.py::
   make_batched_model``) on the house, each at ``[exact]``'s 100k point
   (AMHAMCL, "jnp", "reject"), robot b starting 4b poses along the circle;
   16 settle + 16 timed fleet scans: each robot's final error under 0.2 m,
   robot 0 bitwise its lone ``make_model`` run over 4 scans, kernels 6, 2
   and 3 launched; the fleet's ms/scan beside one robot's alone.
   ``[multimap]``: two robots on the house and the house with an extra
   wall (``make_multimap_model``), MHMCL at 100k, 16 scans: each under
   0.25 m, each robot bitwise its lone model on its own map over 2 scans,
   the two fields' checksums printed.  ``[entry]``:
   ``graft_entry.entry()`` on the card, one step then 16 timed: a finite
   estimate, 4096 particles, kernels 6 and 3 launched.
   ``[edt]``: the house built with ``edt_impl="device"`` (the EDT kernel,
   ``csrc/edt.cu``, two launches a map build; host ms beside the scipy
   build), its field within one ulp of the scipy map's and every other
   field equal; ``FilterConfig()`` on that map, 8 settle + 8 timed scans,
   mean error over the last 8 under 0.25 m.  Then ``[kernel]`` rows of
   the EDT kernel: ``torch.equal`` to its plain version and to scipy's
   squared distances rounded to integers at 37 x 53 (random), the house
   (384^2) and the house tiled to 2048^2 and 4096^2 (squares past 2^24;
   the plain version in chunks of 32 columns there), timed beside its
   bound (5 bytes a cell), the plain version and scipy on the host.
8. ``[eval]``: the experiment runner (``eval/runner.py``) through its CLI
   on the card: the house map written as PGM + YAML and the ``[main]``
   configuration as a params YAML; a simulated ``square`` bag (30 s at
   5 Hz, 360 beams, 0.01 m range noise), round-tripped through npz
   (bitwise), ROS1 and ROS2 bag files; ``single --staged`` at 1M / 100k
   (RMSE under 0.2 m, a hand-off, the results file and 178 metrics lines,
   kernels 1-3 launched) and ``FilterConfig()`` at 1500 particles (RMSE
   under 0.25 m, the exact scorer, ``gather_2d`` and the expansion
   launched), each with its ms/scan by the host clock; ``warmup_staged``
   timed, the generator's state unchanged.
   ``[dist]``: the multi-rank filter (``parallel/distributed.py``,
   ``parallel/sharding.py``, ``filter/staged.py::make_staged_dist_model``)
   on an NCCL process group of one rank in this process, at full width:
   the [single] flagship at 1M through ``make_dist_model``, the [main]
   configuration through ``make_staged_dist_model`` (the hand-off cycle
   big -> shrink -> small -> grow -> big, kept rows bitwise, then
   ``run_staged`` over 16 + 16 scans), [beam]'s field point and
   [lidar3d]'s point through ``make_dist_model`` (each one lap settled,
   one timed: ms/scan and the collectives a scan beside the
   single-program run, final error under 0.2 m; the NCCL group's
   ``DistModel.run`` replays a captured step, its collectives in the
   graph, and each of (A), the staged SMALL and BIG programs, (C) and (E)
   has a ``[graph]`` row against its eager steps), ``make_sharded_model``
   at (B)'s 100k "jnp" point ``torch.equal`` to ``make_model``'s steps,
   and ``graft_entry.dryrun_multichip(1)`` on a group started with no
   backend named, whose mesh and rank device must be the card's.  A run
   with more than one rank needs a machine with more than one card.
9. Prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as
   the last line.

``--profile DIR`` also writes torch.profiler tables and traces of the
timed stretches to DIR, prints each one's device-busy ms/scan and idle
share, and fails if any of them ran a cummax.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_BEAMS = 360
SCAN_LEN = 16
MAP_CELLS = 384
RES = 0.05
START = (0.0, 0.0, 0.3)


def house_occupancy(n: int = MAP_CELLS) -> np.ndarray:
    """Procedural trinary 'house' at map_house's size: an unknown border,
    outer walls, inner walls with doors, and pillars that break symmetry.
    The center cell (the START pose) lies in a free room."""
    occ = np.full((n, n), -1, dtype=np.int8)
    occ[16:n - 16, 16:n - 16] = 0
    occ[16, 16:n - 16] = occ[n - 17, 16:n - 16] = 100
    occ[16:n - 16, 16] = occ[16:n - 16, n - 17] = 100
    occ[16:260, 252] = 100            # vertical wall, door at 150..170
    occ[150:170, 252] = 0
    occ[110, 16:230] = 100            # horizontal wall, door at 60..80
    occ[110, 60:80] = 0
    occ[280, 100:n - 16] = 100        # horizontal wall, door at 200..225
    occ[280, 200:225] = 0
    occ[280:n - 16, 100] = 100        # vertical wall, door at 320..340
    occ[320:340, 100] = 0
    occ[230:240, 150:160] = 100       # pillars
    occ[60:70, 300:312] = 100
    occ[200:208, 120:126] = 100
    return occ


def circle_poses(delta):
    """The SCAN_LEN-periodic closed circle the constant delta traces."""
    r1, tr, r2 = delta
    poses = []
    x, y, th = START
    for _ in range(SCAN_LEN):
        poses.append((x, y, th))
        th = th + r1
        x = x + tr * math.cos(th)
        y = y + tr * math.sin(th)
        th = th + r2
    return np.asarray(poses, dtype=np.float32)


# The 3-D lidar's building: 20 x 20 x 3 m at RES, START at its centre
BUILDING_CELLS = 400
BUILDING_LAYERS = 60
LIDAR_SENSOR_Z = 0.5


def building_occupancy() -> np.ndarray:
    """Procedural (D, H, W) = (60, 400, 400) trinary building at RES
    (9.6M voxels): a floor, outer walls, inner walls with doors, table
    blocks below 1 m and hanging shelves at 1.8-2.3 m, structure a 2-D
    scan at one height does not see (as the JAX tests' ``room3d``).  The
    START pose lies in a free room; there is no ceiling."""
    n, d = BUILDING_CELLS, BUILDING_LAYERS
    occ = np.zeros((d, n, n), dtype=np.int8)
    occ[0] = 100                                  # floor, 0-0.05 m
    occ[:, :4, :] = occ[:, n - 4:, :] = 100       # outer walls, 0.2 m
    occ[:, :, :4] = occ[:, :, n - 4:] = 100
    occ[:, 4:300, 300] = 100                      # inner walls with doors
    occ[:, 120:150, 300] = 0
    occ[:, 100, 4:260] = 100
    occ[:, 100, 60:90] = 0
    occ[:, 290, 100:n - 4] = 100
    occ[:, 290, 220:250] = 0
    occ[:20, 230:250, 150:175] = 100              # tables, below 1 m
    occ[:18, 160:175, 240:270] = 100
    occ[:15, 320:350, 60:100] = 100
    occ[36:44, 180:200, 120:160] = 100            # hanging shelves
    occ[36:46, 220:260, 260:280] = 100
    occ[40:46, 110:130, 320:360] = 100
    occ[:, 260:270, 210:220] = 100                # a pillar
    return occ


def lidar_directions(dev) -> torch.Tensor:
    """(5760, 2) [azimuth, elevation]: a VLP-16-class scanner, 16 rings from
    -15 to +15 degrees at 2 degrees, 360 azimuths."""
    az = np.linspace(-np.pi, np.pi, 360, endpoint=False)
    el = np.deg2rad(np.arange(-15.0, 16.0, 2.0))
    return torch.tensor(np.stack([np.repeat(az, el.size), np.tile(el, az.size)],
                                 1), dtype=torch.float32, device=dev)


def lidar3d_config():
    """The [lidar3d] point: AMHAMCL at 100k (num = min = max), 10 m range,
    the sensor 0.5 m above the pose plane, "score" validity."""
    from mcmh_localization_tpu_torch.config import FilterConfig

    return FilterConfig(
        mode="AMHAMCL", num_particles=100_000, min_particles=100_000,
        max_particles=100_000, initialized=True, initial_pose=START,
        sensor_model="lidar3d", lidar3d_sensor_z=LIDAR_SENSOR_Z,
        max_range=10.0, motion_validity="score")


def lidar_scene(dev, poses):
    """(voxel map, navigation slice, config, model, directions, scans): the
    [lidar3d] point on the building (its EDT on the host) and a scan of
    each of ``poses`` from the port's simulator (0.01 m noise)."""
    from mcmh_localization_tpu_torch.filter.step import make_model
    from mcmh_localization_tpu_torch.maps.voxel_map import (
        build_voxel_map,
        nav_slice,
    )
    from mcmh_localization_tpu_torch.models.sensor3d import simulate_scan3d

    vm = build_voxel_map(building_occupancy(), RES,
                         (-BUILDING_CELLS * RES / 2, -BUILDING_CELLS * RES / 2,
                          0.0), device=dev)
    nav = nav_slice(vm, z=0.1)
    cfg = lidar3d_config()
    model = make_model(cfg, nav, voxel_map=vm)
    directions = lidar_directions(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    scans = torch.stack([
        simulate_scan3d(gen, p, directions, vm, cfg.max_range,
                        sensor_z=cfg.lidar3d_sensor_z, noise=0.01)
        for p in poses])
    return vm, nav, cfg, model, directions, scans


def scored_cloud(model, state, scan, directions, delta) -> torch.Tensor:
    """The (2N, 3) poses the 3-D scorer scores on the step after ``state``
    (the proposed set, then the previous one), in the filter's slot order:
    one step of ``model`` with ``models.sensor3d.voxel_scores`` wrapped to
    keep its input."""
    from mcmh_localization_tpu_torch.models import sensor3d

    real = sensor3d.voxel_scores
    seen = []

    def keep(particles, *args, **kwargs):
        seen.append(particles.clone())
        return real(particles, *args, **kwargs)

    sensor3d.voxel_scores = keep
    try:
        model.step(state, scan, directions, delta)
    finally:
        sensor3d.voxel_scores = real
    return seen[-1]


def start_window(gm, n_theta: int, win: int, tw: int) -> tuple[int, int, int]:
    """(ox0, oy0, kstart): a ``win``-cell window and ``tw`` of ``n_theta``
    theta bins centred on the START pose."""
    oy0 = int((START[1] - gm.origin_xy[1]) / RES) - win // 2
    ox0 = int((START[0] - gm.origin_xy[0]) / RES) - win // 2
    kstart = (int((START[2] + math.pi) * n_theta / (2 * math.pi))
              - tw // 2) % n_theta
    return ox0, oy0, kstart


def mixed_cloud(n: int, gm, cov, gen) -> torch.Tensor:
    """(n, 3) poses for the window score: three quarters tracked around
    START (window reads), the rest spread over the map (coarse reads) but
    n // 64 off the map (fills)."""
    from mcmh_localization_tpu_torch.filter.init import init_gaussian, init_uniform

    tracked = init_gaussian(START, cov, n - n // 4, gm, generator=gen)
    spread = init_uniform(n // 4 - n // 64, gm, generator=gen)
    off_map = (torch.rand((n // 64, 3), generator=gen, device=gen.device)
               - 0.5) * 60.0
    return torch.cat([tracked, spread, off_map]).contiguous()


def beam_point_config():
    """The bench's beam point (bench.py:391-398) at 100k particles: the
    windowed beam score field, 96 table bins, a 64-cell window with 24 theta
    bins, the coarse fallback at 24 bins."""
    from mcmh_localization_tpu_torch.config import FilterConfig

    return FilterConfig(
        mode="AMHAMCL", num_particles=100_000, min_particles=100_000,
        max_particles=100_000, initialized=True, initial_pose=START,
        sensor_model="beam", beam_impl="field", beam_table_n_theta=96,
        corr_window_cells=64, corr_theta_window_bins=24,
        corr_coarse_n_theta=24, motion_validity="score",
        min_injection_prob=0.02,
    )


def lut_inputs(gm, beam_model, ranges, angles) -> list:
    """[(tag, qt, s)]: kernel 7's inputs at the beam path's fine build (the
    window at the START pose) and coarse build, on the path's own quantized
    table and the per-scan LUT of ``ranges``."""
    from mcmh_localization_tpu_torch.models.range_table import (
        _beam_lut,
        coarse_lut_inputs,
        fine_lut_inputs,
    )

    cfg = beam_model.config
    tables = beam_model.log_field
    k = cfg.beam_table_n_theta
    valid = torch.isfinite(ranges) & (ranges < cfg.max_range)
    lp = _beam_lut(torch.where(valid, ranges, 0.0), valid, tables.dvals, cfg)
    win, tw = cfg.corr_window_cells, cfg.corr_theta_window_bins
    ox0, oy0, kstart = start_window(gm, k, win, tw)
    # without a theta window the fine field spans every bin from bin 0
    window = (oy0, ox0, kstart if tw else 0)
    return [("fine", *fine_lut_inputs(tables, lp, angles, k, window, win,
                                      tw or k, bool(tw))),
            ("coarse", *coarse_lut_inputs(lp, angles, tables, cfg, k))]


# The weight patterns kernel 4 is held to (tests/test_torch_rank.py has the
# same ones in numpy): where the slots of a draw go decides how its
# expansion balances across the card.
RANK_PATTERNS = ("uniform", "heavy first", "heavy last", "heavy middle",
                 "1% of particles", "zero runs", "dips injected")


def rank_bound(kind: str, r: int, num_out: int, gen, count=None) -> torch.Tensor:
    """(r,) int32: the raw segment bound of a systematic draw of ``num_out``
    slots (``count`` the stride, default ``num_out``) over weights of the
    pattern ``kind``; "dips injected" lowers 4096 segment edges by one or
    two below their predecessor, as a cumsum that lost an ulp does."""
    from mcmh_localization_tpu_torch.ops.resampling import _segment_bounds

    dev = gen.device
    w = torch.zeros(r, device=dev)
    if kind == "uniform":
        w.fill_(1.0)
    elif kind.startswith("heavy"):
        w[{"heavy first": 0, "heavy last": r - 1, "heavy middle": r // 2}[kind]] = 1.0
    elif kind == "1% of particles":
        w[torch.randperm(r, generator=gen, device=dev)[:r // 100]] = 1.0
    elif kind == "zero runs":
        w = ((torch.arange(r, device=dev) // 50_000) % 3 == 1).float()
    elif kind == "dips injected":
        w = -torch.log(torch.rand(r, generator=gen, device=dev))
    else:
        raise ValueError(kind)
    u = torch.rand((), generator=gen, device=dev)
    bound = _segment_bounds(w / w.sum(), num_out,
                            num_out if count is None else count, u)
    if kind == "dips injected":
        edges = torch.nonzero(bound[1:] > bound[:-1]).flatten() + 1
        pick = edges[torch.randperm(edges.numel(), generator=gen,
                                    device=dev)[:4096]]
        drop = 1 + (torch.rand(pick.shape, generator=gen, device=dev) < 0.5).int()
        bound[pick] = (bound[pick - 1] - drop).clamp(min=0).to(torch.int32)
    return bound.contiguous()


def check(cond, msg: str) -> None:
    """A phase check that fails the run (kept under ``python -O`` too)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


@functools.lru_cache(maxsize=1)
def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, runs: int = 20) -> float:
    """Device ms of one call: CUDA events around a run of back-to-back
    calls, over the count; the median of ``runs`` runs.  A sleep kernel
    queued ahead of each run holds the card while the host enqueues the
    whole run, so the wrapper's host work stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    per_run = max(1, min(100, int(2e-3 / (time.perf_counter() - t0))))
    # at 2e9 cycles/s (above the card's top clock) the sleep outlasts three
    # times the run's enqueue
    cycles = int(3 * per_run * enqueue * 2e9)
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(per_run):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / per_run)
    return float(np.median(times))


def once_ms(fn) -> tuple:
    """(result, ms) of one call by CUDA events: a plain version that takes
    seconds a call (where ``device_ms``' repeated runs would take minutes),
    or a stretch of scans."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA's data
# sheet): f32 outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
SRC = "mcmh_localization_tpu_torch/csrc/"
TPU = "mcmh_localization_tpu/ops/"


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for the work: the larger of the
    operations over the f32 rate and the bytes over the memory rate."""
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def gathered_bytes(table: torch.Tensor, n_reads: int) -> int:
    """A gather's input table, read once: the whole table, or one value a
    read where the reads touch less of it."""
    return min(table.numel() * table.element_size(),
               n_reads * table.element_size())


def sm_clock_hz() -> float:
    """The card's top SM clock, as nvidia-smi reads it."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True)
    return float(res.stdout.strip().splitlines()[0]) * 1e6


# Shared memory serves 128 bytes a clock on each SM (NVIDIA's Hopper
# tuning guide): kernel 7's floor beside its DRAM bound.
SMEM_BYTES_PER_CLOCK = 128


def free_mask_indices(gm, n: int, gen, cov):
    """(y, x) int32: the clamped cells of n candidate poses around START,
    as ``GridMap.is_free_world`` reads them from the free mask."""
    from mcmh_localization_tpu_torch.filter.init import init_gaussian

    p = init_gaussian(START, cov, n, gm, generator=gen)
    mx, my = gm.world_to_grid(p[:, 0], p[:, 1])
    return (my.clamp(0, gm.height - 1).contiguous(),
            mx.clamp(0, gm.width - 1).contiguous())


def gather_2d_row(tag, table, y, x) -> dict:
    """gather_2d at one shape: bitwise against its plain version and
    ``table[y, x]`` (also on a view of the indices one past an aligned
    base, N - 1 of them), timed beside its bound and ``table[y, x]``."""
    from mcmh_localization_tpu_torch.ops._cuda import poses_per_thread
    from mcmh_localization_tpu_torch.ops.gather import (
        gather_2d,
        gather_2d_plain,
    )

    g = gather_2d(table, y, x)
    check(torch.equal(g, gather_2d_plain(table, y, x)),
          f"gather_2d {tag}: kernel != plain")
    y64, x64 = y.to(torch.int64), x.to(torch.int64)
    check(torch.equal(g, table[y64, x64]), f"gather_2d {tag}: != table[y, x]")
    check(torch.equal(gather_2d(table, y[1:], x[1:]), g[1:]),
          f"gather_2d {tag}: the misaligned view != the aligned call")
    n = y.numel()
    ms = device_ms(lambda: gather_2d(table, y, x))
    pms = device_ms(lambda: gather_2d_plain(table, y, x))
    lms = device_ms(lambda: table[y64, x64])
    print(f"[kernel] gather_2d {tag}: N={n}, P={poses_per_thread(n)} index "
          "pairs a thread, bitwise (also the misaligned view)")
    return kernel_row(
        "gather_2d", "gather.cu", "gather_pallas.py:180",
        f"{tag} table {tuple(table.shape)} N={n}", ms=ms, plain_ms=pms,
        err=0.0, ops=n, nbytes=n * 12 + gathered_bytes(table, n),
        library_ms=lms, library="table[y, x]")


def kernel_row(name, source, replaces, shape, *, ms, plain_ms, err, ops,
               nbytes, library_ms=None, library=None, **extra) -> dict:
    """One [kernel] line and its JSON row: the kernel's time beside its
    bound (from the operation and byte counts given), the plain version's
    and, where one PyTorch call computes the same function, that call's."""
    b, by = bound_ms(ops, nbytes)
    if not replaces.startswith("mcmh_localization_tpu/"):
        replaces = TPU + replaces
    row = dict(name=name, route="cuda", source=SRC + source,
               replaces=replaces, shape=shape, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=b, bound_by=by,
               pct_of_bound=100.0 * b / ms, library_ms=library_ms,
               ops=ops, bytes=nbytes, **extra)
    lib = ("none" if library_ms is None
           else f"{library_ms:.4f} ({library})")
    print(f"[kernel] {name} {shape}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b:.4f} by {by} ({ops:.4g} ops, {nbytes:.4g} bytes) "
          f"pct_of_bound={row['pct_of_bound']:.1f} library_ms={lib} "
          f"max_abs_err={err} on {nvidia_smi_line()}")
    return row


def conv_field_call(table, ox, oy, live, h, w):
    """The library yardstick of the field build: one ``F.conv2d`` of the
    table with a (K, 1, kh, kw) kernel that counts each bin's valid beams
    at their offsets (cuDNN, TF32 off).  Returns the call."""
    k = ox.shape[0]
    kh, kw = table.shape[0] - h + 1, table.shape[1] - w + 1
    counts = torch.zeros((k, kh * kw), device=table.device)
    flat = (oy.to(torch.int64) * kw + ox).clamp(0, kh * kw - 1)
    counts.scatter_add_(1, flat, live.to(torch.float32))
    weight = counts.reshape(k, 1, kh, kw)
    x = table[None, None].contiguous()
    return lambda: torch.nn.functional.conv2d(x, weight)[0]


def field_build_row(tag, padded, ox, oy, fh, fw, m, lmax, table,
                    origin=None, zero_row=None, prev=None):
    """Kernel 1 at one path shape, in the form the step launches it
    (``origin``: the window's corner as a device tensor; ``zero_row``: the
    first invalid row): bitwise against its plain version, timed beside its
    bound and the conv2d yardstick on ``table``, the (fh + kh - 1, fw + kw
    - 1) region the build reads.  ``prev``: (padded, ox, oy) of the earlier
    form (the region sliced out on the host, the zero band appended),
    checked bitwise against this one and timed beside it.  Returns (row,
    field)."""
    from mcmh_localization_tpu_torch.ops.corr_field_build import (
        corr_field_build,
        corr_field_build_plain,
    )

    form = dict(origin=origin, zero_row=zero_row)
    out = corr_field_build(padded, ox, oy, fh, fw, **form)
    ref = corr_field_build_plain(padded, ox, oy, fh, fw, **form)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref), f"corr_field_build {tag}: kernel != plain "
          f"(max abs err {err})")
    live = oy < (padded.shape[0] - fh if zero_row is None else zero_row)
    conv = conv_field_call(table, ox, oy, live, fh, fw)
    tol = 1e-5 * m * lmax  # f32 sums of M log values in another order
    cerr = float((conv() - out).abs().max())
    check(cerr <= tol, f"conv2d yardstick {tag}: max abs err {cerr} > {tol}")
    k = ox.shape[0]
    m_valid = int(live.sum()) / k
    # the share of table loads that a thread already holds from the bin's
    # previous valid beam (the beams in the build's order): in the kernel's
    # layout (csrc/corr_field_build.cu: RY rows, 4 columns 32 apart; RY = 2
    # where fh * fw >= 65536) and in a strip of 8 consecutive columns
    ry = 2 if fh * fw >= 65536 else 1
    lx, ly = ox[live].reshape(k, -1), oy[live].reshape(k, -1)
    dx, dy = lx[:, 1:] - lx[:, :-1], ly[:, 1:] - ly[:, :-1]
    rows_held = (ry - dy.abs()).clamp(min=0)
    cols_held = torch.where(dx % 32 == 0, (4 - (dx // 32).abs()).clamp(min=0), 0)
    held = float((rows_held * cols_held).float().mean()) / (4 * ry)
    strip = float(torch.where(dy == 0, (8 - dx.abs()).clamp(min=0), 0)
                  .float().mean()) / 8
    same = float(((dx == 0) & (dy == 0)).float().mean())
    print(f"[kernel] corr_field_build {tag}: loads held from the previous "
          f"beam {held:.4f} in the kernel's layout ({ry}x4, columns 32 apart), "
          f"{strip:.4f} in a strip of 8 consecutive columns; {same:.4f} of "
          "consecutive valid beams repeat the offset")
    ms = device_ms(lambda: corr_field_build(padded, ox, oy, fh, fw, **form))
    pms = device_ms(lambda: corr_field_build_plain(padded, ox, oy, fh, fw,
                                                   **form))
    lms = device_ms(conv, runs=5)
    extra = {}
    if prev is not None:
        check(torch.equal(corr_field_build(*prev, fh, fw), out),
              f"corr_field_build {tag}: the earlier host-sliced form != "
              "the device-origin form")
        extra["prev_ms"] = device_ms(lambda: corr_field_build(*prev, fh, fw))
        form_name = ("the window at the device-held origin"
                     if origin is not None else "the padded field read to "
                     "its zero-band row")
        prev_name = ("the region sliced on the host, the zero band appended"
                     if origin is not None else "the zero band appended")
        print(f"[kernel] corr_field_build {tag}: {form_name} {ms:.4f} ms "
              f"beside the earlier form's {extra['prev_ms']:.4f} ms "
              f"({prev_name}), bitwise equal, on {nvidia_smi_line()}")
    # one add per output and valid beam; the region and the offsets read
    # once, the field written once
    return kernel_row(
        "corr_field_build", "corr_field_build.cu", "corr_field_pallas.py:40",
        f"{tag} K={k} {fh}x{fw} M={m} ({m_valid:.0f} valid)", ms=ms,
        plain_ms=pms, err=err, ops=k * fh * fw * m_valid * 1.0,
        nbytes=4.0 * (table.numel() + 2 * ox.numel() + k * fh * fw),
        library_ms=lms, library=f"conv2d, err {cerr:.3g}", **extra), out


def window_score_row(fine_t, coarse_t, parts, geo, denom, n_valid,
                     forms: str) -> dict:
    """Kernel 5 on one cloud: bitwise against its plain version, timed
    beside its bound (each pose read once and its score written, one fine
    or one coarse value read a pose on the map)."""
    from mcmh_localization_tpu_torch.ops.fused_score import (
        window_indices,
        window_score,
        window_score_plain,
    )

    args = (fine_t, coarse_t, parts, geo, denom, -100.0)
    out = window_score(*args, count=n_valid)
    ref = window_score_plain(*args, count=n_valid)
    covered, _, _, in_map = window_indices(parts, geo)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"window_score ({forms}): kernel != plain")
    n = parts.shape[0]
    n_esc = int((in_map & ~covered).sum())
    n_off = int((~in_map).sum())
    ms = device_ms(lambda: window_score(*args, count=n_valid))
    pms = device_ms(lambda: window_score_plain(*args, count=n_valid))
    print(f"[kernel] window_score ({forms}): N={n} fine "
          f"{tuple(fine_t.shape)} coarse {tuple(coarse_t.shape)} "
          f"escapees={n_esc} off_map={n_off} bitwise=True")
    return kernel_row(
        "window_score", "fused_score.cu", "fused_score_pallas.py:170",
        f"{forms} N={n}", ms=ms, plain_ms=pms, err=0.0, ops=n,
        nbytes=n * (12 + 4) + gathered_bytes(fine_t, n - n_esc - n_off)
        + gathered_bytes(coarse_t, n_esc), shapes=[])


def window_at_rows(fine_t, coarse_t, parts, geo, denom, n_valid,
                   score_ms: float, esc_ms: float) -> list:
    """Kernel 5's ``_at`` entries, the window's corner and first bin read
    from device memory (the flagship's form), at the flagship's shape: the
    score and the escapee count ``torch.equal`` to their plain versions
    (given the same origin tensor) and to the launch-argument kernels at
    the window's clamps (corner at 0 and at h - win), at the theta wrap
    (kstart = n_theta - 1), at the flagship's window and with the corner
    alone, under a geometry that holds another window; then timed at the flagship's window beside
    the launch-argument form (``score_ms``, ``esc_ms``, timed on the same
    cloud).  Returns the two rows."""
    from mcmh_localization_tpu_torch.ops.fused_score import (
        window_escapees,
        window_escapees_plain,
        window_indices,
        window_score,
        window_score_plain,
    )

    dev = parts.device
    n = parts.shape[0]
    cases = {
        "corner at 0": (0, 0, geo.kstart),
        "corner at h - win": (geo.h - geo.fh, geo.w - geo.fw, geo.kstart),
        "theta wrap": (geo.oy0, geo.ox0, geo.n_theta - 1),
        "flagship window": (geo.oy0, geo.ox0, geo.kstart),
        # a (2,) origin (no theta window): kstart stays the geometry's
        "corner only": (geo.oy0, geo.ox0),
    }
    other = geo._replace(ox0=1, oy0=2, kstart=3)
    for tag, o in cases.items():
        origin = torch.tensor(o, dtype=torch.int32, device=dev)
        host = geo._replace(oy0=o[0], ox0=o[1],
                            kstart=o[2] if len(o) > 2 else other.kstart)
        args = (fine_t, coarse_t, parts)
        got = window_score(*args, other, denom, -100.0, count=n_valid,
                           origin=origin)
        ref = window_score_plain(*args, other, denom, -100.0, count=n_valid,
                                 origin=origin)
        launch = window_score(*args, host, denom, -100.0, count=n_valid)
        esc = [int(window_escapees(parts, other, origin=origin)),
               int(window_escapees_plain(parts, other, origin=origin)),
               int(window_escapees(parts, host))]
        covered, _, _, in_map = window_indices(parts, host)
        torch.cuda.synchronize()
        check(torch.equal(got, ref) and torch.equal(got, launch),
              f"window_score_at ({tag}, origin {o}): kernel != plain or != "
              "the launch-argument kernel")
        check(esc[0] == esc[1] == esc[2], f"window_escapees_at ({tag}, "
              f"origin {o}): kernel, plain, launch-argument counts {esc}")
        print(f"[kernel] window_score_at / window_escapees_at ({tag}, origin "
              f"(oy0, ox0, kstart) = {o}): N=2x{n // 2}, "
              f"{int(covered.sum())} covered, {esc[0]} escapees; bitwise "
              "its plain version and the launch-argument kernel")
    o = cases["flagship window"]
    origin = torch.tensor(o, dtype=torch.int32, device=dev)
    covered, _, _, in_map = window_indices(parts, geo)
    n_fine = int((covered & in_map).sum())
    n_esc = int((~covered & in_map).sum())
    ms = device_ms(lambda: window_score(fine_t, coarse_t, parts, other, denom,
                                        -100.0, count=n_valid, origin=origin))
    pms = device_ms(lambda: window_score_plain(
        fine_t, coarse_t, parts, other, denom, -100.0, count=n_valid,
        origin=origin))
    ms_e = device_ms(lambda: window_escapees(parts, other, origin=origin))
    pms_e = device_ms(lambda: window_escapees_plain(parts, other,
                                                    origin=origin))
    print(f"[kernel] window_score_at N=2x{n // 2}: {ms:.4f} ms beside the "
          f"launch-argument form's {score_ms:.4f}; window_escapees_at "
          f"{ms_e:.4f} beside {esc_ms:.4f}, on {nvidia_smi_line()}")
    # window_score_row's work, and the origin's 12 bytes
    score_row = kernel_row(
        "window_score_at", "fused_score.cu", "fused_score_pallas.py:170",
        f"corr op forms N=2x{n // 2}, origin in device memory", ms=ms,
        plain_ms=pms, err=0.0, ops=n,
        nbytes=n * (12 + 4) + gathered_bytes(fine_t, n_fine)
        + gathered_bytes(coarse_t, n_esc) + 12, prev_ms=score_ms)
    esc_row = kernel_row(
        "window_escapees_at", "fused_score.cu",
        "mcmh_localization_tpu/models/corr_field.py:553",
        f"N=2x{n // 2}, origin in device memory", ms=ms_e, plain_ms=pms_e,
        err=0.0, ops=n, nbytes=12 * n + 4 + 12, prev_ms=esc_ms)
    return [score_row, esc_row]


def rank_pattern_rows(r: int, gen) -> list:
    """Kernel 4 under every weight pattern (RANK_PATTERNS) at R = r: a full
    draw, the KLD stage-1 draw (131 072 slots) and one whose count is under
    num_out, each bitwise against the plain version; then uniform weights
    and all mass on the middle particle timed at both draw sizes."""
    from mcmh_localization_tpu_torch.ops.rank import (
        rank_in_sorted,
        rank_in_sorted_plain,
    )

    dev = gen.device
    timed = {}
    for kind in RANK_PATTERNS:
        for num_out, count in ((r, r), (131_072, r), (r, r // 3 + 5)):
            bound = rank_bound(kind, r, num_out, gen, count=count)
            cnt = torch.tensor(count, dtype=torch.int32, device=dev)
            got = rank_in_sorted(bound, num_out, cnt)
            check(torch.equal(got, rank_in_sorted_plain(bound, num_out, cnt)),
                  f"rank_in_sorted {kind} num_out={num_out} count={count}: "
                  "kernel != plain")
            if kind in ("uniform", "heavy middle") and count == r:
                timed[(kind, num_out)] = (bound, cnt)
    print(f"[kernel] rank_in_sorted R={r}: bitwise under {len(RANK_PATTERNS)} "
          "weight patterns x (num_out = R, num_out = 131072, count < num_out)")
    rows = []
    for (kind, num_out), (bound, cnt) in timed.items():
        ms = device_ms(lambda: rank_in_sorted(bound, num_out, cnt))
        pms = device_ms(lambda: rank_in_sorted_plain(bound, num_out, cnt))
        rows.append(kernel_row(
            "rank_in_sorted", "rank.cu", "rank_pallas.py:212",
            f"{kind} R={r} num_out={num_out}", ms=ms, plain_ms=pms, err=0.0,
            ops=r + num_out, nbytes=4 * r + 4 * num_out, on_main_path=False))
    return rows


def compare_kernels(gm, cfg, small_cfg, log_field, ranges, angles, rows):
    """Phase 3: each kernel vs its plain version at main-path shapes."""
    from mcmh_localization_tpu_torch.filter.init import init_gaussian
    from mcmh_localization_tpu_torch.models.corr_field import (
        _bin_offsets,
        pad_cells_for,
    )
    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.filter.step import state_size
    from mcmh_localization_tpu_torch.ops._cuda import poses_per_thread
    from mcmh_localization_tpu_torch.ops.gather import (
        LookupGeometry,
        corr_lookup,
        corr_lookup_indices,
        corr_lookup_plain,
    )
    from mcmh_localization_tpu_torch.ops.rank import (
        expand_sorted,
        expand_sorted_plain,
        rank_in_sorted,
        rank_in_sorted_plain,
    )
    from mcmh_localization_tpu_torch.ops.resampling import (
        _segment_bounds,
        softmax_weights,
    )

    dev = log_field.device
    h, w = log_field.shape
    pad = pad_cells_for(cfg, gm)
    valid = torch.isfinite(ranges) & (ranges < cfg.max_range)
    safe_r = torch.where(valid, ranges, 0.0)
    u = safe_r * torch.cos(angles)
    v = safe_r * torch.sin(angles)
    padded0 = torch.nn.functional.pad(log_field, (pad, pad, pad, pad))
    zb = padded0.shape[0]
    n_valid = valid.sum().to(torch.int32)
    m = int(ranges.shape[0])
    lmax = float(log_field.abs().max())

    # kernel 1, BIG: full map, all 120 bins, beams in the build's order;
    # the step's form reads the padded field with its invalid beams at the
    # zero-band row, the earlier one had the band appended
    ox, oy = _bin_offsets(u, v, valid, gm.inv_res, cfg.corr_n_theta, pad, zb)
    padded0 = padded0.contiguous()
    padded_big = torch.cat([padded0, torch.zeros((h, padded0.shape[1]), device=dev)])
    field_row, field_big = field_build_row(
        "BIG", padded0, ox, oy, h, w, m, lmax, padded0, zero_row=zb,
        prev=(padded_big, ox, oy))
    # SMALL: 128-cell window at the start pose, 32 theta bins, read in place
    # at the device-held origin (the earlier form sliced it on the host)
    win, tw = small_cfg.corr_window_cells, small_cfg.corr_theta_window_bins
    ox0, oy0, kstart = start_window(gm, cfg.corr_n_theta, win, tw)
    origin = torch.tensor([oy0, ox0, kstart], dtype=torch.int32, device=dev)
    oxs, oys = _bin_offsets(u, v, valid, gm.inv_res, cfg.corr_n_theta, pad, zb,
                            bin_start=origin[2], nbins=tw)
    side = win + 2 * pad
    region = padded0[oy0:oy0 + side, ox0:ox0 + side]
    padded_small = torch.cat([region, torch.zeros((win, side), device=dev)]
                             ).contiguous()
    oys_host = torch.where(oys >= zb, side, oys).to(torch.int32).contiguous()
    small_row, field_small = field_build_row(
        "SMALL", padded0, oxs, oys, win, win, m, lmax, region, origin=origin,
        zero_row=zb, prev=(padded_small, oxs, oys_host))
    from mcmh_localization_tpu_torch.ops.corr_field_build import (
        corr_field_build,
        corr_field_build_plain,
    )

    slices = []
    for tag, bx, by, fh, fw, field, row, form, table in (
            ("BIG", ox, oy, h, w, field_big, field_row,
             dict(zero_row=zb), padded0),
            ("SMALL", oxs, oys, win, win, field_small, small_row,
             dict(origin=origin, zero_row=zb), region)):

        def calls(b0, n, bx=bx, by=by, fh=fh, fw=fw, form=form, table=table):
            # the slice's offset rows, copied once; its valid beams count
            # the operations and the conv2d yardstick's kernel, as in
            # field_build_row
            sx = bx[b0:b0 + n].contiguous()
            sy = by[b0:b0 + n].contiguous()
            live = sy < zb
            conv = conv_field_call(table, sx, sy, live, fh, fw)
            return (lambda: corr_field_build(padded0, sx, sy, fh, fw, **form),
                    lambda: corr_field_build_plain(padded0, sx, sy, fh, fw,
                                                   **form),
                    (conv, "conv2d", 1e-5 * m * lmax),
                    float(live.sum()) * fh * fw,
                    4.0 * (table.numel() + 2 * sx.numel() + n * fh * fw))

        slices += bin_slice_rows("corr_field_build", tag, field, bx.shape[0],
                                 row, calls)
    rows.append({**field_row, "shapes": [small_row] + slices})

    # kernel 2: lookups of 2 x n poses (the MH step scores both sets in one
    # call); each pose reads one field value
    gen = torch.Generator(device=dev).manual_seed(7)
    cov = torch.diag(torch.tensor(cfg.initial_cov))
    geo_big = LookupGeometry(gm.origin_xy[0], gm.origin_xy[1], gm.inv_res,
                             cfg.corr_n_theta, cfg.corr_n_theta, h, w, h, w)
    # SMALL: the window and theta window at the device-held origin (the
    # step's form); the earlier form took them as launch arguments
    geo_small_host = LookupGeometry(gm.origin_xy[0], gm.origin_xy[1],
                                    gm.inv_res, cfg.corr_n_theta, tw, win,
                                    win, h, w, kstart=kstart,
                                    window=(ox0, oy0))
    geo_small = geo_small_host._replace(kstart=None, window=None,
                                        theta_window=True, space_window=True)
    look = []
    for tag, n, field, geo, agg, o, host_geo in (
            ("BIG", 1_000_000, field_big, geo_big, "sum", None, None),
            ("SMALL", 130_048, field_small, geo_small, "mean", origin,
             geo_small_host)):
        parts = init_gaussian(START, cov, 2 * n, gm, generator=gen)
        out = corr_lookup(field, parts, n_valid, geo, agg, True, origin=o)
        ref = corr_lookup_plain(field, parts, n_valid, geo, agg, True,
                                origin=o)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"corr_lookup {tag}: kernel != plain")
        # a view 12 bytes past an aligned base, N - 1 poses: 4-byte pose
        # loads and a ragged last thread
        check(torch.equal(corr_lookup(field, parts[1:], n_valid, geo, agg,
                                      True, origin=o), ref[1:]),
              f"corr_lookup {tag}: the misaligned view != plain")
        print(f"[kernel] corr_lookup {tag}: N={2 * n}, P="
              f"{poses_per_thread(2 * n)} poses a thread, bitwise (also "
              "the misaligned view parts[1:])")
        ms = device_ms(lambda: corr_lookup(field, parts, n_valid, geo, agg,
                                           True, origin=o))
        pms = device_ms(lambda: corr_lookup_plain(field, parts, n_valid, geo,
                                                  agg, True, origin=o))
        extra = {}
        if host_geo is not None:
            check(torch.equal(corr_lookup(field, parts, n_valid, host_geo,
                                          agg, True), out),
                  f"corr_lookup {tag}: the launch-argument form != the "
                  "device-origin form")
            extra["prev_ms"] = device_ms(lambda: corr_lookup(
                field, parts, n_valid, host_geo, agg, True))
            print(f"[kernel] corr_lookup {tag}: device-held origin {ms:.4f} "
                  f"ms beside the launch-argument form's "
                  f"{extra['prev_ms']:.4f} ms, bitwise equal, on "
                  f"{nvidia_smi_line()}")
        look.append(kernel_row(
            "corr_lookup", "gather.cu", "gather_pallas.py:96",
            f"{tag} N=2x{n}", ms=ms, plain_ms=pms, err=0.0, ops=2 * n,
            nbytes=2 * n * (3 * 4 + 4) + gathered_bytes(field, 2 * n),
            **extra))
        parts_s = parts
    rows.append({**look[0], "shapes": look[1:]})

    # gather_2d at the TPU's SMALL lookup shape: a (4096, 128) table, 2x130048
    tbin, myc, mxc, _, _ = corr_lookup_indices(parts_s, geo_small, origin)
    table = field_small.reshape(tw * win, win)
    y = (tbin * win + myc).to(torch.int32).contiguous()
    x = mxc.to(torch.int32).contiguous()
    gather_row = {**gather_2d_row("SMALL window", table, y, x), "shapes": []}
    # the exact paths' free-cell test of the "reject" retries
    # (GridMap.is_free_world, maps/grid_map.py:90): retries x n_max
    # candidates, for FilterConfig() and the [exact] 100k "jnp" run
    for n_max in (state_size(FilterConfig()), 100_000):
        n = FilterConfig().motion_retries * n_max
        gy, gx = free_mask_indices(gm, n, gen, cov)
        gather_row["shapes"].append(gather_2d_row(
            f"free mask, {FilterConfig().motion_retries} retries x {n_max}",
            gm.free_mask, gy, gx))

    # kernels 3 and 4: one bound of 1M posterior weights at the draw's
    # max_samples serves the KLD stage-1 draw (131072 slots) and the full
    # draw (1M); the raw bound may dip, and the kernels rank against its
    # running max
    n_big = 1_000_000
    parts = init_gaussian(START, cov, n_big, gm, generator=gen)
    s = corr_lookup(field_big, parts, n_valid, geo_big, "mean", True)
    wts = softmax_weights(s * 40.0)
    r = torch.rand((), generator=gen, device=dev)
    bound = _segment_bounds(wts, n_big, n_big, r)
    natural = int((bound[1:] < bound[:-1]).sum())
    dipped = bound.clone()
    edges = torch.nonzero(dipped[1:] > dipped[:-1]).flatten() + 1
    pick = edges[torch.randperm(edges.numel(), generator=gen, device=dev)[:4096]]
    drop = 1 + (torch.rand(pick.shape, generator=gen, device=dev) < 0.5).int()
    dipped[pick] = (dipped[pick - 1] - drop).clamp(min=0).to(torch.int32)
    injected = int((dipped[1:] < dipped[:-1]).sum())
    check(injected > 1000, f"only {injected} dips injected")
    print(f"[kernel] segment bound R={n_big}: {natural} natural dips of the "
          f"card's cumsum; {injected} in the injected copy")
    # the bound replays: its cumsum sums in one order (utils/f32.py), where
    # the 1-D torch.cumsum on the card may not
    one_d = {torch.cumsum(wts, 0).cpu().numpy().tobytes() for _ in range(16)}
    check(all(torch.equal(_segment_bounds(wts, n_big, n_big, r), bound)
              for _ in range(16)), "the segment bound differs between runs")
    print(f"[kernel] 16 runs on the same 1M weights: torch.cumsum gave "
          f"{len(one_d)} distinct results; the segment bound 1")
    # the count as the path holds it, a 0-d int32 on the card: a python int
    # would cost a pageable copy, which waits for the queue, every call
    cnt = torch.tensor(n_big, dtype=torch.int32, device=dev)
    exp_rows, rank_rows = [], []
    for num_out in (n_big, 131_072):
        for tag, bd in (("dips injected", dipped), ("path", bound)):
            e = expand_sorted(bd, parts, num_out, count=cnt)
            check(torch.equal(e, expand_sorted_plain(bd, parts, num_out, cnt)),
                  f"expand_sorted != plain at num_out={num_out} ({tag})")
            ri = rank_in_sorted(bd, num_out, count=cnt)
            check(torch.equal(ri, rank_in_sorted_plain(bd, num_out, cnt)),
                  f"rank_in_sorted != plain at num_out={num_out} ({tag})")
        ms_e = device_ms(lambda: expand_sorted(bound, parts, num_out, cnt))
        pms_e = device_ms(lambda: expand_sorted_plain(bound, parts, num_out, cnt))
        ms_cm = device_ms(lambda: torch.cummax(bound, 0))
        ms_r = device_ms(lambda: rank_in_sorted(bound, num_out, cnt))
        pms_r = device_ms(lambda: rank_in_sorted_plain(bound, num_out, cnt))
        mono = torch.cummax(bound, 0).values
        v32 = torch.arange(num_out, dtype=torch.int32, device=dev)
        check(torch.equal(ri, torch.searchsorted(mono, v32, right=True,
                                                 out_int32=True).clamp(max=n_big - 1)),
              "rank_in_sorted != searchsorted of the running max")
        # not the same function: searchsorted needs the running max first
        ss_r = device_ms(lambda: torch.searchsorted(mono, v32, right=True,
                                                    out_int32=True))
        # each input read once (the particles as the rows the slots
        # gather), each output written once
        exp_rows.append(kernel_row(
            "expand_sorted", "rank.cu", "rank_pallas.py:361",
            f"R={n_big} num_out={num_out}", ms=ms_e, plain_ms=pms_e, err=0.0,
            ops=n_big + num_out,
            nbytes=4 * n_big + gathered_bytes(parts, 3 * num_out) + 12 * num_out,
            cummax_ms=ms_cm))
        print(f"[kernel] expand_sorted R={n_big} num_out={num_out}: the scan "
              f"and the expansion {ms_e:.4f} ms; torch.cummax of the same raw "
              f"bound, which the path no longer runs, {ms_cm:.4f} ms")
        rank_rows.append(kernel_row(
            "rank_in_sorted", "rank.cu", "rank_pallas.py:212",
            f"R={n_big} num_out={num_out}", ms=ms_r, plain_ms=pms_r, err=0.0,
            ops=n_big + num_out, nbytes=4 * n_big + 4 * num_out,
            searchsorted_ms=ss_r, on_main_path=False))
        print(f"[kernel] rank_in_sorted R={n_big} num_out={num_out}: "
              f"searchsorted of the running max {ss_r:.4f} ms, beside "
              f"torch.cummax {ms_cm:.4f} ms")
    rank_rows += rank_pattern_rows(n_big, gen)
    rows.append({**exp_rows[0], "shapes": exp_rows[1:]})
    rows.append(gather_row)
    rows.append({**rank_rows[0], "shapes": rank_rows[1:]})
    return field_small, (ox0, oy0, kstart), u, v, valid, wts


def compare_slice2_kernels(gm, single_cfg, log_field, ranges, angles,
                           field_small, window, u, v, valid, wts, rows):
    """Phase 3 for the kernels of the single-program and exact paths:
    window score (with the coarse field build), exact scorer, monotone take."""
    from mcmh_localization_tpu_torch.filter.init import init_gaussian
    from mcmh_localization_tpu_torch.models.corr_field import (
        _coarse_field,
        coarse_build_inputs,
        coarse_shape,
        window_geometry,
    )
    from mcmh_localization_tpu_torch.ops.fused_score import (
        window_escapees,
        window_escapees_plain,
        window_score,
        window_score_plain,
    )
    from mcmh_localization_tpu_torch.ops.likelihood import (
        lanes_per_particle,
        likelihood_scores,
        likelihood_scores_plain,
    )
    from mcmh_localization_tpu_torch.ops.resampling import (
        systematic_resample_indices,
    )
    from mcmh_localization_tpu_torch.ops.take import (
        take_rows_monotone,
        take_rows_monotone_plain,
    )

    dev = log_field.device
    m = int(ranges.shape[0])
    lmax = float(log_field.abs().max())
    gen = torch.Generator(device=dev).manual_seed(11)
    cov = torch.diag(torch.tensor(single_cfg.initial_cov))

    # the coarse field build: K=36, 96^2, M=360
    kc, hc, wc = coarse_shape(single_cfg, *log_field.shape)
    padded, ox, oy = coarse_build_inputs(u, v, valid, log_field, gm, single_cfg)
    for row in rows:
        if row["name"] == "corr_field_build":
            row["shapes"].append(field_build_row(
                "coarse", padded, ox, oy, hc, wc, m, lmax,
                padded[:padded.shape[0] - hc])[0])

    # kernel 5: the window score at 2x1M poses, a mixed cloud: tracked
    # poses in the window, escapees across the map (coarse reads), and off
    # the map (fills)
    n = 2_000_000
    nbins, fh, fw = field_small.shape
    geo = window_geometry(gm, single_cfg, single_cfg.corr_n_theta, nbins,
                          fh, fw)._replace(ox0=window[0], oy0=window[1],
                                           kstart=window[2])
    fine_t = field_small.transpose(0, 1).reshape(fh * nbins, fw).contiguous()
    cfield = _coarse_field(u, v, valid, log_field, gm, single_cfg)
    coarse_t = cfield.transpose(0, 1).reshape(hc * kc, wc).contiguous()
    parts = mixed_cloud(n, gm, cov, gen)
    n_valid = valid.sum().to(torch.int32)
    denom = n_valid.clamp(min=1).to(torch.float32)
    window_row = window_score_row(fine_t, coarse_t, parts, geo, denom,
                                  n_valid, "corr op forms")
    # a view whose base is 12 bytes past an aligned one, N mod 4 = 3 (one
    # pose a thread at this N), timed
    rag = parts[1:2 * 100_000 + 4]
    check(rag.data_ptr() % 16 != 0 and rag.shape[0] % 4 != 0,
          "the ragged view is aligned")
    window_row["shapes"].append(window_score_row(
        fine_t, coarse_t, rag, geo, denom, n_valid,
        "corr op forms, misaligned base"))
    # the gate's count at 2x1M: the kernel vs the plain count
    esc = window_escapees(parts, geo)
    n_esc = int(window_escapees_plain(parts, geo))
    torch.cuda.synchronize()
    check(int(esc) == n_esc, f"window_escapees {int(esc)} != plain {n_esc}")
    check(int(window_escapees(rag, geo)) == int(window_escapees_plain(rag, geo)),
          "window_escapees (misaligned base) != plain")
    # and the whole mixed cloud less its first pose: four poses a thread,
    # misaligned (4-byte pose loads), N mod 4 = 3 (a ragged last thread)
    tail = parts[1:]
    check(torch.equal(window_score(fine_t, coarse_t, tail, geo, denom, -100.0,
                                   count=n_valid),
                      window_score_plain(fine_t, coarse_t, tail, geo, denom,
                                         -100.0, count=n_valid)),
          "window_score (parts[1:]): kernel != plain")
    check(int(window_escapees(tail, geo)) == int(window_escapees_plain(tail, geo)),
          "window_escapees (parts[1:]) != plain")
    ms_e = device_ms(lambda: window_escapees(parts, geo))
    pms_e = device_ms(lambda: window_escapees_plain(parts, geo))
    print(f"[kernel] window_escapees N=2x{n // 2}: {n_esc} escapees, "
          "bitwise (the same count as the plain version, also on the "
          "misaligned view)")
    # each pose read once, one count written
    esc_row = kernel_row(
        "window_escapees", "fused_score.cu",
        "mcmh_localization_tpu/models/corr_field.py:553",
        f"N=2x{n // 2}", ms=ms_e, plain_ms=pms_e, err=0.0, ops=n,
        nbytes=12 * n + 4)
    # the beam score field's op forms (divide by res, divide by the bin
    # width, clip before the window) on these tables: bitwise; timed at the
    # beam path's own geometry in compare_beam_kernel
    geo_b = geo._replace(
        fine_scale=gm.res, theta_div=True, fine_div=True,
        theta_scale=float(np.float32(2.0 * math.pi / geo.n_theta)),
        clip_before_window=True)
    out = window_score(fine_t, coarse_t, parts, geo_b, denom, -100.0,
                       count=n_valid)
    ref = window_score_plain(fine_t, coarse_t, parts, geo_b, denom, -100.0,
                             count=n_valid)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "window_score (beam op forms): kernel != plain")
    print(f"[kernel] window_score, beam op forms (fine_div, theta_div, "
          f"clip_before_window): N=2x{n // 2} bitwise=True")
    # every path now reads its window from device memory (the _at rows
    # below): the launch-argument entries are the form those are timed
    # beside, on no path
    for row in (window_row, esc_row):
        row["on_main_path"] = False
    rows += [window_row, esc_row]
    rows += window_at_rows(fine_t, coarse_t, parts, geo, denom, n_valid,
                           window_row["ms"], ms_e)

    # kernel 6: the exact scorer at 2x1500 and 2x100k poses, 360 beams, on
    # the 384^2 log field; the [exact] path's multiply form and the "jnp"
    # divide form; G lanes a pose, bitwise equal to the plain version
    cnt = valid.sum().to(torch.int32)
    m_valid = int(cnt)
    rows6 = []
    for n6 in (100_000, 1500):
        p6 = init_gaussian(START, cov, 2 * n6, gm, generator=gen).contiguous()
        g6 = lanes_per_particle(2 * n6)
        for div in (False, True):
            scale = gm.res if div else gm.inv_res
            a6 = (p6, u, v, valid, log_field, gm.origin_xy[0], gm.origin_xy[1],
                  scale, div, cnt, "mean")
            got = likelihood_scores(*a6)
            want = likelihood_scores_plain(*a6)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            check(torch.equal(got, want), f"likelihood_scores n=2x{n6} "
                  f"div={div} G={g6}: kernel != plain (max abs err {e})")
            print(f"[kernel] likelihood_scores N=2x{n6} form="
                  f"{'div' if div else 'mul'}: G={g6} lanes a pose, bitwise")
            ms6 = device_ms(lambda: likelihood_scores(*a6))
            pms6 = device_ms(lambda: likelihood_scores_plain(*a6))
            # per pose and valid beam: 8 flops for the endpoint, 4 for its
            # cell, 1 for the sum; one field read each
            pairs = 2 * n6 * m_valid
            rows6.append(kernel_row(
                "likelihood_scores", "likelihood.cu", "likelihood_pallas.py:113",
                f"N=2x{n6} M={m} ({m_valid} valid) form="
                f"{'div' if div else 'mul'} G={g6}", ms=ms6, plain_ms=pms6,
                err=e, ops=13.0 * pairs, nbytes=2 * n6 * 16 + m * 12
                + gathered_bytes(log_field, pairs)))
    rows.append({**rows6[0], "shapes": rows6[1:]})

    # kernel 8: the monotone take of the 1M systematic indices, (1M, 3)
    n8 = wts.shape[0]
    r = torch.rand((), generator=gen, device=dev)
    idx = systematic_resample_indices(wts, n8, count=n8, r=r)
    got = take_rows_monotone(parts[:n8].contiguous(), idx)
    check(torch.equal(got, take_rows_monotone_plain(parts[:n8], idx)),
          "take_rows_monotone != plain")
    src = parts[:n8].contiguous()
    check(torch.equal(got, torch.index_select(src, 0, idx)),
          "take_rows_monotone != index_select")
    ms8 = device_ms(lambda: take_rows_monotone(src, idx))
    pms8 = device_ms(lambda: take_rows_monotone_plain(src, idx))
    lms8 = device_ms(lambda: torch.index_select(src, 0, idx))
    rows.append(kernel_row(
        "take_rows_monotone", "take.cu", "take_pallas.py:98", f"({n8}, 3)",
        ms=ms8, plain_ms=pms8, err=0.0, ops=n8, nbytes=n8 * (12 + 4 + 12),
        library_ms=lms8, library="index_select", on_main_path=False))


def table_ops(table, pairs: int, m_valid: int) -> float:
    """Form (a)'s operations on these inputs.  The per-pair form: 14 a
    pose and valid beam (the bin's two adds, division and floor, the read's
    subtraction and division, the mixture's four multiplies and add, exp,
    max, log).  The level form computes the mixture once a valid beam and
    level (10 an entry of the scan's LUT: the subtraction, division, four
    multiplies and add, exp, max, log), and 6 a pair (the bin's two adds,
    division and floor, the wrap, the sum)."""
    if table.index is None:
        return 14.0 * pairs
    return 6.0 * pairs + 10.0 * m_valid * table.levels.numel()


def table_scores_row(gm, cfg, table, parts, ranges, angles) -> dict:
    """Kernel 2's fused form (a) on one cloud and a form of the table
    (``table_levels``): ``torch.equal`` to its plain version, timed beside
    its bound (``table_ops``; the poses and the scan read once, the index
    or f32 table counted as the values read, the levels, the scores
    written)."""
    from mcmh_localization_tpu_torch.models.range_table import beam_mixture
    from mcmh_localization_tpu_torch.ops.likelihood import lanes_per_particle
    from mcmh_localization_tpu_torch.ops.scan_scores import (
        TableGeometry,
        table_scores,
        table_scores_plain,
    )

    k = cfg.beam_table_n_theta
    valid = torch.isfinite(ranges) & (ranges < cfg.max_range)
    geo = TableGeometry(gm.origin_xy[0], gm.origin_xy[1], gm.res, gm.height,
                        gm.width, k)
    args = (parts, ranges, angles, valid, table, geo, beam_mixture(cfg),
            valid.sum(), "sum")
    got = table_scores(*args)
    want = table_scores_plain(*args)
    torch.cuda.synchronize()
    n = parts.shape[0]
    g = lanes_per_particle(n)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"table_scores N={n} G={g}: kernel != plain "
          f"(max abs err {err})")
    m_valid = int(valid.sum())
    level = table.index is not None
    nq = table.levels.numel() if level else 0
    form = (f"{nq} levels ({table.index.dtype} index)" if level
            else "per-pair f32 table")
    print(f"[kernel] table_scores N={n} M={ranges.shape[0]} ({m_valid} valid) "
          f"K={k}: G={g} lanes a pose, {form}, bitwise")
    ms = device_ms(lambda: table_scores(*args))
    pms = device_ms(lambda: table_scores_plain(*args), runs=5)
    pairs = n * m_valid
    return kernel_row(
        "table_scores", "scan_scores.cu", "gather_pallas.py:180",
        f"N={n} M={ranges.shape[0]} ({m_valid} valid) K={k} "
        f"{'level form' if level else 'per-pair form'} G={g}", ms=ms,
        plain_ms=pms, err=err, ops=table_ops(table, pairs, m_valid),
        nbytes=(n * 16 + ranges.shape[0] * 9 + nq * 4
                + gathered_bytes(table.index if level else table.table,
                                 pairs)))


def table_scores_variants(gm, cfg, tcm, ranges, angles, gen, cov) -> None:
    """Form (a)'s other variants, each ``torch.equal`` to its plain version
    on 2 x 20k poses: the int16 level form (the range table plus 0.01 m x
    (cell mod 8): 400 levels), also at 2 x 150k poses (one lane a pose:
    its pose rows pass the shared budget, so the pairs read the table),
    the per-pair form (the range table plus uniform noise: a level a
    value), and the uint8 form with its LUT in three tiles (every beam of
    the scan valid: 360 rows of 50 levels, 122 rows a tile)."""
    from mcmh_localization_tpu_torch.models.range_table import beam_mixture
    from mcmh_localization_tpu_torch.ops.likelihood import lanes_per_particle
    from mcmh_localization_tpu_torch.ops.scan_scores import (
        TableGeometry,
        table_levels,
        table_scores,
        table_scores_plain,
    )

    geo = TableGeometry(gm.origin_xy[0], gm.origin_xy[1], gm.res, gm.height,
                        gm.width, cfg.beam_table_n_theta)
    parts = mixed_cloud(2 * 20_000, gm, cov, gen)
    cells = torch.arange(tcm.shape[0], device=tcm.device)
    wide = table_levels(tcm + 0.01 * (cells % 8).to(torch.float32)[:, None])
    noisy = tcm + 0.01 * torch.rand(tcm.shape, generator=gen,
                                    device=tcm.device)
    all_valid = ranges.clamp(max=cfg.max_range - 0.1)
    for tag, table, r, want_dtype, p in (
            ("int16 levels", wide, ranges, torch.int16, parts),
            # one lane a pose: 256 rows of 196 bytes pass the shared
            # budget, so the pairs read the index from the table
            ("int16 levels, rows read from the table", wide, ranges,
             torch.int16, mixed_cloud(2 * 150_000, gm, cov, gen)),
            ("per-pair f32 table", table_levels(noisy), ranges, None, parts),
            ("LUT in three tiles", table_levels(tcm), all_valid,
             torch.uint8, parts)):
        check((table.index.dtype if table.index is not None else None)
              == want_dtype, f"table_scores {tag}: the form is not "
              f"{want_dtype}")
        valid = torch.isfinite(r) & (r < cfg.max_range)
        for agg in ("sum", "mean"):
            args = (p, r, angles, valid, table, geo, beam_mixture(cfg),
                    valid.sum(), agg)
            got = table_scores(*args)
            check(torch.equal(got, table_scores_plain(*args)),
                  f"table_scores {tag} {agg}: kernel != plain")
        levels = "f32" if table.index is None else table.levels.numel()
        print(f"[kernel] table_scores {tag} (levels {levels}, "
              f"{int(valid.sum())} valid beams), N={p.shape[0]}, G="
              f"{lanes_per_particle(p.shape[0])}: bitwise, sum and mean")


def voxel_scores_row(tag, parts, u, v, zrow, live, table, geo, count,
                     cfg) -> dict:
    """Kernel 2's fused form (b) on one cloud: ``torch.equal`` to its plain
    version, timed beside its bound (13 operations a pose and live beam, as
    kernel 6; the 16-bit index counted as the values read, and the
    levels); the plain version, seconds a call, timed on its one call."""
    from mcmh_localization_tpu_torch.ops import scan_scores

    args = (parts, u, v, zrow, live, table, geo, count,
            cfg.score_aggregation)
    got = scan_scores.voxel_scores(*args)
    want, pms = once_ms(lambda: scan_scores.voxel_scores_plain(*args))
    n = parts.shape[0]
    g = scan_scores.voxel_lanes(n)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"voxel_scores {tag} N={n} G={g}: kernel "
          f"!= plain (max abs err {err})")
    m = u.shape[0]
    m_live = int(live.sum())
    print(f"[kernel] voxel_scores {tag} N={n} M={m} ({m_live} live, "
          f"{int(count)} valid) volume {(geo.d, geo.h, geo.w)} in "
          f"{table.levels.numel()} levels: G={g} lanes a pose, bitwise")
    ms = device_ms(lambda: scan_scores.voxel_scores(*args))
    pairs = n * m_live
    return kernel_row(
        "voxel_scores", "scan_scores.cu", "gather_pallas.py:180",
        f"{tag} N={n} M={m} ({m_live} live) volume {(geo.d, geo.h, geo.w)} "
        f"G={g}", ms=ms, plain_ms=pms, err=err, ops=13.0 * pairs,
        nbytes=(n * 16 + m * 13 + table.levels.numel() * 4
                + gathered_bytes(table.index, pairs)))


def compare_lidar_kernel(vm, nav, cfg, sensor, ranges, directions, rows):
    """Kernel 2's fused form (b), the 3-D lidar scorer, at the [lidar3d]
    path's shape: 2 x 100k poses (a mixed cloud on the navigation slice)
    and 5760 beams on the building's log-mixture volume in its level form
    (the sensor table's); then the other variants, each ``torch.equal`` to
    its plain version on 2 x 20k poses: the f32 form, and the beams in one
    tile (the first 500, of 512 a tile)."""
    from mcmh_localization_tpu_torch.models.sensor3d import (
        scan_beams,
        voxel_geometry,
    )
    from mcmh_localization_tpu_torch.ops import scan_scores

    gen = torch.Generator(device=ranges.device).manual_seed(17)
    cov = torch.diag(torch.tensor(cfg.initial_cov))
    parts = mixed_cloud(2 * 100_000, nav, cov, gen)
    # the wrapper's inputs as models/sensor3d.py::lidar3d_scores makes them
    u, v, zrow, live, count = scan_beams(ranges, directions, vm, cfg,
                                         cfg.lidar3d_sensor_z)
    geo = voxel_geometry(vm)
    check(sensor.levels.index is not None, "voxel_scores: the building's "
          "volume did not take the level form")
    rows.append(voxel_scores_row("mixed cloud", parts, u, v, zrow, live,
                                 sensor.levels, geo, count, cfg))
    small = parts[:40_000].contiguous()
    f32 = scan_scores.VoxelLevels(None, None, sensor.log_volume)
    for tag, beams, table in (
            ("f32 volume", slice(None), f32),
            ("one beam tile", slice(0, 500), sensor.levels),
            ("one beam tile, f32 volume", slice(0, 500), f32)):
        b = [x[beams].contiguous() for x in (u, v, zrow, live)]
        args = (small, *b, table, geo, count, cfg.score_aggregation)
        check(torch.equal(scan_scores.voxel_scores(*args),
                          scan_scores.voxel_scores_plain(*args)),
              f"voxel_scores {tag}: kernel != plain")
        print(f"[kernel] voxel_scores {tag}: {b[0].shape[0]} beams, "
              f"N={small.shape[0]}: bitwise")


def lut_field_row(tag, qt, s):
    """Kernel 7 on one build's inputs: ``torch.equal`` to its plain
    version, timed beside its bound and its shared-memory floor (B * K * C
    four-byte reads at 128 bytes a clock on each SM at the top SM clock),
    with the chunks of bins its plan stages.  Returns (row, field)."""
    from mcmh_localization_tpu_torch.ops import _cuda
    from mcmh_localization_tpu_torch.ops.beam_field import (
        lut_chunks,
        lut_field,
        lut_field_plain,
        lut_plan,
    )

    out = lut_field(qt, s)
    ref = lut_field_plain(qt, s)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"lut_field {tag}: kernel != plain")
    ms = device_ms(lambda: lut_field(qt, s))
    pms = device_ms(lambda: lut_field_plain(qt, s))
    b, kk, nq = s.shape
    c = qt.shape[1]
    clock = sm_clock_hz()
    smem_ms = (4.0 * b * kk * c / (SMEM_BYTES_PER_CLOCK * _cuda.SM_COUNT
                                   * clock) * 1e3)
    tile, chunk = lut_plan(b, kk, nq, c)
    chunks = len(lut_chunks(kk, chunk))
    print(f"[kernel] lut_field {tag}: {tile.threads} cells and {tile.bpar} b "
          f"a block, {chunks} chunk(s) of {chunk} bins; shared-memory "
          f"floor {smem_ms:.5f} ms at {clock / 1e6:.0f} MHz, "
          f"{smem_ms / ms * 100:.1f}% of the kernel's {ms:.4f} ms on "
          f"{nvidia_smi_line()}")
    # one add per output and bin; qt, s read once, the field written
    return kernel_row(
        "lut_field", "beam_field.cu", "beam_field_pallas.py:115",
        f"{tag} B={b} K={kk} nq={nq} C={c} chunks={chunks}", ms=ms,
        plain_ms=pms, err=0.0, ops=b * kk * c,
        nbytes=kk * c + 4 * (b * kk * nq + b * c), smem_floor_ms=smem_ms,
        chunks=chunks), out


def lut_at_inputs(gm, beam_model, ranges, angles) -> list:
    """[(tag, qt, s, origin, win, qw)]: kernel 7's ``_at`` inputs at the
    beam path's fine build (the whole (K, H, W) table, the window at the
    START pose as an int32 origin on the card) and coarse build (the block
    centres' (K, hc, wc) table whole, origin (0, 0)), each with the cells
    copied out that the launch-argument form takes (``lut_inputs``)."""
    cfg = beam_model.config
    tables = beam_model.log_field
    k = cfg.beam_table_n_theta
    win, tw = cfg.corr_window_cells, cfg.corr_theta_window_bins
    ox0, oy0, _ = start_window(gm, k, win, tw)
    dev = ranges.device
    (_, qw_f, s_f), (_, qw_c, s_c) = lut_inputs(gm, beam_model, ranges,
                                                angles)
    _, hc, wc = tables.qtc.shape
    return [("fine", tables.qt, s_f,
             torch.tensor([oy0, ox0], dtype=torch.int32, device=dev), win,
             qw_f),
            ("coarse", tables.qtc, s_c,
             torch.zeros(2, dtype=torch.int32, device=dev), min(hc, wc),
             qw_c)]


def lut_field_at_row(tag, qt, s, origin, win, qw, prev_ms) -> dict:
    """Kernel 7's ``_at`` entry (the window read in place at a device-held
    origin) on one build: ``torch.equal`` to the launch-argument kernel on
    the window copied out and to its plain version, here and with the
    corner at (0, 0) and at (h - win, w - win); timed beside its bound, the
    plain version and the launch-argument form (``prev_ms``)."""
    from mcmh_localization_tpu_torch.ops.beam_field import (
        lut_chunks,
        lut_field,
        lut_field_at,
        lut_field_at_plain,
        lut_plan,
    )

    k, h, w = qt.shape
    dev = qt.device
    corners = {"path": origin,
               "corner at 0": torch.zeros(2, dtype=torch.int32, device=dev),
               "corner at h - win": torch.tensor(
                   [h - win, w - win], dtype=torch.int32, device=dev)}
    for name, o in corners.items():
        got = lut_field_at(qt, s, o, win)
        oy0, ox0 = o.tolist()
        copied = qt[:, oy0:oy0 + win, ox0:ox0 + win].reshape(
            k, win * win).contiguous()
        check(torch.equal(got, lut_field(copied, s))
              and torch.equal(got, lut_field_at_plain(qt, s, o, win)),
              f"lut_field_at {tag} ({name}): kernel != the launch-argument "
              "kernel or the plain version")
    check(torch.equal(qw, qt[:, origin[0]:origin[0] + win,
                             origin[1]:origin[1] + win].reshape(k, -1)),
          f"lut_field_at {tag}: the launch-argument inputs are another window")
    ms = device_ms(lambda: lut_field_at(qt, s, origin, win))
    pms = device_ms(lambda: lut_field_at_plain(qt, s, origin, win), runs=3)
    b, _, nq = s.shape
    c = win * win
    chunks = len(lut_chunks(k, lut_plan(b, k, nq, c).chunk))
    print(f"[kernel] lut_field_at {tag}: B={b} K={k} win={win} in a ({h}, "
          f"{w}) table, {chunks} chunk(s); bitwise the launch-argument "
          f"kernel and the plain version at the path's origin "
          f"{origin.tolist()} and at both corners; {ms:.4f} ms beside the "
          f"launch-argument form's {prev_ms:.4f} on {nvidia_smi_line()}")
    # lut_field's work, and the origin's 8 bytes
    return kernel_row(
        "lut_field_at", "beam_field.cu", "beam_field_pallas.py:115",
        f"{tag} B={b} K={k} nq={nq} win={win} chunks={chunks}, origin in "
        "device memory", ms=ms, plain_ms=pms, err=0.0, ops=b * k * c,
        nbytes=k * c + 4 * (b * k * nq + b * c) + 8, prev_ms=prev_ms,
        shapes=[])


def bin_lut_row(tag, idx, lp, k: int) -> dict:
    """The bin-LUT kernel on one (R, M) index of table bins: ``torch.equal``
    to its plain version, timed beside its bound, the plain version and
    the one-hot ``torch.einsum`` (the JAX package's form, its one-hot made
    once outside the timed call; f32, TF32 off)."""
    from mcmh_localization_tpu_torch.ops.bin_lut import bin_lut, bin_lut_plain

    idx = idx.to(torch.int32).contiguous()
    out = bin_lut(idx, lp, k)
    ref = bin_lut_plain(idx, lp, k)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"bin_lut {tag}: kernel != plain")
    r, m = idx.shape
    nq = lp.shape[1]
    onehot = (idx.to(torch.int64)[:, :, None]
              == torch.arange(k, device=idx.device)[None, None, :]).to(
                  torch.float32)

    def einsum():
        return torch.einsum("rjg,jq->rgq", onehot, lp)

    lerr = float((einsum() - out).abs().max())
    ms = device_ms(lambda: bin_lut(idx, lp, k))
    pms = device_ms(lambda: bin_lut_plain(idx, lp, k), runs=3)
    lms = device_ms(einsum)
    print(f"[kernel] bin_lut {tag}: R={r} M={m} K={k} nq={nq}, bitwise its "
          f"plain version; the one-hot einsum {lms:.4f} ms (max abs err "
          f"{lerr:.3g}) on {nvidia_smi_line()}")
    # one add a (r, beam, q); idx and lp read once, S written
    return kernel_row(
        "bin_lut", "bin_lut.cu",
        "mcmh_localization_tpu/models/range_table.py:233",
        f"{tag} R={r} M={m} K={k} nq={nq}", ms=ms, plain_ms=pms, err=0.0,
        ops=r * m * nq, nbytes=4 * (r * m + m * nq + r * k * nq),
        library_ms=lms, library=f"one-hot torch.einsum, err {lerr:.3g}",
        shapes=[])


def bin_lut_inputs(beam_model, ranges, angles) -> list:
    """[(tag, idx, lp, K)]: the bin-LUT kernel's inputs on the path: the
    fine window's bins as the general matrix (R = the field bins, each
    beam's table bin at each bin centre), and the one offset row the
    rolled form builds (R = 1; the theta window's and the coarse build's
    call at an integer width ratio)."""
    from mcmh_localization_tpu_torch.models.range_table import (
        _beam_lut,
        _field_bins,
    )
    from mcmh_localization_tpu_torch.utils.f32 import divide

    cfg = beam_model.config
    k = cfg.beam_table_n_theta
    valid = torch.isfinite(ranges) & (ranges < cfg.max_range)
    lp = _beam_lut(torch.where(valid, ranges, 0.0), valid,
                   beam_model.log_field.dvals, cfg)
    nbins = cfg.corr_theta_window_bins or k
    kstart = start_window(beam_model.grid_map, k, cfg.corr_window_cells,
                          cfg.corr_theta_window_bins)[2]
    field = _field_bins(kstart if cfg.corr_theta_window_bins else 0, nbins,
                        angles, k)
    row = (torch.floor(divide(angles, 2.0 * math.pi / k) + 0.5)
           .to(torch.int64) % k)[None, :]
    return [("field bins", field, lp, k), ("offset row", row, lp, k)]


# the mesh sizes whose bin slices [kernel] times: a D-rank theta-sharded
# build (models/range_table.py::_sharded_bin_stack) runs one slice a rank
SLICE_RANKS = (2, 4, 8)


def bin_slice_rows(name, tag, full, k, full_row, calls) -> list:
    """The bin slices a D-rank build runs, for each D in SLICE_RANKS that
    divides the ``k`` bins: every rank's slice ``torch.equal`` to the same
    rows of the full build ``full``; rank 0's slice, its plain version and
    its library call (where there is one, held to the kernel within its
    tolerance) timed beside its bound and the full build's share of its
    bound.  ``calls(b0, n)`` slices the inputs to bins [b0, b0 + n) once,
    so that a timed call launches the kernel alone, and gives (kernel
    call, plain call, (library call, its name, tolerance) or None, ops,
    bytes)."""
    out = []
    for d in SLICE_RANKS:
        if k % d:
            continue
        kd = k // d
        for r in range(d):
            check(torch.equal(calls(r * kd, kd)[0](),
                              full[r * kd:(r + 1) * kd]),
                  f"{name} {tag} bins [{r * kd}, {(r + 1) * kd}) of {k}: "
                  "the slice != the full build's rows")
        kernel, plain, library, ops, nbytes = calls(0, kd)
        lib_ms = lib = None
        if library is not None:
            lib_call, lib_name, tol = library
            lerr = float((lib_call() - kernel()).abs().max())
            check(lerr <= tol, f"{lib_name} yardstick {name} {tag} D={d}: "
                  f"max abs err {lerr} > {tol}")
            lib_ms, lib = device_ms(lib_call, runs=5), f"{lib_name}, err {lerr:.3g}"
        row = kernel_row(
            name, full_row["source"][len(SRC):], full_row["replaces"],
            f"{tag} slice of D={d}: {kd} of {k} bins", err=0.0,
            ms=device_ms(kernel), plain_ms=device_ms(plain), ops=ops,
            nbytes=nbytes, library_ms=lib_ms, library=lib)
        print(f"[kernel] {name} {tag} D={d}: every rank's {kd}-bin slice "
              f"torch.equal to the full build's rows; rank 0's "
              f"{row['ms']:.4f} ms ({row['pct_of_bound']:.1f}% of its bound) "
              f"beside the full build's {full_row['ms']:.4f} ms "
              f"({full_row['pct_of_bound']:.1f}%) on {nvidia_smi_line()}")
        out.append(row)
    return out


def compare_beam_kernel(gm, beam_model, ranges, angles, rows):
    """Phase 3 for kernel 7: the LUT field at the beam path's fine and
    coarse builds, on the path's own quantized table and per-scan LUT."""
    from mcmh_localization_tpu_torch.models.range_table import (
        _beam_geometry,
        table_cell_major,
    )
    from mcmh_localization_tpu_torch.ops.scan_scores import table_levels

    cfg = beam_model.config
    gen = torch.Generator(device=ranges.device).manual_seed(13)
    cov = torch.diag(torch.tensor(cfg.initial_cov))
    tables = beam_model.log_field
    k = cfg.beam_table_n_theta
    valid = torch.isfinite(ranges) & (ranges < cfg.max_range)
    win, tw = cfg.corr_window_cells, cfg.corr_theta_window_bins
    ox0, oy0, kstart = start_window(gm, k, win, tw)
    from mcmh_localization_tpu_torch.ops.beam_field import (
        lut_field,
        lut_field_plain,
    )

    lut_rows, fields, launch_ms = [], [], {}
    for tag, qt, s in lut_inputs(gm, beam_model, ranges, angles):
        row, out = lut_field_row(tag, qt, s)
        launch_ms[tag] = row["ms"]
        b, kk, nq = s.shape
        c = qt.shape[1]
        def calls(b0, n, qt=qt, s=s, kk=kk, nq=nq, c=c):
            sb = s[b0:b0 + n]   # leading rows: a contiguous view
            return (lambda: lut_field(qt, sb), lambda: lut_field_plain(qt, sb),
                    None, n * kk * c, kk * c + 4 * (n * kk * nq + n * c))

        lut_rows += [row] + bin_slice_rows("lut_field", tag, out, b, row,
                                           calls)
        fields.append(out)
    rows.append({**lut_rows[0], "shapes": lut_rows[1:]})
    # kernel 7's _at entry, the window read in place at the device-held
    # origin (the path's form), and the bin-LUT kernel that builds its S
    at_rows = [lut_field_at_row(tag, qt, s, o, w_, qw, launch_ms[tag])
               for tag, qt, s, o, w_, qw in lut_at_inputs(
                   gm, beam_model, ranges, angles)]
    rows.append({**at_rows[0], "shapes": at_rows[1:]})
    bl_rows = [bin_lut_row(f"(C) {tag}", idx, lp, kk)
               for tag, idx, lp, kk in bin_lut_inputs(beam_model, ranges,
                                                       angles)]
    rows.append({**bl_rows[0], "shapes": bl_rows[1:]})

    # kernel 2's fused form (a), the range-table scorer: the staged BIG
    # program's 2 x 1M poses and the [beam] table run's 2 x 1500, on the
    # path's cell-major table (the BIG table: the same 96 bins and range),
    # each in the form its path takes (the uint8 level form at 2 x 1M, the
    # per-pair form below TABLE_LEVEL_MIN_POSES)
    tcm = table_cell_major(tables.table)
    table_rows = []
    for n, level in ((1_000_000, True), (1500, False)):
        table = table_levels(tcm, 2 * n)
        check((table.index is not None) == level
              and (not level or table.index.dtype == torch.uint8),
              f"table_scores 2x{n}: the range table did not take the "
              f"{'uint8 level' if level else 'per-pair'} form")
        table_rows.append(table_scores_row(
            gm, cfg, table, mixed_cloud(2 * n, gm, cov, gen), ranges, angles))
    rows.append({**table_rows[0], "shapes": table_rows[1:]})
    table_scores_variants(gm, cfg, tcm, ranges, angles, gen, cov)
    del tcm, table

    # kernel 5 in the beam op forms at the beam path's geometry and 2x100k
    # poses, on the two fields just built
    kc = cfg.corr_coarse_n_theta
    _, hc, wc = tables.qtc.shape
    fine_t = fields[0].reshape(tw, win, win).transpose(0, 1).reshape(
        win * tw, win).contiguous()
    coarse_t = fields[1].reshape(kc, hc, wc).transpose(0, 1).reshape(
        hc * kc, wc).contiguous()
    geo = _beam_geometry(gm, k, tw, kstart, win, (ox0, oy0),
                         (cfg.corr_coarse_factor, kc, hc, wc))
    parts = mixed_cloud(2 * 100_000, gm, cov, gen)
    n_valid = valid.sum().to(torch.int32)
    row = window_score_row(fine_t, coarse_t, parts, geo,
                           n_valid.clamp(min=1).to(torch.float32), n_valid,
                           "beam op forms")
    next(r for r in rows if r["name"] == "window_score")["shapes"].append(row)


def scan_at(gm, pose, m: int, max_range: float):
    """(ranges, angles): a ray-cast scan of ``m`` beams over [-pi, pi] from
    ``pose``."""
    from mcmh_localization_tpu_torch.models.sensor import raycast

    dev = gm.device
    angles = torch.linspace(-math.pi, math.pi, m, device=dev)
    ranges = raycast(torch.tensor(pose[:2], device=dev), float(pose[2]) + angles,
                     gm, max_range, hit_unknown=True)
    return ranges, angles


def lidar32_directions(dev) -> torch.Tensor:
    """(32768, 2) [azimuth, elevation]: a 32-ring scanner, rings from -15 to
    +15 degrees, 1024 azimuths."""
    az = np.linspace(-np.pi, np.pi, 1024, endpoint=False)
    el = np.deg2rad(np.linspace(-15.0, 15.0, 32))
    return torch.tensor(np.stack([np.repeat(az, el.size), np.tile(el, az.size)],
                                 1), dtype=torch.float32, device=dev)


def row_of(rows, name) -> dict:
    return next(r for r in rows if r["name"] == name)


# poses a cloud of compare_past_caps: kernel 6's (x 2), the scan scorers'
# (x 2)
CAP_POSES_EXACT = 100_000
CAP_POSES_SCAN = 20_000


def compare_past_caps(gm, beam_default, beam, vm, lidar_cfg, lidar, rows):
    """The kernels at the sizes they refused before this slice's repairs,
    each ``torch.equal`` to its plain version and timed beside its bound:
    kernel 7 at the fine (B = K = 360 over 128^2 cells) and coarse (36 over
    96^2) builds of ``FilterConfig(sensor_model="beam",
    corr_window_cells=128)`` at its defaults (K = 360 table bins, nq =
    51), summed in chunks of bins; kernel 6 at 2 x 100k poses on scans of
    2160 and 4096 beams in both cell forms; form (a) at 2 x 20k poses on a
    2160-beam scan in its level and per-pair forms (the [beam] point's
    96-bin table); form (b) at 2 x 20k poses on a 32 x 1024 = 32 768-beam
    scan of the building."""
    from mcmh_localization_tpu_torch.filter.init import init_gaussian
    from mcmh_localization_tpu_torch.models.range_table import (
        beam_mixture,
        table_cell_major,
    )
    from mcmh_localization_tpu_torch.models.sensor import log_likelihood_field
    from mcmh_localization_tpu_torch.models.sensor3d import (
        scan_beams,
        simulate_scan3d,
        voxel_geometry,
    )
    from mcmh_localization_tpu_torch.ops.likelihood import (
        lanes_per_particle,
        likelihood_scores,
        likelihood_scores_plain,
    )
    from mcmh_localization_tpu_torch.ops.scan_scores import (
        TableGeometry,
        TableLevels,
        table_levels,
        table_scores,
        table_scores_plain,
    )

    dev = gm.device
    gen = torch.Generator(device=dev).manual_seed(19)
    cfg = beam_default.config
    cov = torch.diag(torch.tensor(cfg.initial_cov))
    r360, a360 = scan_at(gm, START, N_BEAMS, cfg.max_range)
    launch_ms = {}
    for tag, qt, s in lut_inputs(gm, beam_default, r360, a360):
        row = lut_field_row(f"K=360 {tag}", qt, s)[0]
        row_of(rows, "lut_field")["shapes"].append(row)
        launch_ms[tag] = row["ms"]
    for tag, qt, s, o, w_, qw in lut_at_inputs(gm, beam_default, r360, a360):
        row_of(rows, "lut_field_at")["shapes"].append(lut_field_at_row(
            f"K=360 {tag}", qt, s, o, w_, qw, launch_ms[tag]))
    for tag, idx, lp, kk in bin_lut_inputs(beam_default, r360, a360):
        row_of(rows, "bin_lut")["shapes"].append(
            bin_lut_row(f"(F) {tag}", idx, lp, kk))

    # kernel 6 past its 2048 beams: the exact scorer's inputs as
    # models/sensor.py makes them
    log_field = log_likelihood_field(gm, cfg)
    p6 = init_gaussian(START, cov, 2 * CAP_POSES_EXACT, gm,
                       generator=gen).contiguous()
    g6 = lanes_per_particle(p6.shape[0])
    for m in (2160, 4096):
        ranges, angles = scan_at(gm, START, m, cfg.max_range)
        valid = torch.isfinite(ranges) & (ranges < cfg.max_range)
        safe = torch.where(valid, ranges, 0.0)
        u = (safe * torch.cos(angles)).contiguous()
        v = (safe * torch.sin(angles)).contiguous()
        cnt = valid.sum().to(torch.int32)
        m_valid = int(cnt)
        for div in (True, False):
            a6 = (p6, u, v, valid, log_field, gm.origin_xy[0], gm.origin_xy[1],
                  gm.res if div else gm.inv_res, div, cnt, "mean")
            got = likelihood_scores(*a6)
            want = likelihood_scores_plain(*a6)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            form = "div" if div else "mul"
            check(torch.equal(got, want), f"likelihood_scores M={m} {form}: "
                  f"kernel != plain (max abs err {e})")
            print(f"[kernel] likelihood_scores N={p6.shape[0]} M={m} ({m_valid} "
                  f"valid, {-(-m // 2048)} beam tiles) form={form}: G={g6} "
                  "lanes a pose, bitwise")
            pairs = p6.shape[0] * m_valid
            row_of(rows, "likelihood_scores")["shapes"].append(kernel_row(
                "likelihood_scores", "likelihood.cu",
                "likelihood_pallas.py:113",
                f"N={p6.shape[0]} M={m} ({m_valid} valid) form={form} G={g6}",
                ms=device_ms(lambda: likelihood_scores(*a6)),
                plain_ms=device_ms(lambda: likelihood_scores_plain(*a6),
                                   runs=3),
                err=e, ops=13.0 * pairs,
                nbytes=p6.shape[0] * 16 + m * 12
                + gathered_bytes(log_field, pairs)))
        del u, v

    # form (a) past its 2048 beams, both forms
    bcfg = beam.config
    tcm = table_cell_major(beam.log_field.table)
    ranges, angles = scan_at(gm, START, 2160, bcfg.max_range)
    valid = torch.isfinite(ranges) & (ranges < bcfg.max_range)
    parts = mixed_cloud(2 * CAP_POSES_SCAN, gm, cov, gen)
    geo = TableGeometry(gm.origin_xy[0], gm.origin_xy[1], gm.res, gm.height,
                        gm.width, bcfg.beam_table_n_theta)
    g = lanes_per_particle(parts.shape[0])
    m_valid = int(valid.sum())
    for tag, table in (("level form", table_levels(tcm)),
                       ("per-pair form", TableLevels(None, None, tcm))):
        args = (parts, ranges, angles, valid, table, geo, beam_mixture(bcfg),
                valid.sum(), "sum")
        got = table_scores(*args)
        want = table_scores_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"table_scores M=2160 {tag}: kernel != "
              f"plain (max abs err {err})")
        print(f"[kernel] table_scores N={parts.shape[0]} M=2160 ({m_valid} "
              f"valid) {tag}: G={g} lanes a pose, bitwise")
        pairs = parts.shape[0] * m_valid
        stored = table.index if table.index is not None else table.table
        row_of(rows, "table_scores")["shapes"].append(kernel_row(
            "table_scores", "scan_scores.cu", "gather_pallas.py:180",
            f"N={parts.shape[0]} M=2160 ({m_valid} valid) K="
            f"{geo.n_theta} {tag} G={g}",
            ms=device_ms(lambda: table_scores(*args)),
            plain_ms=device_ms(lambda: table_scores_plain(*args), runs=3),
            err=err, ops=table_ops(table, pairs, m_valid),
            nbytes=(parts.shape[0] * 16 + 2160 * 9
                    + (table.levels.numel() * 4 if table.levels is not None
                       else 0) + gathered_bytes(stored, pairs))))
    del tcm

    # form (b) past its 14 336 beams: 32 rings x 1024 azimuths
    dirs = lidar32_directions(dev)
    scan = simulate_scan3d(gen, START, dirs, vm, lidar_cfg.max_range,
                           sensor_z=lidar_cfg.lidar3d_sensor_z, noise=0.01)
    u, v, zrow, live, count = scan_beams(scan, dirs, vm, lidar_cfg,
                                         lidar_cfg.lidar3d_sensor_z)
    parts = mixed_cloud(2 * CAP_POSES_SCAN, lidar.grid_map, cov, gen)
    row_of(rows, "voxel_scores").setdefault("shapes", []).append(
        voxel_scores_row("32 rings x 1024", parts, u, v, zrow, live,
                         lidar.log_field.levels, voxel_geometry(vm), count,
                         lidar_cfg))


FLEET = 4          # [batched]'s robots
FLEET_LEG = 4      # circle poses between two robots' starts
FLEET_PARTICLES = 100_000  # each robot's, in [batched] and [multimap]


def events_run(model, states, seq, angles, dls):
    """``model.run`` over ``seq`` ((T, M), or a fleet's (T, B, M)): (states,
    infos, ms a scan by CUDA events)."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    states, infos = model.run(states, seq, angles, dls)
    e1.record()
    torch.cuda.synchronize()
    return states, infos, e0.elapsed_time(e1) / seq.shape[0]


def fleet_errors(infos, truth) -> np.ndarray:
    """(B,) each robot's final distance to its true pose ``truth`` (B, 3)."""
    e = infos.estimate.mean[-1].cpu().numpy()
    check(np.isfinite(infos.estimate.mean.cpu().numpy()).all(),
          "non-finite fleet estimate")
    return np.hypot(e[:, 0] - truth[:, 0], e[:, 1] - truth[:, 1])


def check_rows_alone(fleet, models, seq, angles, dls, scans: int,
                     robots, starts, tag: str) -> None:
    """Robot b of a fresh fleet, for each b in ``robots``, gives bitwise the
    estimates its lone ``models[b].step`` gives from the same start on a
    copy of its generator, over ``scans`` scans."""
    from mcmh_localization_tpu_torch.filter.state import copy_generator
    from mcmh_localization_tpu_torch.parallel.batched import state_row

    states = fleet.init(5, initial_poses=starts)
    lone = {b: state_row(states, b).replace(
        key=copy_generator(states.key[b])) for b in robots}
    for t in range(scans):
        states, info = fleet.step(states, seq[t], angles, dls[t])
        for b in robots:
            lone[b], linfo = models[b].step(lone[b], seq[t, b], angles, dls[t, b])
            check(torch.equal(info.estimate.mean[b], linfo.estimate.mean),
                  f"[{tag}] robot {b} scan {t}: the fleet's estimate != its "
                  "lone step's")


def drive_fleet(gm, scans, angles, deltas, poses, smi, counts) -> dict:
    """[batched]: FLEET robots on the house, each at [exact]'s 100k point
    (AMHAMCL, num = min = max = 100 000, the exact "jnp" scorer, "reject",
    360 beams), robot b starting FLEET_LEG * b poses along the circle and
    scanning its own leg; 16 settle + 16 timed fleet scans; robot 0
    bitwise equal to its lone run over 4 scans; the fleet's ms/scan beside
    one robot's alone.  ``counts`` takes the launches of the fleet's 32
    scans.  Returns (a call that runs 16 more fleet scans, ms a fleet
    scan)."""
    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.filter.step import make_model
    from mcmh_localization_tpu_torch.ops import _cuda
    from mcmh_localization_tpu_torch.parallel.batched import (
        make_batched_model,
        state_row,
    )

    n = FLEET_PARTICLES
    cfg = FilterConfig(mode="AMHAMCL", num_particles=n, min_particles=n,
                       max_particles=n, initialized=True, initial_pose=START,
                       likelihood_impl="jnp")
    shift = [FLEET_LEG * b for b in range(FLEET)]
    seq = torch.stack([torch.roll(scans, -k, 0) for k in shift], 1)  # (T, B, M)
    dls = deltas[:, None].expand(-1, FLEET, 3).contiguous()
    starts = [tuple(map(float, poses[k])) for k in shift]
    truth = np.stack([poses[(k - 1) % SCAN_LEN] for k in shift])
    fleet = make_batched_model(cfg, gm, FLEET)
    _cuda.reset_launch_counts()
    states = fleet.init(0, initial_poses=starts)
    states, _, ms_settle = events_run(fleet, states, seq, angles, dls)
    states, infos, ms_fleet = events_run(fleet, states, seq, angles, dls)
    counts.update(_cuda.launch_counts())
    errs = fleet_errors(infos, truth)
    alone = make_model(cfg, gm)
    st = state_row(states, 0)
    st, _, _ = events_run(alone, st, seq[:, 0], angles, deltas)
    st, _, ms_alone = events_run(alone, st, seq[:, 0], angles, deltas)
    check_rows_alone(fleet, [alone] * FLEET, seq, angles, dls, 4, [0], starts,
                     "batched")
    print(f"[batched] {FLEET} robots x AMHAMCL n={n} ('jnp', 'reject', "
          f"{scans.shape[1]} beams), starts {FLEET_LEG} poses apart: "
          f"{ms_fleet:.4f} ms a fleet scan (settle {ms_settle:.4f}); one "
          f"robot alone {ms_alone:.4f} ms/scan, x{FLEET} = "
          f"{FLEET * ms_alone:.4f}; fleet / alone = {ms_fleet / ms_alone:.4f} "
          f"on {smi}; final errors (m) {np.round(errs, 4).tolist()}; robot 0 "
          f"bitwise its lone run over 4 scans; launches {counts}")
    check((errs < 0.2).all(), f"[batched] final errors {errs} m, not all "
          "under 0.2 m")
    for name in ("likelihood_scores", "gather_2d", "expand_sorted"):
        check(counts.get(name, 0) > 0, f"[batched] {name} never launched")
    return functools.partial(events_run, fleet, states, seq, angles,
                             dls), ms_fleet


def walled_house() -> np.ndarray:
    """[multimap]'s second map: the house with an extra 2 m wall across the
    free space east of START."""
    occ = house_occupancy()
    occ[200:240, 230] = 100
    return occ


def drive_multimap(gm, scans, angles, deltas, poses, smi, counts) -> None:
    """[multimap]: two robots, one on the house and one on the walled
    house (each scanning its own map along the circle), MHMCL at 100k (the
    exact "jnp" scorer the multimap model forces), 16 scans; each ends
    under 0.25 m, and each scores on its own map's field: the two fields'
    checksums differ, and each robot of a fresh fleet is bitwise its lone
    model on its own map over 2 scans.  Returns (a call that runs 16 more
    fleet scans, ms a fleet scan)."""
    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.filter.step import make_model
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map
    from mcmh_localization_tpu_torch.ops import _cuda
    from mcmh_localization_tpu_torch.parallel.batched import (
        make_multimap_model,
        map_row,
        stack_maps,
    )

    half = MAP_CELLS * RES / 2
    gm2 = build_grid_map(walled_house(), RES, (-half, -half), device=gm.device)
    scans2 = torch.stack([scan_at(gm2, p, N_BEAMS, 5.0)[0] for p in poses])
    seq = torch.stack([scans, scans2], 1)
    dls = deltas[:, None].expand(-1, 2, 3).contiguous()
    cfg = FilterConfig(mode="MHMCL", num_particles=FLEET_PARTICLES,
                       initialized=True, initial_pose=START)
    maps = stack_maps([gm, gm2])
    fleet = make_multimap_model(cfg, maps, 2)
    check(fleet.config.likelihood_impl == "jnp",
          "[multimap] the multimap model did not force the exact scorer")
    lone = [make_model(fleet.config, map_row(maps, b)) for b in range(2)]
    sums = [float(m.log_field.double().sum()) for m in lone]
    check(sums[0] != sums[1], "[multimap] the two maps' fields are alike")
    _cuda.reset_launch_counts()
    states, infos, ms = events_run(fleet, fleet.init(0), seq, angles, dls)
    counts.update(_cuda.launch_counts())
    errs = fleet_errors(infos, np.stack([poses[-1]] * 2))
    check_rows_alone(fleet, lone, seq, angles, dls, 2, [0, 1], None,
                     "multimap")
    print(f"[multimap] 2 robots x MHMCL n={FLEET_PARTICLES} ('jnp'), the "
          f"house and the "
          f"walled house (field checksums {sums[0]:.6f} / {sums[1]:.6f}): "
          f"{ms:.4f} ms a fleet scan over {SCAN_LEN} scans on {smi}; final "
          f"errors (m) {np.round(errs, 4).tolist()}; each robot bitwise its "
          f"lone model on its own map over 2 scans; launches {counts}")
    check((errs < 0.25).all(), f"[multimap] final errors {errs} m, not all "
          "under 0.25 m")
    check(counts.get("likelihood_scores", 0) > 0,
          "[multimap] likelihood_scores never launched")
    return functools.partial(events_run, fleet, states, seq, angles, dls), ms


def drive_entry(smi, counts) -> None:
    """[entry]: ``graft_entry.entry()`` on the card: one step, then 16 timed
    steps chained on the example scan; a finite estimate, 4096 particles,
    kernels 6 and 3 launched.  Returns (a call that runs 16 more steps, ms
    a step)."""
    from mcmh_localization_tpu_torch import graft_entry
    from mcmh_localization_tpu_torch.ops import _cuda

    fn, (st, ranges, angles, delta) = graft_entry.entry()
    check(st.particles.device.type == "cuda", "[entry] not on the card")

    def steps(st):
        for _ in range(SCAN_LEN):
            st, info = fn(st, ranges, angles, delta)
        return st, info

    _cuda.reset_launch_counts()
    st, info = fn(st, ranges, angles, delta)
    (st, info), ms = once_ms(lambda: steps(st))
    ms /= SCAN_LEN
    counts.update(_cuda.launch_counts())
    est = info.estimate.mean.cpu().numpy()
    print(f"[entry] graft_entry.entry(): AMHAMCL n={st.particles.shape[0]} "
          f"on the 256^2 room: {ms:.4f} ms/step "
          f"over {SCAN_LEN} steps on {smi}; estimate {np.round(est, 4)}; "
          f"count {int(st.count)}; launches {counts}")
    check(np.isfinite(est).all(), "[entry] non-finite estimate")
    check(st.particles.shape[0] == 4096, "[entry] not 4096 particles")
    for name in ("likelihood_scores", "expand_sorted"):
        check(counts.get(name, 0) > 0, f"[entry] {name} never launched")
    return functools.partial(steps, st), ms


# [edt]'s map sides: the kernel torch.equal to its plain version at each of
# EDT_SIDES (37 x 53 random, the house, the house tiled to 2048^2), and
# equal to scipy's rounded squares at EDT_SCIPY_SIDE (the house tiled to a
# 205 m floor at 0.05 m)
EDT_SIDES = ((37, 53), (MAP_CELLS, MAP_CELLS), (2048, 2048))
EDT_SCIPY_SIDE = 4096


def edt_occupied(h: int, w: int) -> np.ndarray:
    """(h, w) bool: 10% random cells below the house's side, else the
    house's occupied and unknown cells, tiled."""
    if h < MAP_CELLS:
        return np.random.default_rng(h * w).random((h, w)) < 0.1
    house = house_occupancy() != 0
    k = -(-max(h, w) // MAP_CELLS)
    return np.ascontiguousarray(np.tile(house, (k, k))[:h, :w])


def scipy_squares(occ: np.ndarray) -> tuple:
    """(scipy's squared distances rounded to integers as f32, its host ms)."""
    from scipy.ndimage import distance_transform_edt

    t0 = time.perf_counter()
    d = distance_transform_edt(~occ)
    ms = (time.perf_counter() - t0) * 1e3
    return np.rint(d * d).astype(np.float32), ms


def edt_row(occ: np.ndarray, plain_chunk: int = 128) -> dict:
    """The EDT kernel at one map: ``torch.equal`` to its plain version (in
    column chunks of ``plain_chunk``) and to scipy's rounded squares, timed
    beside its bound, the plain version and scipy on the host."""
    from mcmh_localization_tpu_torch.ops.edt import (
        squared_edt,
        squared_edt_plain,
    )

    h, w = occ.shape
    oc = torch.from_numpy(occ).cuda()
    k = squared_edt(oc)
    plain, pms = once_ms(lambda: squared_edt_plain(oc, plain_chunk))
    check(torch.equal(k, plain), f"squared_edt {h}x{w}: kernel != plain")
    del plain
    ref, sms = scipy_squares(occ)
    check(np.array_equal(k.cpu().numpy(), ref),
          f"squared_edt {h}x{w}: kernel != scipy's rounded squares")
    ms = device_ms(lambda: squared_edt(oc))
    print(f"[kernel] squared_edt {h}x{w}: torch.equal to the plain version "
          f"(chunk {plain_chunk}) and to scipy's rounded squares; scipy on "
          f"the host {sms:.2f} ms")
    # each input byte read once, each f32 written once; at least one min a
    # cell in each pass
    return kernel_row(
        "squared_edt", "edt.cu", "mcmh_localization_tpu/maps/edt.py:51",
        f"{h}x{w}", ms=ms, plain_ms=pms, err=0.0, ops=2 * h * w,
        nbytes=5 * h * w, scipy_host_ms=sms)


def drive_edt(gm, timed, scans, deltas, poses, smi, counts, rows) -> None:
    """[edt]: the house built with ``edt_impl="device"`` on the card (the
    EDT kernel, two launches a map build), its field within one ulp of
    the scipy map's ``gm``, and ``FilterConfig()`` tracking on it, 8 + 8
    scans under 0.25 m; ``counts`` gets the launches of that build and
    run.  Then the kernel against its plain version and scipy at every
    side of ``EDT_SIDES`` and ``EDT_SCIPY_SIDE`` (its rows join ``rows``)."""
    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.filter.step import make_model
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map
    from mcmh_localization_tpu_torch.ops import _cuda

    half = MAP_CELLS * RES / 2
    occ = house_occupancy()
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gm_dev = build_grid_map(occ, RES, (-half, -half), edt_impl="device",
                            device=gm.device)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    builds = _cuda.launch_counts().get("squared_edt", 0)
    t0 = time.perf_counter()
    build_grid_map(occ, RES, (-half, -half), device=gm.device)
    torch.cuda.synchronize()
    scipy_s = time.perf_counter() - t0
    a, b = gm_dev.distance.cpu().numpy(), gm.distance.cpu().numpy()
    ulps = np.abs(a - b) / np.spacing(np.maximum(a, b))
    print(f"[edt] build_grid_map({MAP_CELLS}^2 house, edt_impl='device') "
          f"{dev_s * 1e3:.2f} ms against 'scipy' {scipy_s * 1e3:.2f} ms by "
          f"the host clock on {smi}; the field differs from scipy's in "
          f"{int((ulps > 0).sum())} of {a.size} cells, by at most "
          f"{ulps.max():.0f} ulp; {builds} EDT launches")
    check(builds == 2, f"[edt] {builds} EDT launches in one map build")
    check(ulps.max() <= 1, f"[edt] device field {ulps.max()} ulp off scipy's")
    for name in ("occupancy", "origin", "resolution", "free_xy", "free_mask"):
        check(torch.equal(getattr(gm_dev, name), getattr(gm, name)),
              f"[edt] {name} differs from the scipy map's")
    cfg = FilterConfig(initialized=True, initial_pose=START)
    model = make_model(cfg, gm_dev)
    st, _, _ = timed(model, model.init(0), 1, seq=scans[:8], dls=deltas[:8])
    st, x_infos, ms_x = timed(model, st, 1, seq=scans[8:], dls=deltas[8:])
    e = x_infos.estimate.mean.cpu().numpy()
    check(np.isfinite(e).all(), "[edt] non-finite estimate")
    err8 = float(np.mean(np.hypot(e[:, 0] - poses[8:, 0],
                                  e[:, 1] - poses[8:, 1])))
    counts.update(_cuda.launch_counts())
    print(f"[edt] FilterConfig() (n={cfg.num_particles}) on the device-EDT "
          f"map: {ms_x:.4f} ms/scan over 8 timed scans on {smi}; mean error "
          f"last 8 {err8:.4f} m; launches {counts}")
    check(err8 < 0.25, f"[edt] error {err8:.3f} m >= 0.25 m")
    check(counts.get("likelihood_scores", 0) >= SCAN_LEN,
          "[edt] likelihood_scores not launched every scan")
    del model, st, gm_dev
    row = edt_row(edt_occupied(MAP_CELLS, MAP_CELLS))
    row["shapes"] = [edt_row(edt_occupied(h, w)) for h, w in EDT_SIDES
                     if (h, w) != (MAP_CELLS, MAP_CELLS)]
    # past 2896 cells a side the squares pass 2^24, held against scipy; the
    # plain version in chunks of 32 columns (4.3 GB of int64 at a time)
    row["shapes"].append(edt_row(edt_occupied(EDT_SCIPY_SIDE, EDT_SCIPY_SIDE),
                                 plain_chunk=32))
    rows.append(row)


ONLINE_SCANS = 3 * SCAN_LEN   # about 48 scans, three odometry messages each
ONLINE_RESUME = 5             # scans replayed after the checkpoint


def odom_between(a, b, k: int, n: int):
    """The odometry pose k/n of the way from pose a to pose b (the heading
    along the shorter turn)."""
    turn = (b[2] - a[2] + math.pi) % (2 * math.pi) - math.pi
    f = k / n
    return (float(a[0] + f * (b[0] - a[0])), float(a[1] + f * (b[1] - a[1])),
            float(a[2] + f * turn))


def drive_online(cfg, gm, scans, angles, poses, smi) -> int:
    """``[online]``: ``OnlineLocalizer(staged=True)`` at the main path's
    configuration over ONLINE_SCANS scans of the circle, three ``on_odom``
    calls before each ``on_scan``.  Checks that ``warmup`` leaves the
    generator's state as it was, that the facade hands off to SMALL and
    ends under 0.2 m, and that a checkpoint taken in SMALL and loaded again
    replays the next ONLINE_RESUME scans' estimates bitwise.  Prints the ms
    per ``on_scan`` (host clock; each ends in the estimate's copy to the
    host) of each program.  Returns the scans it ran."""
    import tempfile

    from mcmh_localization_tpu_torch.filter.online import OnlineLocalizer

    loc = OnlineLocalizer(cfg, gm, seed=0, staged=True,
                          tracking_ess_threshold=0.9)
    check(loc.staged.big.replays_graph and loc.staged.small.replays_graph,
          "[online] on_scan would not replay a captured correct step")
    gen_before = loc.state.key.get_state().clone()
    t0 = time.perf_counter()
    loc.warmup(scans[0], angles)
    warm_s = time.perf_counter() - t0
    check(torch.equal(loc.state.key.get_state(), gen_before),
          "[online] warmup moved the localizer's generator")
    check(loc.last_info is None and not loc._in_small,
          "[online] warmup changed the facade's state")
    print(f"[online] warmup (one BIG and one SMALL throwaway step on copies "
          f"of the generator, capturing each program's correct step) "
          f"{warm_s:.2f} s; generator state unchanged")

    def scan_step(t):
        """Odometry from pose t - 1 to pose t in three messages, then scan t;
        returns (estimate, program of the correct step, on_scan seconds)."""
        a, b = poses[(t - 1) % SCAN_LEN], poses[t % SCAN_LEN]
        for k in (1, 2, 3):
            loc.on_odom(*odom_between(a, b, k, 3))
        small = loc._in_small
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        est = loc.on_scan(scans[t % SCAN_LEN], angles)
        return est, small, time.perf_counter() - t1

    loc.on_odom(*map(float, poses[0]))
    times = {False: [], True: []}
    modes = []
    saved_at = None
    t = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "online.npz")
        while t < ONLINE_SCANS:
            t += 1
            est, small, dt = scan_step(t)
            times[small].append(dt)
            modes.append(int(loc._in_small))
            if (saved_at is None and loc._in_small
                    and t >= ONLINE_SCANS - 2 * ONLINE_RESUME):
                saved_at = t
                loc.save_checkpoint(path)
                replay = [scan_step(t + i)[0]["pose3"]
                          for i in range(1, ONLINE_RESUME + 1)]
                loc.load_checkpoint(path)
                check(loc._in_small and loc.state.particles.shape[0]
                      == loc._cap, "[online] the checkpoint did not resume SMALL")
                loc.on_odom(*map(float, poses[t % SCAN_LEN]))
                again = []
                for i in range(1, ONLINE_RESUME + 1):
                    est = scan_step(t + i)[0]
                    again.append(est["pose3"])
                check(replay == again, f"[online] the resumed estimates "
                      f"{again} != {replay}")
                print(f"[online] checkpoint at scan {t} in SMALL (capacity "
                      f"{loc._cap}): the next {ONLINE_RESUME} estimates after "
                      "load_checkpoint equal those without it, bitwise")
                t += ONLINE_RESUME
    truth = poses[t % SCAN_LEN]
    err = float(np.hypot(est["pose3"][0] - truth[0], est["pose3"][1] - truth[1]))
    check(saved_at is not None, "[online] never handed off to SMALL")
    check(np.isfinite(est["pose3"]).all(), "[online] non-finite estimate")
    check(err < 0.2, f"[online] final error {err:.3f} m >= 0.2 m")
    print(f"[online] {t} scans, programs {modes} (1 = SMALL, the replayed "
          f"scans not listed); final error {err:.4f} m")
    for small, tag in ((False, "BIG"), (True, "SMALL")):
        ts = times[small]
        if ts:
            print(f"[online] {tag} on_scan: {1e3 * float(np.mean(ts)):.4f} ms "
                  f"mean, {1e3 * float(np.median(ts)):.4f} median over "
                  f"{len(ts)} scans on {smi}")
    return t + ONLINE_RESUME


def sync_count(fn) -> tuple:
    """(result, host syncs) of ``fn``: the synchronizing CUDA calls
    ``torch.cuda.set_sync_debug_mode("warn")`` reports."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def profile_window(fn, scans: int) -> tuple:
    """(device busy ms/scan, kernels a scan, host self ms/scan) of ``fn``'s
    ``scans`` scans under torch.profiler: busy is the kernels', copies' and
    memsets' own time on the card."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        trace = Path(d) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    busy = sum(e.get("dur", 0.0) for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    kernels = sum(e.get("cat") == "kernel" for e in events)
    host = sum(e.self_cpu_time_total for e in prof.key_averages())
    return busy / 1e3 / scans, kernels / scans, host / 1e3 / scans


def run_if_row(dev) -> dict:
    """The conditional node's kernel (csrc/graph_cond.cu, ``run_if``):
    R nodes on alternating predicates captured in one graph, each body one
    add; the replay's result equal to R host ifs (the plain version), and
    the time of a node beside the host if's, both per gate."""
    from mcmh_localization_tpu_torch.ops import graph as cgraph

    r = 32
    preds = (torch.arange(r, device=dev) % 3 == 0)
    x = torch.zeros((), device=dev)

    def gates():
        for i in range(r):
            (y,) = cgraph.run_if(preds[i], lambda i=i: [x + (i + 1)], [x],
                                 donate=True)
            x.copy_(y)

    g = torch.cuda.CUDAGraph()
    with cgraph.capturing(dev) as cap, torch.cuda.graph(g):
        gates()
    x.zero_()
    g.replay()
    torch.cuda.synchronize()
    got = float(x)
    want = float(sum(i + 1 for i in range(r) if i % 3 == 0))
    x.zero_()
    gates()
    check(got == want == float(x), f"run_if: replay {got}, host ifs "
          f"{float(x)}, expected {want}")

    def replay():
        g.replay()

    ms = device_ms(replay) / r
    pms = device_ms(gates, runs=5) / r
    row = kernel_row(
        "run_if", "graph_cond.cu",
        "mcmh_localization_tpu/filter/step.py:529", f"{r} IF nodes",
        ms=ms, plain_ms=pms, err=0.0, ops=1.0, nbytes=1.0 + 16.0)
    print(f"[graph] run_if: {r} conditional nodes replayed equal {r} host "
          f"ifs; {ms * 1e3:.2f} us a node beside {pms * 1e3:.2f} us a host "
          f"if (its read of the predicate waits on the card) on "
          f"{nvidia_smi_line()}")
    del g, replay
    cap.release()
    return row


def trace_stamp_row(dev) -> dict:
    """The stage stamp (csrc/trace_stamp.cu, ``utils/profiling.py``'s
    stage clock): 20 rounds of stages 0..4, a sleep kernel of a known
    length before each of stages 1..4 and a CUDA event after every stamp,
    all queued behind one long sleep so the card never waits for the host.
    Its counts equal its plain version's over the same rounds exactly,
    stage 0 adds no time (it opens a round), and each stage's time is
    within 1 us a stamp of the events after its stamp and the one before
    it (the timer ticks in 32 ns, an event in 0.5 us); one stamp timed
    beside the plain version's host call.  The kernel's first launch, which
    loads it, comes before the rounds."""
    from mcmh_localization_tpu_torch.ops.trace_stamp import (
        trace_stamp,
        trace_stamp_plain,
    )

    stages, rounds = 5, 20
    cycles = (0, 100_000, 200_000, 400_000, 800_000)
    buf = torch.zeros(2 * stages + 1, dtype=torch.int64, device=dev)
    plain = torch.zeros(2 * stages + 1, dtype=torch.int64)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(stages)]
          for _ in range(rounds)]
    trace_stamp(torch.zeros_like(buf), 0, stages)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    for r in range(rounds):
        for s in range(stages):
            if cycles[s]:
                torch.cuda._sleep(cycles[s])
            trace_stamp(buf, s, stages)
            ev[r][s].record()
            trace_stamp_plain(plain, s, stages)
    torch.cuda.synchronize()
    got = buf.cpu()
    want_ms = [sum(ev[r][s - 1].elapsed_time(ev[r][s]) for r in range(rounds))
               for s in range(1, stages)]
    got_ms = (got[1:stages].double() * 1e-6).tolist()
    off = max(abs(g - w) / w for g, w in zip(got_ms, want_ms))
    print(f"[kernel] trace_stamp: {rounds} rounds of {stages} stages, counts "
          f"{got[stages:2 * stages].tolist()} (plain "
          f"{plain[stages:2 * stages].tolist()}), stage ms "
          f"{[round(g, 5) for g in got_ms]} against the events' "
          f"{[round(w, 5) for w in want_ms]} (at most {100 * off:.2f}% off) "
          f"on {nvidia_smi_line()}")
    check(torch.equal(got[stages:2 * stages], plain[stages:2 * stages]),
          "trace_stamp: its counts != the plain version's")
    check(int(got[0]) == 0 == int(plain[0]),
          "trace_stamp: stage 0 added time")
    for s, (g, w) in enumerate(zip(got_ms, want_ms), start=1):
        check(abs(g - w) <= rounds * 1e-3,
              f"trace_stamp: stage {s} {g:.5f} ms against the events' "
              f"{w:.5f}")
    ms = device_ms(lambda: trace_stamp(buf, 1, stages))
    t0 = time.perf_counter()
    for _ in range(1000):
        trace_stamp_plain(plain, 1, stages)
    pms = (time.perf_counter() - t0)  # ms a call over 1000 calls
    return kernel_row(
        "trace_stamp", "trace_stamp.cu",
        "mcmh_localization_tpu/ (none: the JAX step is timed from outside)",
        f"one stamp of {stages} stages", ms=ms, plain_ms=pms, err=0.0,
        ops=1.0, nbytes=48.0, stage_err=off, on_main_path=False)


def graph_check(tag, model, st, scans, angles, deltas, smi) -> dict:
    """One config's captured run against its eager steps over the SCAN_LEN
    scans ``scans`` from ``st`` (on copies of its generator): every state
    field, the generator's state and every StepInfo field ``torch.equal``;
    a captured chunk under ``set_sync_debug_mode("error")`` and no host
    sync a captured scan; ms/scan by CUDA events (in turns: eager,
    captured, captured, eager), device busy, idle share, kernels a scan and
    host self time under torch.profiler, host syncs a scan, the graph's
    nodes a replay (top and bodies) and the scans that ran each
    conditional body.  Prints the row and returns it, with the
    ``CapturedStep`` under "graph"."""
    from mcmh_localization_tpu_torch.filter.captured import STATE_TENSORS
    from mcmh_localization_tpu_torch.filter.state import copy_generator
    from mcmh_localization_tpu_torch.filter.step import StepInfo

    check(model.replays_graph, f"[graph] {tag}: not graph-capturable")
    t = scans.shape[0]

    def fresh():
        return st.replace(key=copy_generator(st.key))

    def eager():
        return model.run_eager(fresh(), scans, angles, deltas)

    def captured():
        return model.run(fresh(), scans, angles, deltas)

    e_st, e_inf = eager()
    c_st, c_inf = captured()
    torch.cuda.synchronize()
    for f in STATE_TENSORS:
        check(torch.equal(getattr(e_st, f), getattr(c_st, f)),
              f"[graph] {tag}: captured state.{f} != eager")
    check(torch.equal(e_st.key.get_state(), c_st.key.get_state()),
          f"[graph] {tag}: the generators moved apart")
    for f in StepInfo._fields:
        a, b = getattr(e_inf, f), getattr(c_inf, f)
        pairs = (zip(a, b) if f == "estimate" else ((a, b),))
        for x, y in pairs:
            check(torch.equal(x, y), f"[graph] {tag}: StepInfo.{f} "
                  "captured != eager")
    graph = model.captured(st, scans.shape[1])
    cap = graph.capture
    taken0 = cap.taken[:len(cap.bodies)].clone()
    torch.cuda.set_sync_debug_mode("error")
    try:
        captured()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    taken = (cap.taken[:len(cap.bodies)] - taken0).tolist()
    _, syncs_e = sync_count(eager)
    _, syncs_c = sync_count(captured)
    check(syncs_c == 0, f"[graph] {tag}: {syncs_c} host syncs in a captured "
          "chunk")
    ms = {"eager": [], "captured": []}
    for kind in ("eager", "captured", "captured", "eager"):
        _, dt = once_ms(eager if kind == "eager" else captured)
        ms[kind].append(dt / t)
    busy_e, kern_e, host_e = profile_window(eager, t)
    busy_c, kern_c, host_c = profile_window(captured, t)
    check(busy_c > 0 and busy_e > 0,
          f"[graph] {tag}: the profiler saw no device time")
    ms_e, ms_c = float(np.mean(ms["eager"])), float(np.mean(ms["captured"]))
    nodes = graph.launches_per_scan()
    bodies = ", ".join(f"{n} {k}/{t}" for n, k in zip(cap.names, taken))
    print(f"[graph] {tag} (n_max={st.n_max}): captured == eager (torch.equal: "
          f"every state field, the generator, every StepInfo field) over {t} "
          "scans; no sync in a captured chunk under "
          "set_sync_debug_mode('error')")
    print(f"[graph] {tag}: ms/scan captured {ms_c:.4f} "
          f"({', '.join(f'{x:.4f}' for x in ms['captured'])}) beside eager "
          f"{ms_e:.4f} ({', '.join(f'{x:.4f}' for x in ms['eager'])}); "
          f"device busy {busy_c:.4f} / {busy_e:.4f} ms/scan -> idle share "
          f"{1 - busy_c / ms_c:.3f} / {1 - busy_e / ms_e:.3f}; kernels a "
          f"scan {kern_c:.1f} / {kern_e:.1f} (profiler); host self time "
          f"{host_c:.4f} / {host_e:.4f} ms/scan; host syncs a scan "
          f"{syncs_c / t:.2f} / {syncs_e / t:.2f} (captured / eager) on {smi}")
    print(f"[graph] {tag}: graph nodes a replay {json.dumps(nodes)}; "
          f"conditional bodies run: {bodies or 'none'}")
    return dict(ms_captured=ms_c, ms_eager=ms_e, busy_captured=busy_c,
                busy_eager=busy_e, kernels_captured=kern_c,
                kernels_eager=kern_e, host_captured=host_c,
                host_eager=host_e, syncs_captured=syncs_c / t,
                syncs_eager=syncs_e / t, nodes=nodes,
                bodies=dict(zip(cap.names, taken)), scans=t,
                graph=graph, final=c_st)


def drive_graph(staged, big_state, small_state, scans, angles, deltas,
                smi) -> dict:
    """``[graph]``: each staged program's captured step against its eager
    steps over one chunk of SCAN_LEN scans (``graph_check``), and the
    device time of the work the gates run on every scan (the draws before
    the gates and the carries) beside the program's device busy."""
    from mcmh_localization_tpu_torch.filter.state import copy_generator
    from mcmh_localization_tpu_torch.filter.step import Draws, _resample_draws

    out = {}
    for tag, model, st in (("SMALL", staged.small, small_state),
                           ("BIG", staged.big, big_state)):
        row = graph_check(tag, model, st, scans, angles, deltas, smi)
        cap = row.pop("graph").capture
        c_st = row.pop("final")
        # the gates' always-run work: the draws made before them, the
        # carries cloned for them, and (BIG) the escalation's padded prefix
        cfg = model.config
        draws_ms = device_ms(lambda: _resample_draws(
            st.replace(key=copy_generator(st.key)), model.grid_map, cfg,
            Draws()))
        n = st.n_max
        # the ESS gate's carry is donated but for a copy of the count and
        # the zero injection probability
        carry_ms = (device_ms(lambda: (c_st.count.clone(), torch.full(
            (), 0.0, device=st.device)))
            if cfg.resample_ess_threshold < 1.0 else 0.0)
        pad_ms = 0.0
        if "escalate" in cap.names:
            w1 = 131_072
            pad_ms = device_ms(lambda: torch.cat(
                [c_st.particles[:w1], torch.zeros((n - w1, 3), device=st.device)]))
        always = draws_ms + carry_ms + pad_ms
        print(f"[graph] {tag}: gates' always-run work {always:.4f} ms/scan "
              f"(draws before the gates {draws_ms:.4f}, the ESS gate's "
              f"carry {carry_ms:.4f}, the escalation's padded prefix "
              f"{pad_ms:.4f}) = {100 * always / row['busy_captured']:.2f}% of "
              f"the captured device busy; every gate is a conditional node "
              f"({', '.join(cap.names)})")
        out[tag] = dict(row, always_ms=always)
    print(f"[graph] {json.dumps(out)}")
    return out


def graph_pool_bytes(graph) -> int:
    """The device memory the segments of ``graph``'s private pool hold
    (the caching allocator's snapshot), or 0 where the snapshot names no
    pool."""
    pool = tuple(graph.pool())
    return sum(seg.get("total_size", 0)
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == pool)


def graph_row(rows: dict, tag, model, st, scans, angles, deltas, smi):
    """``graph_check`` of one config into ``rows`` (its JSON line's
    entries); returns the row with its graph and final state."""
    row = graph_check(tag, model, st, scans, angles, deltas, smi)
    rows[tag] = {k: v for k, v in row.items() if k not in ("graph", "final")}
    return row


def zero_scan_check(model, st, beams: int, dims: tuple) -> None:
    """F6 on the card: ``model.run`` (a captured config) and ``run_eager``
    over a zero-scan trajectory return the state ``torch.equal`` to the
    input, the generator unmoved and a StepInfo with a leading 0; neither
    captures, replays nor launches a kernel."""
    from mcmh_localization_tpu_torch.filter.captured import STATE_TENSORS
    from mcmh_localization_tpu_torch.ops import _cuda

    dev = st.particles.device
    scans = torch.zeros((0, beams), device=dev)
    angles = torch.zeros(dims, device=dev)
    deltas = torch.zeros((0, 3), device=dev)
    key = st.key.get_state()
    for name, run in (("captured", model.run), ("eager", model.run_eager)):
        _cuda.reset_launch_counts()
        new, infos = run(st, scans, angles, deltas)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _cuda.launch_counts().items() if v}
        check(all(torch.equal(getattr(new, f), getattr(st, f))
                  for f in STATE_TENSORS)
              and torch.equal(new.key.get_state(), key),
              f"[single] T = 0 ({name}): the state moved")
        check(infos.estimate.mean.shape == (0, 3)
              and infos.estimate.cov.shape == (0, 3, 3)
              and infos.count.shape == (0,)
              and infos.count.dtype == torch.int32
              and infos.ess.shape == (0,),
              f"[single] T = 0 ({name}): StepInfo shapes "
              f"{infos.estimate.mean.shape}, {infos.count.shape}")
        check(not launched, f"[single] T = 0 ({name}) launched {launched}")
    check(model.captured(st, beams).graph is None,
          "[single] T = 0 captured a step")
    print("[single] T = 0 (F6): the captured run and run_eager return the "
          "state torch.equal to the input, the generator unmoved and a "
          "StepInfo of (0, ...) fields; no capture, replay or launch")


EVAL_SECONDS = 30.0   # the runner's default --duration; whole squares: 178 scans
# the [main] configuration as a reference-format params YAML (field names
# pass through FilterConfig.from_yaml; the pose comes from --initialized)
EVAL_PARAMS = """\
localization_mode: AMHAMCL
init_particles: 1000000
min_particles: 100000
max_particles: 1000000
kld_eval_window: 0
coarse_gate_escapees: 0
corr_window_cells: 128
corr_theta_window_bins: 32
likelihood_impl: corr
motion_validity: score
min_injection_prob: 0.02
"""


def write_map_yaml(d: Path, occ: np.ndarray, origin) -> str:
    """The map as a map_server PGM + YAML pair (free 254, occupied 0,
    unknown 205; PGM row 0 is the map's top), written with the port's
    ``io/pgm.py``."""
    from mcmh_localization_tpu_torch.io.pgm import write_pgm

    img = np.where(occ == 0, 254, np.where(occ > 0, 0, 205)).astype(np.uint8)
    write_pgm(str(d / "house.pgm"), img[::-1])
    (d / "house.yaml").write_text(
        f"image: house.pgm\nresolution: {RES}\n"
        f"origin: [{origin[0]}, {origin[1]}, 0.0]\nnegate: 0\n"
        "occupied_thresh: 0.65\nfree_thresh: 0.196\n")
    return str(d / "house.yaml")


def run_cli(argv: list) -> tuple:
    """``eval/runner.py::main(argv)``; returns (EvalResult, its stdout,
    ms/scan as the runner printed it), the stdout echoed."""
    import contextlib
    import io
    import re

    from mcmh_localization_tpu_torch.eval.runner import main as runner_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = runner_main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"[eval] runner: {line}")
    ms = re.search(r"\(([0-9.]+) ms/scan\)", out)
    check(ms is not None, "[eval] the runner printed no ms/scan")
    return res, out, float(ms.group(1))


def drive_eval(cfg, gm, smi, reset, counts) -> list:
    """``[eval]``: the experiment runner's CLI on the card.  Writes the
    house map as PGM + YAML and the [main] configuration as a params YAML,
    simulates the ``square`` scenario fitted to the map (EVAL_SECONDS at
    5 Hz, 360 beams, 0.01 m range noise) on the card, round-trips the bag
    through npz (bitwise), ROS1 and ROS2 bag files, then runs ``single
    --staged`` at 1M / 100k with the 0.9 tracking ESS gate and
    ``FilterConfig()`` at 1500 particles on it through ``main``, and times
    ``warmup_staged``.  Returns [(path tag, launch counts, scans)] of the
    two runs, "eval" (staged, its warmup's scans counted) and "eval_exact"
    (``reset()`` zeroes the launch counts, ``counts()`` reads them)."""
    import re
    import tempfile

    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.eval.evaluator import (
        parse_poses_file,
        parse_results_file,
    )
    from mcmh_localization_tpu_torch.filter.staged import (
        make_staged_model,
        warmup_staged,
    )
    from mcmh_localization_tpu_torch.io.rosbag import read_rosbag, write_rosbag
    from mcmh_localization_tpu_torch.io.rosbag2 import read_rosbag2, write_rosbag2
    from mcmh_localization_tpu_torch.maps.grid_map import load_map
    from mcmh_localization_tpu_torch.sim import (
        SCENARIOS,
        fit_trajectory_to_map,
        load_bag,
        save_bag,
        simulate_bag,
    )
    from mcmh_localization_tpu_torch.sim.simulator import odometry_deltas
    from mcmh_localization_tpu_torch.utils.metrics import read_metrics

    launches = []
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        yaml = write_map_yaml(d, house_occupancy(), gm.origin_xy)
        (d / "main.yaml").write_text(EVAL_PARAMS)
        (d / "defaults.yaml").write_text("# FilterConfig() as it ships\n")
        from_yaml = FilterConfig.from_yaml(str(d / "main.yaml"))
        check(from_yaml.replace(initialized=True, initial_pose=START) == cfg,
              "[eval] the params YAML does not give the [main] configuration")
        gm_eval = load_map(yaml)
        check(gm_eval.device == gm.device
              and torch.equal(gm_eval.occupancy, gm.occupancy)
              and torch.equal(gm_eval.distance, gm.distance),
              "[eval] the map read back from PGM + YAML differs")

        gt = fit_trajectory_to_map(
            gm_eval, SCENARIOS["square"](duration=EVAL_SECONDS, rate=5.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bag = simulate_bag(0, gm_eval, gt, n_beams=N_BEAMS,
                           max_range=cfg.max_range, rate=5.0,
                           range_noise=0.01, name="square")
        sim_s = time.perf_counter() - t0
        n = len(bag.times)
        check(bag.ranges.shape == (n, N_BEAMS) and n == len(gt)
              and np.isfinite(bag.ranges).all()
              and (bag.ranges > 0).all() and (bag.ranges <= cfg.max_range).all(),
              "[eval] simulated scans out of range")
        print(f"[eval] simulate_bag: {n} scans x {N_BEAMS} beams of the "
              f"square scenario fitted to the map in {sim_s:.3f} s on {smi}")

        npz = str(d / "square.npz")
        save_bag(npz, bag)
        back = load_bag(npz)
        for f in ("ranges", "angles", "odom", "gt", "times"):
            check(np.array_equal(getattr(back, f), getattr(bag, f))
                  and getattr(back, f).dtype == getattr(bag, f).dtype,
                  f"[eval] npz bag field {f} not bitwise")
        check(back.max_range == bag.max_range and back.meta == bag.meta,
              "[eval] npz bag metadata")
        for tag, write, read, name in (
                ("rosbag", write_rosbag, read_rosbag, "square.bag"),
                ("rosbag2", write_rosbag2, read_rosbag2, "square.db3")):
            write(str(d / name), bag)
            rb = read(str(d / name))
            ok = (np.allclose(rb.ranges, bag.ranges, rtol=1e-6, atol=0)
                  and np.allclose(rb.angles, bag.angles, rtol=0, atol=2e-4)
                  and np.allclose(rb.odom, bag.odom, rtol=0, atol=1e-6)
                  and np.allclose(rb.times, bag.times, rtol=0, atol=1e-6)
                  and rb.max_range == bag.max_range)
            check(ok, f"[eval] the {tag} round trip is off")
        print("[eval] bag round trips: npz bitwise; ROS1 and ROS2 bag files "
              "within the tests' tolerances (ranges rtol 1e-6, angles 2e-4, "
              "odometry 1e-6)")

        staged = make_staged_model(from_yaml.replace(
            initialized=True, initial_pose=tuple(map(float, bag.gt[0]))),
            gm_eval, tracking_ess_threshold=0.9)
        state = staged.init(0)
        gen_before = state.key.get_state().clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warmup_staged(staged, state, bag.ranges, bag.angles,
                      odometry_deltas(bag.odom))
        warm_s = time.perf_counter() - t0
        check(torch.equal(state.key.get_state(), gen_before),
              "[eval] warmup_staged moved the state's generator")
        sizes = {min(SCAN_LEN, n)} | ({n % SCAN_LEN} if n % SCAN_LEN else set())
        warm_scans = 2 * sum(sizes)
        print(f"[eval] warmup_staged ({warm_scans} throwaway scans: BIG and "
              f"SMALL at chunk lengths {sorted(sizes)}, and a hand-off) "
              f"{warm_s:.2f} s on {smi}; generator state unchanged")
        del staged, state

        reset()
        res, out, ms = run_cli([
            "single", "--staged", "--initialized", "--map", yaml,
            "--params", str(d / "main.yaml"), "--particles", "1000000",
            "--tracking-ess", "0.9", "--bag", npz, "--metrics",
            "--results-dir", str(d / "results"), "--result-name",
            "eval_staged", "--seed", "0"])
        c = counts()
        launches.append(("eval", c, n + warm_scans))
        staged_line = re.search(
            r"staged: (\d+)/(\d+) scans in the tracking program, "
            r"(\d+) switches", out)
        check(staged_line is not None, "[eval] no tracking-program report")
        in_small, total, switches = map(int, staged_line.groups())
        check(total == n and in_small > 0 and switches >= 1,
              f"[eval] staged: {in_small}/{total} scans in SMALL, "
              f"{switches} switches: no hand-off")
        txt = (d / "results" / "eval_staged.txt").read_text()
        check("RMSE final:" in txt, "[eval] the results file has no RMSE")
        _, _, rmse_file = parse_results_file(str(d / "results" / "eval_staged.txt"))
        _, est, _ = parse_poses_file(str(d / "results" / "poses_eval_staged.txt"))
        check(np.isfinite(est).all() and est.shape == (n, 3),
              "[eval] non-finite or missing estimates")
        check(abs(rmse_file - res.rmse) < 1e-4 and res.rmse < 0.2,
              f"[eval] staged RMSE {res.rmse:.4f} m >= 0.2 m")
        recs = read_metrics(str(d / "results" / "eval_staged.jsonl"))
        check(len(recs) == n, f"[eval] {len(recs)} metrics lines for {n} scans")
        # run_if: the programs replayed their captured steps
        for name in ("corr_field_build", "corr_lookup", "expand_sorted",
                     "run_if"):
            check(c.get(name, 0) > 0, f"[eval] staged: {name} never launched")
        print(f"[eval] single --staged (1M / 100k, tracking ESS 0.9) on the "
              f"{n}-scan bag: RMSE {res.rmse:.4f} m, {in_small}/{n} scans in "
              f"SMALL, {switches} switches, {ms:.2f} ms/scan (host clock) on "
              f"{smi}; {len(recs)} metrics lines; launches {c}")

        reset()
        res, out, ms = run_cli([
            "single", "--initialized", "--map", yaml,
            "--params", str(d / "defaults.yaml"), "--bag", npz,
            "--results-dir", str(d / "results"), "--result-name",
            "eval_default", "--seed", "0"])
        c = counts()
        launches.append(("eval_exact", c, n + 1))
        check(np.isfinite(res.est).all() and res.rmse < 0.25,
              f"[eval] FilterConfig() RMSE {res.rmse:.4f} m >= 0.25 m")
        for name in ("likelihood_scores", "gather_2d", "expand_sorted"):
            check(c.get(name, 0) > 0,
                  f"[eval] FilterConfig(): {name} never launched")
        print(f"[eval] single FilterConfig() (1500 particles, 'auto' -> "
              f"exact, 'reject') on the {n}-scan bag: RMSE {res.rmse:.4f} m, "
              f"{ms:.2f} ms/scan (host clock) on {smi}; launches {c}")
    return launches


def start_world_of_one(backend="nccl") -> None:
    """[dist]'s process group: one rank on ``cuda:0``, in this process (a
    ``HashStore``: no port, no other process); NCCL, or with ``backend``
    None what ``init_process_group`` picks when none is named."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def end_world() -> None:
    """Destroy the process group if one is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def collectives_line(counts: dict, scans: int) -> str:
    """Calls and bytes a scan of each collective (``parallel/distributed.
    py::collective_counts`` over ``scans`` scans)."""
    return ", ".join(f"{k} {c / scans:.2f} calls {b / scans:.0f} B"
                     for k, (c, b, _) in sorted(counts.items()))


def drive_dist(gm, cfg, single_cfg, beam_cfg, lidar, scans, angles, deltas,
               smi, timed, final_error, add_counts, to_profile, ref_ms):
    """[dist]: the multi-rank filter over ``torch.distributed`` on an NCCL
    group of one rank (``start_world_of_one``), at full width: (1) the
    [single] flagship through ``make_dist_model``, (2) the [main]
    configuration through ``make_staged_dist_model`` (the hand-off cycle
    big -> shrink -> small -> grow -> big, each kept row bitwise, then
    ``run_staged`` over 16 + 16 scans), (3) [beam]'s field point and (4)
    [lidar3d]'s through ``make_dist_model``, each with ms/scan by CUDA
    events and the collectives a scan beside its single-program run
    (``ref_ms``); (5) ``make_sharded_model`` at (B)'s 100k "jnp" point
    ``torch.equal`` to ``make_model``'s steps; (6) is ``drive_dryrun``.
    Gates: (1)-(4) end under 0.2 m."""
    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.filter.staged import (
        make_staged_dist_model,
        run_staged,
    )
    from mcmh_localization_tpu_torch.filter.state import copy_generator
    from mcmh_localization_tpu_torch.filter.step import make_model, state_size
    from mcmh_localization_tpu_torch.ops import _cuda
    from mcmh_localization_tpu_torch.parallel import distributed
    from mcmh_localization_tpu_torch.parallel.sharding import (
        make_mesh,
        make_sharded_model,
        shard_state,
    )

    vm, nav, lidar_cfg, directions, lscans = lidar
    start_world_of_one()
    mesh = make_mesh()
    print(f"[dist] NCCL process group of {mesh.size()} rank on "
          f"{torch.cuda.get_device_name(0)}; mesh {tuple(mesh.shape)} "
          f"'{mesh.mesh_dim_names[0]}'")
    # the host cost of one collective: 200 psums of a scalar (in place: a
    # sum over one rank leaves it as it is), synchronized once
    one = torch.zeros((), device="cuda")
    distributed.psum(one, mesh.get_group())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        distributed.psum(one, mesh.get_group())
    torch.cuda.synchronize()
    print(f"[dist] host clock a call over 200 calls: psum of a scalar "
          f"{(time.perf_counter() - t0) / 200 * 1e6:.1f} us on {smi}")

    def run(tag, path, model, ref, seq=None, ang=None, need=()):
        """Settle one lap, then time one: (state, ms/scan); the launches
        of both laps counted as ``path``'s, the collectives of the timed
        lap printed."""
        _cuda.reset_launch_counts()
        st, _, ms_settle = timed(model, model.init(0), 1, seq, ang)
        distributed.reset_collective_counts()
        st, infos, ms = timed(model, st, 1, seq, ang)
        coll = distributed.collective_counts()
        err = final_error(infos)
        c = _cuda.launch_counts()
        add_counts(path, c, 2 * SCAN_LEN)
        print(f"[dist] {tag} (n_max={state_size(model.config)}): {ms:.4f} "
              f"ms/scan over {SCAN_LEN} timed scans (settle {ms_settle:.4f}) "
              f"beside {ref:.4f} single-program on {smi}; final error "
              f"{err:.4f} m; collectives a scan: "
              f"{collectives_line(coll, SCAN_LEN)}; launches {c}")
        check(err < 0.2, f"[dist] {tag}: final error {err:.3f} m >= 0.2 m")
        for name in need:
            check(c.get(name, 0) >= 2 * SCAN_LEN,
                  f"[dist] {tag}: {name} not launched every scan")
        return st, ms

    def dist_graph(tag, model, st, seq=None, ang=None):
        """[dist]'s [graph] row: the captured run against the eager steps
        (``graph_check``) from ``st``."""
        _cuda.reset_launch_counts()
        row = graph_check(f"dist {tag}", model, st,
                          scans if seq is None else seq,
                          angles if ang is None else ang, deltas, smi)
        add_counts("graph_dist", _cuda.launch_counts(), 11 * SCAN_LEN)
        dist_rows[tag] = {k: v for k, v in row.items()
                          if k not in ("graph", "final")}

    dist_rows: dict = {}
    # (1) the 1M flagship, windowed corr with the coarse fallback
    model = distributed.make_dist_model(single_cfg, gm, mesh)
    check(model.replays_graph, "[dist] the NCCL group's model does not "
          "replay a captured step")
    st, ms = run("flagship", "dist_single", model, ref_ms["single"],
                 need=("corr_field_build", "window_score_at"))
    to_profile.append(("dist_single", model, st, ms))
    dist_graph("flagship (A)", model, st)
    del model, st

    # (2) the staged main path: the hand-off cycle, then run_staged
    staged = make_staged_dist_model(cfg, gm, mesh)
    cap_l, big_l = staged.small.nl, staged.big.nl
    big, _ = staged.big.step(staged.init(0), scans[0], angles, deltas[0])
    small = staged.shrink(big)
    check(small.particles.shape[0] == cap_l
          and torch.equal(small.particles, big.particles[:cap_l])
          and torch.equal(small.weights, big.weights[:cap_l]),
          "[dist] shrink did not keep the rank's first cap rows bitwise")
    small, _ = staged.small.step(small, scans[1], angles, deltas[1])
    back = staged.grow(small)
    check(back.particles.shape[0] == big_l
          and torch.equal(back.particles[:cap_l], small.particles)
          and not back.particles[cap_l:].any() and not back.weights[cap_l:].any(),
          "[dist] grow did not keep the rows and zero the tail")
    _, info = staged.big.step(back, scans[2], angles, deltas[2])
    check(bool(torch.isfinite(info.estimate.mean).all()),
          "[dist] the hand-off cycle's estimate is not finite")
    print(f"[dist] staged hand-off cycle: big ({big_l} rows, count "
          f"{int(big.count)}) -> shrink ({cap_l}) -> small -> grow -> big; "
          "the kept rows bitwise, the grown tail zero")
    _cuda.reset_launch_counts()
    out, run_ms = once_ms(lambda: run_staged(
        staged, staged.init(0), scans.repeat(2, 1), angles,
        deltas.repeat(2, 1), chunk=SCAN_LEN))
    err = final_error(out.infos)
    add_counts("dist_staged", _cuda.launch_counts(), 2 * SCAN_LEN)
    print(f"[dist] staged run_staged: {2 * SCAN_LEN} scans in "
          f"{run_ms / 1e3:.2f} s, modes={out.modes.tolist()} switches="
          f"{out.switches}; final error {err:.4f} m")
    check(err < 0.2, f"[dist] staged: final error {err:.3f} m >= 0.2 m")
    small = out.state if out.modes[-1] == 1 else staged.shrink(out.state)
    for tag, prog, st0, ref in (
            ("staged SMALL", staged.small, small, ref_ms["small"]),
            ("staged BIG", staged.big, staged.grow(small), ref_ms["big"])):
        _cuda.reset_launch_counts()
        distributed.reset_collective_counts()
        st, infos, ms = timed(prog, st0, 1)
        final_error(infos)
        c = _cuda.launch_counts()
        add_counts("dist_staged", c, SCAN_LEN)
        print(f"[dist] {tag} (n_max={state_size(prog.config)}): {ms:.4f} "
              f"ms/scan over {SCAN_LEN} scans beside {ref:.4f} single-program "
              f"on {smi}; collectives a scan: "
              f"{collectives_line(distributed.collective_counts(), SCAN_LEN)}; "
              f"launches {c}")
        to_profile.append((f"dist_{tag.split()[1].lower()}", prog, st, ms))
        dist_graph(tag, prog, st0)
    del staged, out, small, big, back

    # (3) the beam point and (4) the 3-D lidar
    model = distributed.make_dist_model(beam_cfg, gm, mesh)
    st, ms = run("beam field", "dist_beam", model, ref_ms["beam"],
                 need=("lut_field_at", "lut_field", "bin_lut",
                       "window_score_at"))
    to_profile.append(("dist_beam", model, st, ms))
    dist_graph("beam field (C)", model, st)
    model = distributed.make_dist_model(lidar_cfg, nav, mesh, voxel_map=vm)
    st, ms = run("lidar3d", "dist_lidar3d", model, ref_ms["lidar3d"], lscans,
                 directions, need=("voxel_scores",))
    to_profile.append(("dist_lidar3d", model, st, ms, lscans, directions))
    dist_graph("lidar3d (E)", model, st, lscans, directions)
    print(f"[dist] graph rows: {json.dumps(dist_rows)}")
    del model, st

    # (5) the GSPMD twin at (B)'s 100k point: make_model's steps bitwise
    cfg_b = FilterConfig(mode="AMHAMCL", initialized=True, initial_pose=START,
                         likelihood_impl="jnp", num_particles=100_000,
                         min_particles=100_000, max_particles=100_000)
    single = make_model(cfg_b, gm)
    sharded = make_sharded_model(cfg_b, gm, mesh)
    s1 = single.init(0)
    s2 = shard_state(s1.replace(key=copy_generator(s1.key)), mesh)
    _cuda.reset_launch_counts()
    for t in range(4):
        s1, i1 = single.step(s1, scans[t], angles, deltas[t])
        s2, i2 = sharded.step(s2, scans[t], angles, deltas[t])
        check(torch.equal(s1.particles, s2.particles)
              and torch.equal(s1.weights, s2.weights)
              and torch.equal(i1.estimate.mean, i2.estimate.mean),
              f"[dist] make_sharded_model step {t} != make_model's")
    add_counts("dist_sharded", _cuda.launch_counts(), 8)
    print(f"[dist] make_sharded_model (n={cfg_b.num_particles}, 'jnp'): 4 "
          "steps torch.equal to make_model's (particles, weights, estimate)")
    del single, sharded, s1, s2


def drive_dryrun() -> None:
    """[dist] (6): ``graft_entry.dryrun_multichip(1)``'s five parts on a
    group started with no backend named (a backend a device type, which
    torch names "cpu:gloo,cuda:nccl" or "undefined"), whose mesh
    and rank device must be the card's.  It ends (1)-(5)'s NCCL group, so
    it runs after the profiles of their models, which hold that group."""
    import torch.distributed as dist

    from mcmh_localization_tpu_torch import graft_entry
    from mcmh_localization_tpu_torch.parallel.sharding import (
        make_mesh,
        rank_device,
    )

    end_world()
    start_world_of_one(backend=None)
    backend = dist.get_backend()
    check(make_mesh().device_type == "cuda"
          and rank_device() == torch.device("cuda", 0),
          f"[dist] a {backend!r} group gave a mesh or device off the card")
    print(f"[dist] a group with no backend named ({backend!r}): mesh and "
          "rank device on cuda:0")
    graft_entry.dryrun_multichip(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler table + trace here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke run needs one GPU", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mcmh_localization_tpu_torch.config import MODES, FilterConfig
    from mcmh_localization_tpu_torch.filter.staged import (
        grow_state,
        make_staged_model,
        run_staged,
        warmup_staged,
    )
    from mcmh_localization_tpu_torch.filter.step import (
        _resolved_likelihood_impl,
        make_model,
        state_size,
    )
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map
    from mcmh_localization_tpu_torch.models.sensor import raycast
    from mcmh_localization_tpu_torch.ops import _cuda
    from mcmh_localization_tpu_torch.ops.scan_scores import table_kernels

    check("jax" not in sys.modules, "the port must not import jax")

    stamps = [("setup", time.perf_counter())]  # the phases' starts: the build, map, scans
    # -- 2. build
    t0 = time.perf_counter()
    _cuda.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_cuda.build_seconds:.2f} s) -> {_cuda.library_path().name}")
    for line in _cuda.build_log.splitlines():  # ptxas -v: registers, smem
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    half = MAP_CELLS * RES / 2
    gm = build_grid_map(house_occupancy(), RES, (-half, -half), device=dev)
    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=1_000_000, min_particles=100_000,
        max_particles=1_000_000, initialized=True, initial_pose=START,
        kld_eval_window=0, coarse_gate_escapees=0,
        corr_window_cells=128, corr_theta_window_bins=32,
        likelihood_impl="corr", motion_validity="score",
        min_injection_prob=0.02,
    )
    rot = math.pi / SCAN_LEN
    delta = (rot, 0.05, rot)
    poses = circle_poses(delta)
    angles = torch.linspace(-math.pi, math.pi, N_BEAMS, device=dev)
    scans = torch.stack([
        raycast(torch.tensor(p[:2], device=dev), float(p[2]) + angles, gm,
                cfg.max_range, hit_unknown=True) for p in poses])
    deltas = torch.tensor([delta] * SCAN_LEN, dtype=torch.float32, device=dev)

    staged = make_staged_model(cfg, gm, tracking_ess_threshold=0.9)

    # the 3-D lidar's building (the EDT on the host), its navigation slice
    # and a scan of each circle pose from the port's simulator
    t0 = time.perf_counter()
    vm, nav, lidar_cfg, lidar, directions, lscans = lidar_scene(dev, poses)
    torch.cuda.synchronize()
    print(f"[lidar3d] building {tuple(vm.occupancy.shape)} voxels at {RES} m "
          f"({vm.occupancy.numel() / 1e6:.1f}M), its EDT, log-mixture volume "
          f"and {SCAN_LEN} scans of {directions.shape[0]} beams in "
          f"{time.perf_counter() - t0:.2f} s")

    stamps.append(("kernel", time.perf_counter()))
    # -- 3. kernels vs plain versions
    rows: list[dict] = []
    single_cfg = cfg.replace(min_particles=1_000_000)
    field_small, window, u, v, valid, wts = compare_kernels(
        gm, staged.config, staged.small_config, staged.big.log_field,
        scans[0], angles, rows)
    compare_slice2_kernels(gm, single_cfg, staged.big.log_field, scans[0],
                           angles, field_small, window, u, v, valid, wts, rows)
    del field_small, wts
    beam_cfg = beam_point_config()
    t0 = time.perf_counter()
    beam = make_model(beam_cfg, gm)
    torch.cuda.synchronize()
    print(f"[beam] range table (96, {MAP_CELLS}, {MAP_CELLS}) and its int8 "
          f"forms built in {time.perf_counter() - t0:.2f} s")
    compare_beam_kernel(gm, beam, scans[0], angles, rows)
    compare_lidar_kernel(vm, nav, lidar_cfg, lidar.log_field, lscans[0],
                         directions, rows)
    stamps.append(("kernel_past_caps", time.perf_counter()))
    # FilterConfig(sensor_model="beam", corr_window_cells=128) at its
    # defaults: 360 table bins, which kernel 7 sums in chunks
    bd_cfg = FilterConfig(sensor_model="beam", corr_window_cells=128,
                          initialized=True, initial_pose=START)
    t0 = time.perf_counter()
    beam_default = make_model(bd_cfg, gm)
    torch.cuda.synchronize()
    print(f"[beam_default] range table ({bd_cfg.beam_table_n_theta}, "
          f"{MAP_CELLS}, {MAP_CELLS}) and its int8 forms built in "
          f"{time.perf_counter() - t0:.2f} s on {smi}")
    compare_past_caps(gm, beam_default, beam, vm, lidar_cfg, lidar, rows)
    path_counts: dict[str, dict[str, int]] = {}
    path_scans: dict[str, int] = {}

    def add_counts(path: str, counts: dict, scans: int) -> None:
        """The launches a path's phase made over its ``scans`` scans."""
        path_scans[path] = path_scans.get(path, 0) + scans
        tot = path_counts.setdefault(path, {})
        for k, n in counts.items():
            tot[k] = tot.get(k, 0) + n

    def timed(model, st, reps, seq=None, ang=None, dls=None):
        """``reps`` laps of the circle (the house scans, or ``seq``, ``ang``
        and ``dls``) through ``model.run``: (state, infos, ms/scan by CUDA
        events)."""
        return events_run(model, st,
                          (scans if seq is None else seq).repeat(reps, 1),
                          angles if ang is None else ang,
                          (deltas if dls is None else dls).repeat(reps, 1))

    def final_error(infos) -> float:
        e = infos.estimate.mean.cpu().numpy()
        check(np.isfinite(e).all(), "non-finite estimate")
        return float(np.hypot(e[-1, 0] - poses[-1, 0], e[-1, 1] - poses[-1, 1]))

    to_profile = []
    ref_ms = {}  # single-program ms/scan that [dist]'s runs print beside

    stamps.append(("main", time.perf_counter()))
    # -- 4. the staged main path: both programs replay their captured steps
    # (filter/captured.py), captured by warmup_staged
    check(staged.big.replays_graph and staged.small.replays_graph,
          "[main] a staged program does not replay a captured step")
    state = staged.init(0)
    t0 = time.perf_counter()
    warmup_staged(staged, state, scans.repeat(4, 1), angles,
                  deltas.repeat(4, 1), chunk=SCAN_LEN)
    print(f"[main] warmup_staged (captures BIG's and SMALL's steps) "
          f"{time.perf_counter() - t0:.2f} s")
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_staged(staged, state, scans.repeat(4, 1), angles,
                     deltas.repeat(4, 1), chunk=SCAN_LEN)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    est = out.infos.estimate.mean.cpu().numpy()
    counts = out.infos.count.cpu().numpy()
    truth = np.tile(poses, (4, 1))
    errs = np.hypot(est[:, 0] - truth[:, 0], est[:, 1] - truth[:, 1])
    print(f"[main] staged settle: {len(est)} scans in {settle_s:.2f} s, "
          f"modes={out.modes.tolist()} switches={out.switches}")
    print(f"[main] counts first/last chunk: {counts[:SCAN_LEN].tolist()} / "
          f"{counts[-SCAN_LEN:].tolist()}")
    print(f"[main] error (m) last 8: {np.round(errs[-8:], 4).tolist()}")
    check(out.modes[-1] == 1, "the staged run did not settle into SMALL")
    check(np.isfinite(est).all(), "non-finite estimate")
    check(errs[-1] < 0.2, f"final error {errs[-1]:.3f} m >= 0.2 m")

    small_state, s_infos, ms_small = timed(staged.small, out.state, 3)
    s_err = final_error(s_infos)
    print(f"[main] SMALL (n_max={state_size(staged.small_config)}) tracking: "
          f"{ms_small:.4f} ms/scan over {3 * SCAN_LEN} scans on {smi}; "
          f"final error {s_err:.4f} m; counts {s_infos.count.min().item()}.."
          f"{s_infos.count.max().item()}")
    check(s_err < 0.2, f"SMALL final error {s_err:.3f} m >= 0.2 m")
    big_state = grow_state(small_state, state_size(staged.config))
    _, b_infos, ms_big = timed(staged.big, big_state, 1)
    print(f"[main] BIG (n_max={state_size(staged.config)}) program: "
          f"{ms_big:.4f} ms/scan over {SCAN_LEN} scans on {smi}")
    final_error(b_infos)
    # 64 settle scans, 48 SMALL and 16 BIG
    add_counts("main", _cuda.launch_counts(), 8 * SCAN_LEN)
    print(f"[main] kernel launches in the main path: {path_counts['main']}")
    for name in ("corr_field_build", "corr_lookup", "expand_sorted", "run_if"):
        check(path_counts["main"].get(name, 0) > 0, f"[main] {name} never launched")
    to_profile += [("small", staged.small, small_state, ms_small),
                   ("big", staged.big, big_state, ms_big)]
    ref_ms.update(small=ms_small, big=ms_big)

    stamps.append(("graph", time.perf_counter()))
    # -- 4a. the captured steps against the eager ones: SMALL from the
    # settled state, BIG from the start with the augmented-MCL averages
    # apart (it injects, and the diffuse cloud escalates the KLD draw)
    _cuda.reset_launch_counts()
    big_start = staged.init(0)
    big_start = big_start.replace(
        w_slow=torch.full((), 1.0, device=dev),
        w_fast=torch.full((), 0.5, device=dev))
    drive_graph(staged, big_start, out.state, scans, angles, deltas, smi)
    rows.append(run_if_row(dev))
    add_counts("graph", _cuda.launch_counts(), 2 * 11 * SCAN_LEN)
    rows.append(trace_stamp_row(dev))   # on no path: tracing is off
    del staged, out, big_state, big_start

    stamps.append(("online", time.perf_counter()))
    # -- 4b. the online facade on the main path's configuration
    _cuda.reset_launch_counts()
    online = drive_online(cfg, gm, scans, angles, poses, smi)
    add_counts("online", _cuda.launch_counts(), online)
    print(f"[online] kernel launches: {path_counts['online']}")
    for name in ("corr_field_build", "corr_lookup", "expand_sorted", "run_if"):
        check(path_counts["online"].get(name, 0) > 0,
              f"[online] {name} never launched")

    stamps.append(("single", time.perf_counter()))
    # -- 5. the single-program flagship: make_model at 1M, ungated coarse
    # fallback, then its KLD twin and the 100k point with the gate of 8;
    # each replays its captured step (filter/captured.py)
    graph_rows: dict = {}
    single = make_model(single_cfg, gm)
    zero_scan_check(single, single.init(0), N_BEAMS, (N_BEAMS,))
    _cuda.reset_launch_counts()
    check(single.replays_graph, "[single] the flagship does not replay a "
          "captured step")
    st, _, ms_settle = timed(single, single.init(0), 1)
    c_settle = _cuda.launch_counts()
    st, g_infos, ms_single = timed(single, st, 1)
    err_single = final_error(g_infos)
    c_single = _cuda.launch_counts()
    n_scans = 2 * SCAN_LEN
    builds = c_single.get("corr_field_build", 0)
    print(f"[single] flagship (n={state_size(single_cfg)}, window 128, 32 of "
          f"{single_cfg.corr_n_theta} bins, coarse x{single_cfg.corr_coarse_factor} "
          f"at {single_cfg.corr_coarse_n_theta} bins, ungated), captured: "
          f"{ms_single:.4f} ms/scan over {SCAN_LEN} timed scans "
          f"(settle {ms_settle:.4f}) on {smi}; final error {err_single:.4f} m; "
          f"launches {c_single}")
    check(err_single < 0.2, f"[single] final error {err_single:.3f} m >= 0.2 m")
    # the window score reads its window from device memory every scan
    check(c_single.get("window_score_at", 0) >= n_scans,
          "[single] window_score_at not launched every scan")
    # one fine and one coarse field build per scan
    check(builds >= 2 * n_scans and c_settle.get("corr_field_build", 0) >= 2 * SCAN_LEN,
          f"[single] {builds} field builds in {n_scans} scans: the coarse "
          "build did not run every scan")
    to_profile.append(("single", single, st, ms_single))
    ref_ms["single"] = ms_single
    single_st = st
    gated = None
    for tag, cfg_x in (
            ("kld_adaptive", single_cfg.replace(min_particles=100_000)),
            ("100k_gated", single_cfg.replace(
                num_particles=100_000, min_particles=100_000,
                max_particles=100_000, coarse_gate_escapees=8))):
        model = make_model(cfg_x, gm)
        st, _, _ = timed(model, model.init(0), 1)
        st, x_infos, ms_x = timed(model, st, 1)
        err_x = final_error(x_infos)
        print(f"[single] {tag} (n_max={state_size(cfg_x)}, min "
              f"{cfg_x.min_particles}, gate {cfg_x.coarse_gate_escapees}), "
              f"captured: {ms_x:.4f} ms/scan on {smi}; final error "
              f"{err_x:.4f} m; counts {x_infos.count.min().item()}.."
              f"{x_infos.count.max().item()}")
        check(err_x < 0.2, f"[single] {tag} final error {err_x:.3f} m >= 0.2 m")
        if tag == "100k_gated":
            gated = (model, st)
        del model, st
    add_counts("single", _cuda.launch_counts(), 3 * n_scans)
    print(f"[single] kernel launches: {path_counts['single']}")
    check(path_counts["single"].get("window_escapees_at", 0) > 0,
          "[single] the gated run never counted escapees")

    stamps.append(("graph_single", time.perf_counter()))
    # -- 5a. [graph] rows of the single-program configs: the flagship at 1M
    # from its settled state; the 100k gated point from its settled state
    # with 1% of the cloud spread over the map (the gate builds, then skips
    # once the spread poses are resampled away); entry 1's "lvr" resampler
    # and non-adaptive systematic draw
    from mcmh_localization_tpu_torch.filter.init import init_uniform

    _cuda.reset_launch_counts()
    graph_row(graph_rows, "flagship", single, single_st, scans, angles,
              deltas, smi)
    add_counts("graph_flagship", _cuda.launch_counts(), 11 * SCAN_LEN)
    del single, single_st
    model, st = gated
    spread = init_uniform(st.n_max // 100, gm,
                          generator=torch.Generator(device=dev).manual_seed(3))
    k = spread.shape[0]
    st = st.replace(
        particles=torch.cat([spread, st.particles[k:]]),
        prev_particles=torch.cat([spread, st.prev_particles[k:]]))
    _cuda.reset_launch_counts()
    row = graph_row(graph_rows, "100k_gated", model, st, scans, angles,
                    deltas, smi)
    add_counts("graph_100k_gated", _cuda.launch_counts(), 11 * SCAN_LEN)
    ran = row["bodies"].get("coarse_build", 0)
    print(f"[graph] 100k_gated: the coarse build (a conditional node) ran on "
          f"{ran} of {SCAN_LEN} scans and was skipped on {SCAN_LEN - ran}, "
          f"from a cloud with {k} poses spread over the map")
    check(0 < ran < SCAN_LEN, f"[graph] 100k_gated: the gate took one branch "
          f"only (the build ran on {ran} of {SCAN_LEN} scans)")
    del gated, model, st, row
    for tag, cfg_x in (
            ("lvr", single_cfg.replace(
                num_particles=100_000, min_particles=20_000,
                max_particles=100_000, adaptive_resampler="lvr")),
            ("systematic", single_cfg.replace(
                mode="MHMCL", num_particles=100_000,
                max_particles=100_000))):
        model = make_model(cfg_x, gm)
        _cuda.reset_launch_counts()
        graph_row(graph_rows, tag, model, model.init(0), scans, angles,
                  deltas, smi)
        add_counts(f"graph_{tag}", _cuda.launch_counts(), 11 * SCAN_LEN)
        del model

    stamps.append(("exact", time.perf_counter()))
    # -- 6. the exact scorer: FilterConfig() in all six modes, then corr vs
    # exact at 1500 and 100k
    for mode in MODES:
        _cuda.reset_launch_counts()
        cfg_b = FilterConfig(mode=mode, initialized=True, initial_pose=START,
                             likelihood_impl="pallas")
        model = make_model(cfg_b, gm)
        st, b1, _ = timed(model, model.init(0), 1)
        st, b2, ms_b = timed(model, st, 1)
        e = np.concatenate([b1.estimate.mean.cpu().numpy(),
                            b2.estimate.mean.cpu().numpy()])
        tr = np.tile(poses, (2, 1))
        err8 = float(np.mean(np.hypot(e[-8:, 0] - tr[-8:, 0],
                                      e[-8:, 1] - tr[-8:, 1])))
        c = _cuda.launch_counts()
        add_counts("exact", c, 2 * SCAN_LEN)
        print(f"[exact] {mode}: {ms_b:.4f} ms/scan (n={cfg_b.num_particles}, "
              f"max {cfg_b.max_particles}, 'reject') on {smi}; mean error "
              f"last 8 {err8:.4f} m; count {int(st.count)}; launches {c}")
        check(np.isfinite(e).all(), f"[exact] {mode}: non-finite estimate")
        check(err8 < 0.25, f"[exact] {mode}: error {err8:.3f} m >= 0.25 m")
        check(c.get("likelihood_scores", 0) > 0 and c.get("gather_2d", 0) > 0,
              f"[exact] {mode}: the exact scorer or gather_2d never launched")
    cross = {}
    for n in (1500, 100_000):
        for impl in ("corr", "jnp"):
            _cuda.reset_launch_counts()
            kw = dict(num_particles=n, min_particles=n, max_particles=n)
            cfg_x = (cfg.replace(coarse_gate_escapees=8, **kw) if impl == "corr"
                     else FilterConfig(mode="AMHAMCL", initialized=True,
                                       initial_pose=START,
                                       likelihood_impl=impl, **kw))
            model = make_model(cfg_x, gm)
            st, _, _ = timed(model, model.init(0), 1)
            st, x_infos, ms_x = timed(model, st, 1)
            err_x = final_error(x_infos)
            add_counts("exact" if impl == "jnp" else "single",
                       _cuda.launch_counts(), 2 * SCAN_LEN)
            cross[(n, impl)] = ms_x
            print(f"[exact] AMHAMCL n={n} {impl}: {ms_x:.4f} ms/scan on {smi}; "
                  f"final error {err_x:.4f} m")
            check(err_x < 0.25, f"[exact] n={n} {impl}: error {err_x:.3f} m")
            if impl == "jnp" and n == 100_000:
                to_profile.append(("exact100k", model, st, ms_x))
            del model, st
    for n in (1500, 100_000):
        faster = "corr" if cross[(n, "corr")] < cross[(n, "jnp")] else "exact"
        print(f"[exact] auto crossover at n={n}: corr {cross[(n, 'corr')]:.4f} "
              f"vs exact {cross[(n, 'jnp')]:.4f} ms/scan -> {faster} is "
              f"faster on {smi} (auto picks "
              f"{'corr' if n >= 8192 else 'exact'})")
    print(f"[exact] kernel launches: {path_counts['exact']}")
    # [graph] rows of the exact scorer: FilterConfig() as shipped ("auto"
    # -> "jnp" at 5000 slots, "reject" with its retries) and (B)'s
    # "pallas" at 100k
    for tag, cfg_x in (
            ("FilterConfig()", FilterConfig(initialized=True,
                                            initial_pose=START)),
            ("pallas_100k", FilterConfig(
                mode="AMHAMCL", initialized=True, initial_pose=START,
                likelihood_impl="pallas", num_particles=100_000,
                min_particles=100_000, max_particles=100_000))):
        model = make_model(cfg_x, gm)
        _cuda.reset_launch_counts()
        graph_row(graph_rows, tag, model, model.init(0), scans, angles,
                  deltas, smi)
        add_counts(f"graph_{tag}", _cuda.launch_counts(), 11 * SCAN_LEN)
        del model

    stamps.append(("beam", time.perf_counter()))
    # -- 7. the beam model: the score field at 100k and its ESS-gated twin,
    # then the range-table scorer at 1500; each replays its captured step
    # (filter/captured.py), and each has a [graph] row: captured against
    # its eager steps from its settled state
    for tag, model in (("field", beam),
                       ("field_essgate", make_model(
                           beam_cfg.replace(resample_ess_threshold=0.9), gm))):
        _cuda.reset_launch_counts()
        check(model.replays_graph, f"[beam] {tag} does not replay a captured "
              "step")
        st, _, ms_settle = timed(model, model.init(0), 1)
        st, x_infos, ms_x = timed(model, st, 1)
        err_x = final_error(x_infos)
        c = _cuda.launch_counts()
        add_counts("beam", c, 2 * SCAN_LEN)
        print(f"[beam] {tag} (n={state_size(model.config)}, 96 table bins, "
              f"window 64, 24 theta bins, coarse x4 at 24 bins, gate 8, "
              f"ESS {model.config.resample_ess_threshold}), captured: "
              f"{ms_x:.4f} ms/scan over {SCAN_LEN} timed scans (settle "
              f"{ms_settle:.4f}) on {smi}; final error {err_x:.4f} m; "
              f"launches {c}")
        check(err_x < 0.2, f"[beam] {tag}: final error {err_x:.3f} m >= 0.2 m")
        for name in ("lut_field_at", "window_score_at", "bin_lut"):
            check(c.get(name, 0) >= 2 * SCAN_LEN,
                  f"[beam] {tag}: {name} not launched every scan")
        if tag == "field":
            to_profile.append(("beam", model, st, ms_x))
            ref_ms["beam"] = ms_x
            # (C) gated at 8 from its settled state with 1% of the cloud
            # spread over the map: the coarse build (a conditional node)
            # runs while the spread poses live and is skipped after
            spread = init_uniform(
                st.n_max // 100, gm,
                generator=torch.Generator(device=dev).manual_seed(5))
            k = spread.shape[0]
            st_g = st.replace(
                particles=torch.cat([spread, st.particles[k:]]),
                prev_particles=torch.cat([spread, st.prev_particles[k:]]))
            _cuda.reset_launch_counts()
            row = graph_row(graph_rows, "beam field (C)", model, st_g, scans,
                            angles, deltas, smi)
            add_counts("graph_beam", _cuda.launch_counts(), 11 * SCAN_LEN)
            ran = row["bodies"].get("coarse_build", 0)
            print(f"[graph] beam field (C): the coarse build (a conditional "
                  f"node) ran on {ran} of {SCAN_LEN} scans and was skipped on "
                  f"{SCAN_LEN - ran}, from a cloud with {k} poses spread over "
                  "the map")
            check(0 < ran < SCAN_LEN, f"[graph] beam field (C): the gate took "
                  f"one branch only (the build ran on {ran} of {SCAN_LEN} "
                  "scans)")
            del row, st_g, spread
        else:
            _cuda.reset_launch_counts()
            graph_row(graph_rows, "beam field ESS (C)", model, st, scans,
                      angles, deltas, smi)
            add_counts("graph_beam", _cuda.launch_counts(), 11 * SCAN_LEN)
        del model, st
    del beam
    for tag, impl in (("table", "table"), ("dense", "dense")):
        _cuda.reset_launch_counts()
        tcfg = beam_cfg.replace(beam_impl=impl, num_particles=1500,
                                min_particles=1500, max_particles=1500)
        model = make_model(tcfg, gm)
        st, _, _ = timed(model, model.init(0), 1)
        st, x_infos, ms_x = timed(model, st, 1)
        err_x = final_error(x_infos)
        c = _cuda.launch_counts()
        add_counts("beam", c, 2 * SCAN_LEN)
        print(f"[beam] {tag} (n=1500, 96 table bins), captured: {ms_x:.4f} "
              f"ms/scan on {smi}; final error {err_x:.4f} m; launches {c}")
        check(err_x < 0.25, f"[beam] {tag}: final error {err_x:.3f} m >= 0.25 m")
        if impl == "table":
            # each call launches table_kernels (2 in the level form) kernels
            check(c.get("table_scores", 0)
                  >= 2 * SCAN_LEN * table_kernels(model.log_field),
                  "[beam] table: table_scores not launched every scan")
        _cuda.reset_launch_counts()
        graph_row(graph_rows, f"beam {tag} 1500", model, st, scans, angles,
                  deltas, smi)
        add_counts("graph_beam", _cuda.launch_counts(), 11 * SCAN_LEN)
        del model, st
    print(f"[beam] kernel launches: {path_counts['beam']}")

    stamps.append(("beam_default", time.perf_counter()))
    # -- 7a. the beam model at its defaults (360 table bins, kernel 7 in
    # chunks) and the exact scorer on a 2160-beam scan: sizes the card
    # refused before
    _cuda.reset_launch_counts()
    st, _, ms_settle = timed(beam_default, beam_default.init(0), 1,
                             seq=scans[:8], dls=deltas[:8])
    st, x_infos, ms_x = timed(beam_default, st, 1, seq=scans[8:],
                              dls=deltas[8:])
    err_x = final_error(x_infos)
    c = _cuda.launch_counts()
    add_counts("beam_default", c, SCAN_LEN)
    print(f"[beam_default] FilterConfig(sensor_model='beam', "
          f"corr_window_cells=128) at its defaults (n={bd_cfg.num_particles}, "
          f"max {bd_cfg.max_particles}, {bd_cfg.beam_table_n_theta} table "
          f"bins, coarse x{bd_cfg.corr_coarse_factor} at "
          f"{bd_cfg.corr_coarse_n_theta} bins, gate "
          f"{bd_cfg.coarse_gate_escapees}): {ms_x:.4f} ms/scan over 8 timed "
          f"scans (settle {ms_settle:.4f}) on {smi}; final error "
          f"{err_x:.4f} m; launches {c}")
    check(err_x < 0.25, f"[beam_default] final error {err_x:.3f} m >= 0.25 m")
    for name in ("lut_field_at", "bin_lut"):
        check(c.get(name, 0) >= SCAN_LEN,
              f"[beam_default] {name} not launched every scan")
    to_profile.append(("beam_default", beam_default, st, ms_x))
    # [graph] row of (F) from its settled state
    _cuda.reset_launch_counts()
    graph_row(graph_rows, "beam_default (F)", beam_default, st, scans, angles,
              deltas, smi)
    add_counts("graph_beam_default", _cuda.launch_counts(), 11 * SCAN_LEN)
    del beam_default, st

    _cuda.reset_launch_counts()
    ex_cfg = FilterConfig(initialized=True, initial_pose=START)
    scans2160, angles2160 = zip(*(scan_at(gm, p, 2160, ex_cfg.max_range)
                                  for p in poses))
    scans2160, angles2160 = torch.stack(scans2160), angles2160[0]
    model = make_model(ex_cfg, gm)
    st, _, _ = timed(model, model.init(0), 1, seq=scans2160[:8],
                     ang=angles2160, dls=deltas[:8])
    st, x_infos, ms_x = timed(model, st, 1, seq=scans2160[8:],
                              ang=angles2160, dls=deltas[8:])
    e = x_infos.estimate.mean.cpu().numpy()
    check(np.isfinite(e).all(), "[exact_2160] non-finite estimate")
    err8 = float(np.mean(np.hypot(e[:, 0] - poses[8:, 0],
                                  e[:, 1] - poses[8:, 1])))
    c = _cuda.launch_counts()
    add_counts("exact_2160", c, SCAN_LEN)
    print(f"[exact_2160] FilterConfig() (n={ex_cfg.num_particles}, max "
          f"{ex_cfg.max_particles}, 'auto' -> "
          f"{_resolved_likelihood_impl(ex_cfg, dev)}) on 2160-beam scans: "
          f"{ms_x:.4f} ms/scan over 8 timed scans on {smi}; mean error last "
          f"8 {err8:.4f} m; launches {c}")
    check(err8 < 0.25, f"[exact_2160] error {err8:.3f} m >= 0.25 m")
    check(c.get("likelihood_scores", 0) >= SCAN_LEN,
          "[exact_2160] likelihood_scores not launched every scan")
    to_profile.append(("exact_2160", model, st, ms_x, scans2160, angles2160))
    del model, st, scans2160

    stamps.append(("beam_staged", time.perf_counter()))
    # -- 7b. the staged beam model at the main path's capacity: BIG is the
    # range-table scorer (kernel 2's fused form (a)) at 1M with "sum" and
    # the injection refill, SMALL the windowed field without the coarse
    # fallback
    _cuda.reset_launch_counts()
    bs_cfg = beam_cfg.replace(num_particles=1_000_000, min_particles=100_000,
                              max_particles=1_000_000)
    staged_b = make_staged_model(bs_cfg, gm, tracking_ess_threshold=0.9)
    check(staged_b.config.beam_impl == "table"
          and staged_b.config.score_aggregation == "sum"
          and staged_b.config.injection_refill,
          "[beam_staged] BIG is not the table scorer with sum and refill")
    t0 = time.perf_counter()
    out = run_staged(staged_b, staged_b.init(0), scans.repeat(4, 1), angles,
                     deltas.repeat(4, 1), chunk=SCAN_LEN)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    est = out.infos.estimate.mean.cpu().numpy()
    errs = np.hypot(est[:, 0] - truth[:, 0], est[:, 1] - truth[:, 1])
    n_big = int((out.modes == 0).sum())
    c_run = _cuda.launch_counts()
    print(f"[beam_staged] settle: {len(est)} scans in {settle_s:.2f} s, "
          f"modes={out.modes.tolist()} switches={out.switches}; counts "
          f"first/last chunk {out.infos.count[:SCAN_LEN].tolist()} / "
          f"{out.infos.count[-SCAN_LEN:].tolist()}; error (m) last 8 "
          f"{np.round(errs[-8:], 4).tolist()}; launches {c_run}")
    check((out.modes[:SCAN_LEN] == 0).all(),
          "[beam_staged] the run did not start with a 16-scan chunk in BIG")
    check(out.switches >= 1 and out.modes[-1] == 1,
          "[beam_staged] no hand-off to SMALL")
    check(np.isfinite(est).all(), "[beam_staged] non-finite estimate")
    check(errs[-1] < 0.2, f"[beam_staged] final error {errs[-1]:.3f} m >= 0.2 m")
    per_scan = table_kernels(staged_b.big.log_field)
    check(c_run.get("table_scores", 0) >= n_big * per_scan,
          f"[beam_staged] table_scores launched {c_run.get('table_scores', 0)} "
          f"kernels in {n_big} BIG scans ({per_scan} a call)")
    small_state, s_infos, ms_bsmall = timed(staged_b.small, out.state, 1)
    s_err = final_error(s_infos)
    check(s_err < 0.2, f"[beam_staged] SMALL final error {s_err:.3f} m")
    big_state = grow_state(small_state, state_size(staged_b.config))
    # the BIG program replays its step captured at its first chunk: the
    # memory a captured scan holds is the live tensors' peak, and what the
    # process keeps reserved over it (the graphs' private pools among it)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c0 = _cuda.launch_counts().get("table_scores", 0)
    _, b_infos, ms_bbig = timed(staged_b.big, big_state, 1)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    pool = graph_pool_bytes(staged_b.big.captured(big_state, N_BEAMS).graph)
    final_error(b_infos)
    check(_cuda.launch_counts().get("table_scores", 0) - c0
          >= SCAN_LEN * per_scan,
          "[beam_staged] table_scores not launched every BIG scan")
    # one (2N, M) f32 tensor at 2 x 1M poses and 360 beams: 2.88 GB
    whole = 2 * state_size(staged_b.config) * N_BEAMS * 4
    print(f"[beam_staged] SMALL (n_max={state_size(staged_b.small_config)}, "
          f"window 64, 24 theta bins, no coarse fallback): {ms_bsmall:.4f} "
          f"ms/scan; BIG (n_max={state_size(staged_b.config)}, range table, "
          f"sum, refill): {ms_bbig:.4f} ms/scan, over {SCAN_LEN} scans each "
          f"on {smi}; peak device memory over the BIG scans "
          f"{peak / 1e9:.4f} GB ({(peak - mem0) / 1e9:.4f} GB above the "
          f"{mem0 / 1e9:.4f} GB held before them), {reserved / 1e9:.4f} GB "
          f"reserved by the process, the BIG graph's private pool "
          f"{pool / 1e9:.4f} GB, against {whole / 1e9:.2f} GB for one whole "
          "(2N, M) f32 tensor")
    check(peak < whole, f"[beam_staged] peak {peak / 1e9:.3f} GB over a BIG "
          f"scan >= {whole / 1e9:.2f} GB")
    add_counts("beam_staged", _cuda.launch_counts(), 6 * SCAN_LEN)
    print(f"[beam_staged] kernel launches: {path_counts['beam_staged']}")
    to_profile += [("beam_small", staged_b.small, small_state, ms_bsmall),
                   ("beam_big", staged_b.big, big_state, ms_bbig)]
    # [graph] rows of (D)'s two programs: SMALL from its tracked state, BIG
    # from that state grown
    for tag, prog, st0 in (("beam_staged SMALL (D)", staged_b.small,
                            small_state),
                           ("beam_staged BIG (D)", staged_b.big, big_state)):
        _cuda.reset_launch_counts()
        graph_row(graph_rows, tag, prog, st0, scans, angles, deltas, smi)
        add_counts("graph_beam_staged", _cuda.launch_counts(), 11 * SCAN_LEN)
    del staged_b, out, big_state

    stamps.append(("lidar3d", time.perf_counter()))
    # -- 7c. the 3-D lidar: AMHAMCL at 100k, 5760 beams, on the building
    _cuda.reset_launch_counts()
    st, _, ms_settle = timed(lidar, lidar.init(0), 1, lscans, directions)
    st, l_infos, ms_lidar = timed(lidar, st, 1, lscans, directions)
    err_l = final_error(l_infos)
    c = _cuda.launch_counts()
    add_counts("lidar3d", c, 2 * SCAN_LEN)
    print(f"[lidar3d] AMHAMCL n={state_size(lidar_cfg)}, {directions.shape[0]} "
          f"beams (16 rings x 360), volume {tuple(vm.occupancy.shape)}: "
          f"{ms_lidar:.4f} ms/scan over {SCAN_LEN} timed scans (settle "
          f"{ms_settle:.4f}) on {smi}; final error {err_l:.4f} m; launches {c}")
    check(err_l < 0.2, f"[lidar3d] final error {err_l:.3f} m >= 0.2 m")
    check(c.get("voxel_scores", 0) >= 2 * SCAN_LEN,
          "[lidar3d] voxel_scores not launched every scan")
    to_profile.append(("lidar3d", lidar, st, ms_lidar, lscans, directions))
    ref_ms["lidar3d"] = ms_lidar
    # form (b) on the cloud the filter scores on a tracked scan, in its slot
    # order (the step after the timed lap: the truth at the circle's start)
    from mcmh_localization_tpu_torch.models.sensor3d import (
        scan_beams,
        voxel_geometry,
    )

    cloud = scored_cloud(lidar, st, lscans[0], directions, deltas[0])
    u3, v3, z3, live3, count3 = scan_beams(lscans[0], directions, vm,
                                           lidar_cfg, lidar_cfg.lidar3d_sensor_z)
    row = voxel_scores_row("resampled cloud", cloud.contiguous(), u3, v3, z3,
                           live3, lidar.log_field.levels, voxel_geometry(vm),
                           count3, lidar_cfg)
    next(r for r in rows if r["name"] == "voxel_scores").setdefault(
        "shapes", []).append(row)
    # [graph] row of the 3-D lidar from its tracked state
    _cuda.reset_launch_counts()
    graph_row(graph_rows, "lidar3d", lidar, st, lscans, directions, deltas,
              smi)
    add_counts("graph_lidar3d", _cuda.launch_counts(), 11 * SCAN_LEN)
    print(f"[graph] configs: {json.dumps(graph_rows)}")
    del lidar, st, cloud

    stamps.append(("batched", time.perf_counter()))
    # -- 7d. the batched fleet, a fleet on two maps, and the entry twin
    for tag, drive, n in (
            ("batched", lambda c: drive_fleet(gm, scans, angles, deltas,
                                              poses, smi, c), 2 * SCAN_LEN),
            ("multimap", lambda c: drive_multimap(gm, scans, angles, deltas,
                                                  poses, smi, c), SCAN_LEN),
            ("entry", lambda c: drive_entry(smi, c), SCAN_LEN + 1)):
        c = {}
        run16, ms = drive(c)
        add_counts(tag, c, n)
        to_profile.append((tag, run16, ms))

    stamps.append(("edt", time.perf_counter()))
    # -- 7e. the device EDT: a map built with it, tracking on that map, then
    # the kernel against its plain version and scipy up to 4096^2
    c = {}
    drive_edt(gm, timed, scans, deltas, poses, smi, c, rows)
    add_counts("edt", c, SCAN_LEN)

    stamps.append(("eval", time.perf_counter()))
    # -- 8. the experiment runner's CLI on a simulated bag
    for path, c, n in drive_eval(cfg, gm, smi, _cuda.reset_launch_counts,
                                 _cuda.launch_counts):
        add_counts(path, c, n)
    print(f"[eval] kernel launches: staged {path_counts['eval']}, "
          f"FilterConfig() {path_counts['eval_exact']}")

    stamps.append(("dist", time.perf_counter()))
    # -- 8b. the multi-rank filter on an NCCL group of one rank
    drive_dist(gm, cfg, single_cfg, beam_cfg,
               (vm, nav, lidar_cfg, directions, lscans), scans, angles,
               deltas, smi, timed, final_error, add_counts, to_profile,
               ref_ms)
    dist_counts = {p: c for p, c in path_counts.items()
                   if p.startswith("dist_")}
    print(f"[dist] kernel launches: {dist_counts}")
    for name in ("corr_field_build", "corr_lookup", "window_score_at",
                 "expand_sorted", "lut_field", "lut_field_at", "bin_lut",
                 "voxel_scores", "likelihood_scores", "gather_2d"):
        check(any(c.get(name, 0) for c in dist_counts.values()),
              f"[dist] {name} never launched")

    for row in rows:
        row["launches"] = sum(c.get(row["name"], 0)
                              for c in path_counts.values())
        row["launches_per_scan"] = {
            path: c[row["name"]] / path_scans[path]
            for path, c in path_counts.items() if c.get(row["name"], 0)}
        if row.get("on_main_path", True):
            check(row["launches"] > 0, f"{row['name']} never launched")
        print(f"[kernel] {row['name']}: launches per scan by path "
              f"{json.dumps(row['launches_per_scan'])}")
    print(f"[paths] launches per path: {json.dumps(path_counts)} over "
          f"scans {json.dumps(path_scans)}")

    stamps.append(("end", time.perf_counter()))
    print("[time] seconds by phase: " + ", ".join(
        f"{a} {t1 - t0:.2f}" for (a, t0), (_, t1) in zip(stamps, stamps[1:])))
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        pdir = Path(args.profile)
        pdir.mkdir(parents=True, exist_ok=True)
        for tag, *what in to_profile:
            # (model, state, ms, inputs...) for a model's 16 scans, or (a
            # call that runs 16 scans, ms)
            run16 = (what[0] if len(what) == 2
                     else functools.partial(timed, what[0], what[1], 1,
                                            *what[3:]))
            ms = what[-1] if len(what) == 2 else what[2]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run16()
            averages = prof.key_averages()
            (pdir / f"{tag}_profile.txt").write_text(averages.table(
                sort_by="self_device_time_total", row_limit=80))
            (pdir / f"{tag}_host.txt").write_text(averages.table(
                sort_by="self_cpu_time_total", row_limit=40))
            cummax = sorted({e.key for e in averages if "cummax" in e.key})
            check(not cummax, f"[profile] {tag}: a cummax ran: {cummax}")
            trace = pdir / f"{tag}_trace.json"
            prof.export_chrome_trace(str(trace))
            # device busy = the kernels' and copies' own time on the card
            dev_us = sum(e.get("dur", 0.0)
                         for e in json.loads(trace.read_text())["traceEvents"]
                         if e.get("cat") in ("kernel", "gpu_memcpy",
                                             "gpu_memset"))
            busy = dev_us / 1e3 / SCAN_LEN
            print(f"[profile] {tag}: device busy {busy:.4f} ms/scan of "
                  f"{ms:.4f} ms/scan unprofiled -> idle share "
                  f"{1 - busy / ms:.3f} on {smi}; no cummax ran; wrote "
                  f"{pdir}/{tag}_*")
            # the host's own time a scan under the profiler, and the ops
            # that hold most of it (calls a scan, host ms a scan)
            host = sorted(averages, key=lambda e: -e.self_cpu_time_total)
            total = sum(e.self_cpu_time_total for e in averages)
            print(f"[profile] {tag}: host self time {total / 1e3 / SCAN_LEN:.4f}"
                  " ms/scan, most in " + ", ".join(
                      f"{e.key} {e.count / SCAN_LEN:.1f}x "
                      f"{e.self_cpu_time_total / 1e3 / SCAN_LEN:.4f}"
                      for e in host[:6]))

    drive_dryrun()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "pct_of_bound", "launches_per_scan", "shape")
    shape_keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "pct_of_bound", "max_abs_err")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **({} if r.get("on_main_path", True) else {"on_main_path": False}),
         **{k: r[k] for k in ("cummax_ms", "searchsorted_ms", "smem_floor_ms",
                              "scipy_host_ms", "prev_ms") if k in r},
         **({"shapes": [{k: x[k] for k in shape_keys + (
             "smem_floor_ms", "scipy_host_ms", "prev_ms") if k in x}
             for x in r["shapes"]]}
            if r.get("shapes") else {})}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        end_world()
    sys.exit(code)
