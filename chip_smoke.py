#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

1. Requires CUDA (exits non-zero without it) and prints the card's name
   and power limit as nvidia-smi reports them.
2. Builds the port's CUDA kernels from ``mcmh_localization_tpu_torch/csrc``.
3. Compares every kernel with its plain PyTorch version on the card at the
   main path's shapes (BIG field K=120 384^2 M=360, SMALL field K=32 128^2,
   lookups of 2x1M and 2x130048 poses, the 1M resampling expansion) and
   times both with CUDA events.
4. Drives the main path: AMHAMCL, KLD-adaptive at 1M capacity / 100k
   minimum, 360 beams, the staged two-program runner with a 0.9 tracking
   ESS gate and the windowed corr scorer, on a procedural 384x384 house map
   at 0.05 m, over 4x16 scans of a closed circle; then times the SMALL
   (tracking) and BIG programs.  Checks the run ends in the SMALL program,
   estimates are finite, the final error is under 0.2 m, and the field
   build, lookup and expansion kernels all launched.
5. Prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as
   the last line.

``--profile DIR`` also writes a torch.profiler table and trace of the
tracking stretch to DIR.
"""

from __future__ import annotations

import argparse
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


def check(cond, msg: str) -> None:
    """A phase check that fails the run (kept under ``python -O`` too)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def compare_kernels(gm, cfg, small_cfg, log_field, ranges, angles, rows):
    """Phase 3: each kernel vs its plain version at main-path shapes."""
    from mcmh_localization_tpu_torch.filter.init import init_gaussian
    from mcmh_localization_tpu_torch.models.corr_field import (
        _bin_offsets,
        pad_cells_for,
    )
    from mcmh_localization_tpu_torch.ops.corr_field_build import (
        corr_field_build,
        corr_field_build_plain,
    )
    from mcmh_localization_tpu_torch.ops.gather import (
        LookupGeometry,
        corr_lookup,
        corr_lookup_indices,
        corr_lookup_plain,
        gather_2d,
        gather_2d_plain,
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

    def field_row(name, padded, ox, oy, fh, fw):
        out = corr_field_build(padded, ox, oy, fh, fw)
        ref = corr_field_build_plain(padded, ox, oy, fh, fw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = 1e-5 * m * lmax  # f32 sums of M log values
        check(err <= tol, f"{name}: max abs err {err} > {tol}")
        ms = cuda_ms(lambda: corr_field_build(padded, ox, oy, fh, fw), 20)
        pms = cuda_ms(lambda: corr_field_build_plain(padded, ox, oy, fh, fw), 3, 1)
        print(f"[kernel] {name}: K={ox.shape[0]} {fh}x{fw} M={m} "
              f"max_abs_err={err} (tol {tol:.3g}) ms={ms:.4f} plain_ms={pms:.4f}")
        return out, err, ms, pms

    # BIG: full map, all 120 bins
    ox, oy = _bin_offsets(u, v, valid, gm.inv_res, cfg.corr_n_theta, pad, zb)
    padded_big = torch.cat([padded0, torch.zeros((h, padded0.shape[1]), device=dev)])
    field_big, err_b, ms_b, pms_b = field_row("corr_field_build BIG", padded_big,
                                              ox, oy, h, w)
    # SMALL: 128-cell window at the start pose, 32 theta bins
    win, tw = small_cfg.corr_window_cells, small_cfg.corr_theta_window_bins
    oy0 = int((START[1] - gm.origin_xy[1]) / RES) - win // 2
    ox0 = int((START[0] - gm.origin_xy[0]) / RES) - win // 2
    kstart = (int((START[2] + math.pi) * cfg.corr_n_theta / (2 * math.pi))
              - tw // 2) % cfg.corr_n_theta
    oxs, oys = _bin_offsets(u, v, valid, gm.inv_res, cfg.corr_n_theta, pad, zb,
                            bin_start=kstart, nbins=tw)
    side = win + 2 * pad
    padded_small = torch.cat([padded0[oy0:oy0 + side, ox0:ox0 + side],
                              torch.zeros((win, side), device=dev)]).contiguous()
    oys = torch.where(oys >= zb, side, oys).to(torch.int32).contiguous()
    field_small, err_s, ms_s, pms_s = field_row(
        "corr_field_build SMALL", padded_small, oxs, oys, win, win)
    rows.append(dict(name="corr_field_build", route="cuda",
                     source="mcmh_localization_tpu_torch/csrc/corr_field_build.cu",
                     replaces="mcmh_localization_tpu/ops/corr_field_pallas.py:40",
                     max_abs_err=max(err_b, err_s), ms=ms_b, plain_ms=pms_b,
                     ms_small=ms_s, plain_ms_small=pms_s))

    # lookups: 2 x n poses (the MH step scores both sets in one call)
    gen = torch.Generator(device=dev).manual_seed(7)
    cov = torch.diag(torch.tensor(cfg.initial_cov))
    geo_big = LookupGeometry(gm.origin_xy[0], gm.origin_xy[1], gm.inv_res,
                             cfg.corr_n_theta, cfg.corr_n_theta, h, w, h, w)
    geo_small = LookupGeometry(gm.origin_xy[0], gm.origin_xy[1], gm.inv_res,
                               cfg.corr_n_theta, tw, win, win, h, w,
                               kstart=kstart, window=(ox0, oy0))
    look = {}
    for name, n, field, geo, agg in (
            ("corr_lookup BIG", 1_000_000, field_big, geo_big, "sum"),
            ("corr_lookup SMALL", 130_048, field_small, geo_small, "mean")):
        parts = init_gaussian(START, cov, 2 * n, gm, generator=gen)
        out = corr_lookup(field, parts, n_valid, geo, agg, True)
        ref = corr_lookup_plain(field, parts, n_valid, geo, agg, True)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"{name}: kernel != plain")
        ms = cuda_ms(lambda: corr_lookup(field, parts, n_valid, geo, agg, True), 50)
        pms = cuda_ms(lambda: corr_lookup_plain(field, parts, n_valid, geo, agg, True), 20)
        print(f"[kernel] {name}: N=2x{n} bitwise=True ms={ms:.4f} plain_ms={pms:.4f}")
        look[name] = (ms, pms, parts)
    ms_lb, pms_lb, _ = look["corr_lookup BIG"]
    ms_ls, pms_ls, parts_s = look["corr_lookup SMALL"]
    rows.append(dict(name="corr_lookup", route="cuda",
                     source="mcmh_localization_tpu_torch/csrc/gather.cu",
                     replaces="mcmh_localization_tpu/ops/gather_pallas.py:96",
                     max_abs_err=0.0, ms=ms_lb, plain_ms=pms_lb,
                     ms_small=ms_ls, plain_ms_small=pms_ls))

    # gather_2d at the TPU's SMALL lookup shape: a (4096, 128) table, 2x130048
    tbin, myc, mxc, _, _ = corr_lookup_indices(parts_s, geo_small)
    table = field_small.reshape(tw * win, win)
    y = (tbin * win + myc).to(torch.int32).contiguous()
    x = mxc.to(torch.int32).contiguous()
    g = gather_2d(table, y, x)
    check(torch.equal(g, gather_2d_plain(table, y, x)), "gather_2d != plain")
    ms_g = cuda_ms(lambda: gather_2d(table, y, x), 50)
    pms_g = cuda_ms(lambda: gather_2d_plain(table, y, x), 20)
    print(f"[kernel] gather_2d (off the main path): table {tuple(table.shape)} "
          f"N={y.numel()} bitwise=True ms={ms_g:.4f} plain_ms={pms_g:.4f}")

    # resampling expansion: bounds of 1M posterior weights
    n_big = 1_000_000
    parts = init_gaussian(START, cov, n_big, gm, generator=gen)
    s = corr_lookup(field_big, parts, n_valid, geo_big, "mean", True)
    wts = softmax_weights(s * 40.0)
    r = torch.rand((), generator=gen, device=dev)
    for num_out in (131_072, n_big):
        bound = _segment_bounds(wts, num_out, n_big, r)
        e = expand_sorted(bound, parts, num_out, count=n_big)
        check(torch.equal(e, expand_sorted_plain(bound, parts, num_out, n_big)),
              f"expand_sorted != plain at num_out={num_out}")
        ri = rank_in_sorted(bound, num_out, count=n_big)
        check(torch.equal(ri, rank_in_sorted_plain(bound, num_out, n_big)),
              f"rank_in_sorted != plain at num_out={num_out}")
        ms_e = cuda_ms(lambda: expand_sorted(bound, parts, num_out, n_big), 50)
        pms_e = cuda_ms(lambda: expand_sorted_plain(bound, parts, num_out, n_big), 20)
        ms_r = cuda_ms(lambda: rank_in_sorted(bound, num_out, n_big), 50)
        pms_r = cuda_ms(lambda: rank_in_sorted_plain(bound, num_out, n_big), 20)
        print(f"[kernel] expand_sorted R={n_big} num_out={num_out}: bitwise=True "
              f"ms={ms_e:.4f} plain_ms={pms_e:.4f}")
        print(f"[kernel] rank_in_sorted (off the main path) R={n_big} "
              f"num_out={num_out}: bitwise=True ms={ms_r:.4f} plain_ms={pms_r:.4f}")
    rows.append(dict(name="expand_sorted", route="cuda",
                     source="mcmh_localization_tpu_torch/csrc/rank.cu",
                     replaces="mcmh_localization_tpu/ops/rank_pallas.py:361",
                     max_abs_err=0.0, ms=ms_e, plain_ms=pms_e))


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
    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.filter.staged import (
        grow_state,
        make_staged_model,
        run_staged,
    )
    from mcmh_localization_tpu_torch.filter.step import state_size
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map
    from mcmh_localization_tpu_torch.models.sensor import raycast
    from mcmh_localization_tpu_torch.ops import _cuda

    check("jax" not in sys.modules, "the port must not import jax")

    # -- 2. build
    t0 = time.perf_counter()
    _cuda.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_cuda.build_seconds:.2f} s) -> {_cuda.library_path().name}")
    for line in _cuda.build_log.splitlines():  # ptxas -v: registers, smem
        if "entry function" in line or "registers" in line:
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

    # -- 3. kernels vs plain versions
    rows: list[dict] = []
    compare_kernels(gm, staged.config, staged.small_config,
                    staged.big.log_field, scans[0], angles, rows)

    # -- 4. the main path
    _cuda.reset_launch_counts()
    state = staged.init(0)
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

    def timed(model, st, reps):
        seq = scans.repeat(reps, 1)
        dls = deltas.repeat(reps, 1)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        st, infos = model.run(st, seq, angles, dls)
        e1.record()
        torch.cuda.synchronize()
        return st, infos, e0.elapsed_time(e1) / seq.shape[0]

    small_state, s_infos, ms_small = timed(staged.small, out.state, 3)
    s_est = s_infos.estimate.mean.cpu().numpy()
    s_err = float(np.hypot(s_est[-1, 0] - poses[-1, 0], s_est[-1, 1] - poses[-1, 1]))
    print(f"[main] SMALL (n_max={state_size(staged.small_config)}) tracking: "
          f"{ms_small:.4f} ms/scan over {3 * SCAN_LEN} scans on {smi}; "
          f"final error {s_err:.4f} m; counts {s_infos.count.min().item()}.."
          f"{s_infos.count.max().item()}")
    check(np.isfinite(s_est).all(), "non-finite SMALL estimate")
    check(s_err < 0.2, f"SMALL final error {s_err:.3f} m >= 0.2 m")
    big_state = grow_state(small_state, state_size(staged.config))
    _, b_infos, ms_big = timed(staged.big, big_state, 1)
    print(f"[main] BIG (n_max={state_size(staged.config)}) program: "
          f"{ms_big:.4f} ms/scan over {SCAN_LEN} scans on {smi}")
    check(np.isfinite(b_infos.estimate.mean.cpu().numpy()).all(),
          "non-finite BIG estimate")
    counts_after = _cuda.launch_counts()
    print(f"[main] kernel launches in the main path: {counts_after}")
    for row in rows:
        row["launches"] = counts_after.get(row["name"], 0)
        check(row["launches"] > 0, f"{row['name']} never launched")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        pdir = Path(args.profile)
        pdir.mkdir(parents=True, exist_ok=True)
        for tag, model, st, ms in (
                ("small", staged.small, small_state, ms_small),
                ("big", staged.big,
                 grow_state(small_state, state_size(staged.config)), ms_big)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                timed(model, st, 1)
            (pdir / f"{tag}_profile.txt").write_text(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
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
                  f"{1 - busy / ms:.3f} on {smi}; wrote {pdir}/{tag}_*")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
