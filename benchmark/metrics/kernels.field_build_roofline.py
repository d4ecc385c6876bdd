"""kernels.field_build_roofline: the full-map correlation field build at the
staged BIG program's shapes (all of its theta bins, the whole map padded
by the scan's reach), on scans of the cell's own traffic, called through
the public ``models/corr_field.py::build_correlation_field`` and timed by
CUDA events; its share of the least time the card could take for that
work (``counts/field_build.py`` against ``counts/peaks.py``), in %.
The share reads the same work whatever kernel implements the build.
Nothing to read without a staged configuration on the card."""

import math
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark.counts import field_build, peaks

SCANS = 8      # scans of the traffic, spread over the window's
RUNS = 20      # timed runs, the median taken


def device_ms(fn, runs: int = RUNS) -> float:
    """Device ms of one call: CUDA events around a run of back-to-back
    calls, over the count, the median of ``runs`` runs.  A sleep kernel
    queued ahead of each run holds the card while the host enqueues the
    whole run, so the host's work stays out of the reading
    (``chip_smoke.py::device_ms``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    per_run = max(1, min(100, int(2e-3 / (time.perf_counter() - t0))))
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


def _power_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "?"


def read(run):
    staged = getattr(run.loc, "staged", None)
    if not run.cuda or staged is None:
        return None
    from mcmh_localization_tpu_torch.models.corr_field import (
        build_correlation_field,
    )

    cfg, gm = staged.config, run.loc.grid_map
    log_field = staged.big.log_field
    k = cfg.corr_n_theta
    h, w = log_field.shape
    pad = int(-(-cfg.max_range // gm.res)) + 2
    inv_res = float(np.float32(1.0) / np.float32(gm.res))
    m = run.traffic.n_beams
    angles = torch.linspace(-math.pi, math.pi, m, dtype=torch.float32,
                            device=run.device)
    total_ms = bound = 0.0
    for t in np.linspace(0, len(run.traffic.ranges) - 1, SCANS).astype(int):
        r = torch.from_numpy(run.traffic.ranges[t]).to(run.device)
        valid = torch.isfinite(r) & (r < cfg.max_range)
        sr = torch.where(valid, r, 0.0)
        u, v = sr * torch.cos(angles), sr * torch.sin(angles)
        total_ms += device_ms(lambda: build_correlation_field(
            log_field, u, v, valid, inv_res, k, pad))
        bound += peaks.bound_ms(
            field_build.ops(k, h, w, int(valid.sum())),
            field_build.nbytes(k, h, w, m, h + 2 * pad, w + 2 * pad))[0]
    share = 100.0 * bound / total_ms
    print(f"field build: {total_ms / SCANS:.4f} ms a scan against a bound of "
          f"{bound / SCANS:.5f} ms ({share:.2f}%) on {_power_line()}",
          file=sys.stderr)
    return share
