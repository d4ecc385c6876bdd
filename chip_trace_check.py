#!/usr/bin/env python3
"""Checks of the port's tracing (``utils/profiling.py``) on one NVIDIA GPU,
in the benchmark's cells.  Each run is ``benchmark/harness.py::run_cell``
untraced (as ``--trace 0``), with the program's tracing switched from
outside: on before the run, so the warm-up captures each program's step
with its stage stamps; the records reset as the window starts (the
harness's set-up line) and collected as it ends (before its first metric
is read).  One process, in this order:

1. the window: ``WINDOW`` seconds a run, tracing off, on, on, off at two
   seeds (each seed off and on).  Tracing's cost on ``scans_per_s``; the
   spans of each call against the harness's host clock around the same
   calls; every span's total, self time and count, host syncs, bodies run
   and each program's stage times a scan; and the slowest 1% of
   ``on_scan`` calls split by child, with the odometry before them (the
   records by scan number).
2. launches and bitwise: a window of ``SCANS`` scans from one seed with
   tracing off and one with it on: each program's captured step, its nodes
   a replay (``CapturedStep.launches_per_scan``), and the states, the
   generator and the pose after the window equal.
3. stages against the profiler, in the run with tracing on: ``REPLAYS``
   replays of each program's captured step under ``torch.profiler``, the
   stamps' sum against each replay's extent on the card (its kernels,
   copies and memsets from the first to the last).  Last, because a
   profiler session slows every later launch in the process.

    python3 chip_trace_check.py [--cells a,b]

Lines go to standard output, the last one the readings as one JSON
object; the harness's lines go to standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
CELLS = ("house_staged_1m.square_track", "house_amcl_default.square_track",
         "house_staged_1m.kidnap")
SEEDS = (2**31 + 977, 2**31 + 4099)
WINDOW = 20.0      # part 1: seconds of a window
SCANS = 200        # part 2: scans of a window
REPLAYS = 20       # part 3: replays of each program under the profiler
TAIL = 0.01        # part 1: the share of slowest on_scan calls split


def log(*a) -> None:
    print(*a, flush=True)


def cell_run(name: str, seed: int, seconds: float, on: bool, hook=None,
             overrides: dict | None = None):
    """One run of the cell with tracing ``on``: (the result line, what the
    window recorded: ``tracing`` (``profiling.collect``), ``records``,
    the harness's ``scans``, ``window_s``, ``odom_s`` (summed) and
    ``scan_s`` (each call), and ``hook(run)`` on the harness's run)."""
    from benchmark import harness, world
    from mcmh_localization_tpu_torch.utils import profiling

    got: dict = {}

    def hlog(*a) -> None:
        if str(a[0]).startswith("set-up"):
            profiling.reset()       # the window starts next
        print(*a, file=sys.stderr, flush=True)

    reader = world.metric_reader

    def first_read(metric: str):
        mod = reader(metric)

        def read(run):
            if not got:
                got.update(tracing=profiling.collect(),
                           records=profiling.records(), scans=run.scans,
                           window_s=run.window_s,
                           odom_s=float(run.odom_s.sum()),
                           scan_s=run.scan_s.copy(),
                           hook=hook(run) if hook else None)
            return mod.read(run)
        return SimpleNamespace(read=read)

    profiling.enable(on)
    world.metric_reader = first_read
    try:
        out = harness.run_cell(name, seed, seconds, False, "cuda",
                               time.perf_counter(), overrides, log=hlog)
    finally:
        world.metric_reader = reader
        profiling.enable(False)
    return out, got


def programs(loc) -> dict:
    if loc.staged is None:
        return {"step": loc.model}
    return {"big": loc.staged.big, "small": loc.staged.small}


def launches(loc) -> dict:
    """{program/capacity: launches_per_scan of its captured correct step}."""
    return {f"{name}/{n_max}": cs.launches_per_scan()
            for name, model in programs(loc).items()
            for (n_max, _, _), cs in model._graphs.items()
            if cs.graph is not None}


def tail_split(rec: dict, share: float) -> dict:
    """The slowest ``share`` of the ``online.on_scan`` spans in the
    records: their mean, each child's mean in them, and the mean
    ``online.on_odom`` total of the same scans (by scan number), ms; the
    same means over every scan beside them."""
    names = rec["names"]
    dur = (rec["end_ns"] - rec["start_ns"]) * 1e-6
    top = np.flatnonzero(rec["name"] == names.index("online.on_scan"))
    odom = rec["name"] == names.index("online.on_odom")
    k = max(1, int(len(top) * share))
    out = {}
    for tag, spans in (("slowest", top[np.argsort(dur[top])[-k:]]),
                       ("all", top)):
        kids = np.isin(rec["parent"], spans)
        row = {"scans": len(spans), "online.on_scan": dur[spans].mean(),
               "online.on_odom": dur[odom & np.isin(rec["scan"],
                                                    rec["scan"][spans])].sum()
               / len(spans)}
        for i in np.unique(rec["name"][kids]):
            row[names[i]] = dur[kids & (rec["name"] == i)].sum() / len(spans)
        out[tag] = row
    return out


def window_reading(out: dict, got: dict) -> dict:
    """Part 1's numbers of one run with tracing on."""
    from mcmh_localization_tpu_torch.utils import profiling

    n = got["scans"]
    tr = got["tracing"]
    spans = tr["spans"]
    return {
        "scans": n, "correct": out["correct"],
        "odom_ms_outside": got["odom_s"] * 1e3 / n,
        "odom_ms_spans": spans["online.on_odom"]["total_ns"] * 1e-6 / n,
        "scan_ms_outside": float(got["scan_s"].mean()) * 1e3,
        "scan_ms_spans": spans["online.on_scan"]["total_ns"] * 1e-6 / n,
        "spans_ms_per_scan": {k: [v["total_ns"] * 1e-6 / n,
                                  v["self_ns"] * 1e-6 / n, v["count"]]
                              for k, v in sorted(spans.items())},
        "host_syncs_per_scan": tr["counters"].get("host_sync", 0) / n,
        "bodies_per_scan": {k: v / n for k, v in tr["bodies"].items()},
        # each program's ms a scan of its own, and the scans it ran
        "stages": {p: {**{s: v[s]["ns"] * 1e-6 / v["begin"]["count"]
                          for s in profiling.STAGES[1:]},
                       "scans": v["begin"]["count"]}
                   for p, v in tr["stages"].items() if v["begin"]["count"]},
        "tail": tail_split(got["records"], TAIL)}


def check_window(name: str) -> dict:
    """Part 1: off, on, on, off, the first two at one seed, the last two
    at the other."""
    runs = []
    for seed, on in zip((SEEDS[0], SEEDS[0], SEEDS[1], SEEDS[1]),
                        (False, True, True, False)):
        out, got = cell_run(name, seed, WINDOW, on)
        row = {"seed": seed, "on": on, "correct": out["correct"],
               "scans_per_s": out["metrics"]["scans_per_s"]["value"],
               "scan_p99_ms": out["metrics"]["scan_p99_ms"]["value"]}
        if on:
            row["inside"] = window_reading(out, got)
        runs.append(row)
        log(f"[{name}] window: {json.dumps(row)}")
    cost = {str(s): 100.0 * (1 - next(r["scans_per_s"] for r in runs
                                      if r["seed"] == s and r["on"])
                             / next(r["scans_per_s"] for r in runs
                                    if r["seed"] == s and not r["on"]))
            for s in SEEDS}
    log(f"[{name}] cost of tracing on scans_per_s, % by seed: "
        f"{json.dumps(cost)}")
    return {"runs": runs, "cost_pct": cost}


def state_of(run) -> dict:
    """The localizer's state, generator and pose after the window."""
    from mcmh_localization_tpu_torch.filter.captured import STATE_TENSORS

    st = run.loc.state
    return {"tensors": {f: getattr(st, f).clone() for f in STATE_TENSORS},
            "gen": st.key.get_state(),
            "pose": tuple(run.loc.estimate()["pose3"])}


def chrome_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def replay_device_ms(events: list) -> dict:
    """{"launches", "extent_ms", "stamped_ms"} of the trace's graph
    launches: the device time from each launch's first node to its last,
    and from its first stage stamp to its last, summed."""
    launch = {e["args"]["correlation"] for e in events
              if e.get("name") == "cudaGraphLaunch" and "args" in e
              and "correlation" in e["args"]}
    groups: dict = {}
    for e in events:
        if (e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                and e.get("args", {}).get("correlation") in launch):
            groups.setdefault(e["args"]["correlation"], []).append(e)
    extent = stamped = 0.0
    for evs in groups.values():
        extent += (max(e["ts"] + e["dur"] for e in evs)
                   - min(e["ts"] for e in evs))
        st = sorted(e["ts"] for e in evs if "trace_stamp" in e["name"])
        if len(st) >= 2:
            stamped += st[-1] - st[0]
    return {"launches": len(groups), "extent_ms": extent * 1e-3,
            "stamped_ms": stamped * 1e-3}


def check_stages(run) -> dict:
    """Part 3: each program's captured step replayed under the profiler
    on the window's last state (BIG's grown from it, SMALL's shrunk)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcmh_localization_tpu_torch.filter.staged import (
        grow_state,
        shrink_state,
    )
    from mcmh_localization_tpu_torch.filter.state import copy_generator
    from mcmh_localization_tpu_torch.utils import profiling

    loc = run.loc
    ranges = torch.from_numpy(run.traffic.ranges[-1]).to(run.device)
    angles = torch.linspace(-3.141592653589793, 3.141592653589793,
                            ranges.shape[0], dtype=torch.float32,
                            device=run.device)
    st = loc.state
    states = {"step": st}
    if loc.staged is not None:
        big = grow_state(st, loc._n_big) if loc._in_small else st
        states = {"big": big, "small": shrink_state(big, loc._cap)}
    out = {}
    for name, model in programs(loc).items():
        s0 = states[name]
        cs = model.captured(s0, ranges.shape[0], predict=False)
        cs.scan(s0.replace(key=copy_generator(s0.key)), ranges, angles)
        torch.cuda.synchronize(run.device)
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPLAYS):
                cs.scan(s0.replace(key=copy_generator(s0.key)), ranges,
                        angles)
            torch.cuda.synchronize(run.device)
        stages = profiling.collect()["stages"][name]
        dev = replay_device_ms(chrome_events(prof))
        stamps = sum(stages[s]["ns"] for s in profiling.STAGES) * 1e-6
        out[name] = {"replays": REPLAYS, "stages_ms": stamps / REPLAYS,
                     "by_stage_ms": {s: stages[s]["ns"] * 1e-6 / REPLAYS
                                     for s in profiling.STAGES[1:]},
                     "counts": {s: stages[s]["count"]
                                for s in profiling.STAGES},
                     "profiler": {k: (v / REPLAYS if k != "launches" else v)
                                  for k, v in dev.items()}}
    return out


def check_bitwise(name: str) -> dict:
    """Parts 2 and 3: ``SCANS`` scans with tracing off, then on."""
    import torch

    # the window ends at SCANS scans: seconds too short to matter, and
    # traffic for just past them
    over = {"run": {"min_window_scans": SCANS,
                    "max_scans_per_s": 100 * (SCANS + 1)}}
    seen = {}
    for on in (False, True):
        def hook(run, on=on):
            got = {"launches": launches(run.loc), "state": state_of(run)}
            if on:
                got["stages"] = check_stages(run)
            return got

        out, got = cell_run(name, SEEDS[0], 0.01, on, hook=hook,
                            overrides=over)
        seen[on] = {**got["hook"], "scans": got["scans"],
                    "correct": out["correct"]}
    off, on = seen[False], seen[True]
    same = (all(torch.equal(off["state"]["tensors"][f], t)
                for f, t in on["state"]["tensors"].items())
            and torch.equal(off["state"]["gen"], on["state"]["gen"])
            and off["state"]["pose"] == on["state"]["pose"])
    res = {"scans": [off["scans"], on["scans"]], "bitwise": bool(same),
           "correct": [off["correct"], on["correct"]],
           "launches_off": off["launches"], "launches_on": on["launches"],
           "stages": on["stages"]}
    log(f"[{name}] after {SCANS} scans: {json.dumps(res)}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    cells = ap.parse_args(argv).cells.split(",")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        log("chip_trace_check: no CUDA card")
        return 2
    log(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    res = {c: {"window": check_window(c)} for c in cells}
    for c in cells:
        res[c].update(check_bitwise(c))
    log(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
