"""Reading a ``torch.profiler`` trace of the profiled stretch: device busy
time (kernels, copies and memsets, as ``chip_smoke.py::profile_window``
counts it), kernels, and the breakdown the result line carries: the device
operations that took the most time, and the idle gaps on the device named
by what the host was doing (inside ``on_odom``, inside ``on_scan``, or
between them)."""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

BUSY = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("bench.on_odom", "bench.on_scan")
NAME_CHARS = 120   # a device operation's name, cut (C++ template names run long)


class TraceSummary(NamedTuple):
    busy_s: float
    kernels: int
    wall_s: float
    scans: int
    device_ops: list     # [[name, seconds]], the 10 longest in total
    idle_gaps: list      # [[host activity, seconds]], longest first


def _host_at(spans: list, t: float) -> str:
    for name, t0, t1 in spans:
        if t0 <= t <= t1:
            return name.split(".", 1)[1]
    return "between"


def summarize(prof, scans: int, wall_s: float) -> TraceSummary:
    """The summary of a finished profiler over ``scans`` scans and
    ``wall_s`` seconds of host clock.  The trace goes through a file in
    the temporary directory, deleted after it is read."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    dev = sorted((e for e in events if e.get("cat") in BUSY and "dur" in e),
                 key=lambda e: e["ts"])
    busy_us = sum(e["dur"] for e in dev)
    kernels = sum(e["cat"] == "kernel" for e in dev)
    per_op = defaultdict(float)
    for e in dev:
        per_op[e.get("name", "?")[:NAME_CHARS]] += e["dur"]
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") in SPANS and "dur" in e),
                   key=lambda s: s[1])
    idle = defaultdict(float)
    end = None
    for e in dev:
        if end is not None and e["ts"] > end:
            idle[_host_at(spans, 0.5 * (end + e["ts"]))] += e["ts"] - end
        end = e["ts"] + e["dur"] if end is None else max(end, e["ts"] + e["dur"])
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])
    return TraceSummary(
        busy_s=busy_us * 1e-6, kernels=kernels, wall_s=wall_s, scans=scans,
        device_ops=[[n, us * 1e-6] for n, us in ops],
        idle_gaps=[[n, us * 1e-6] for n, us in gaps])
