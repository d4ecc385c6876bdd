"""Tracing the port: spans and counters on the host, stage clocks inside the
filter step on the card, and torch.profiler traces.

The reference has no profiling at all (SURVEY.md §5).  One process-wide
switch, ``enable``, off by default; off, every hook costs one check of it:
``span`` returns one shared no-op context (no allocation, no clock read, no
``record_function``), ``count`` and ``stamp`` return at once.  On:

* ``span(name, scan=-1)`` writes a record into preallocated numpy columns:
  the name's id, start and end on ``time.perf_counter_ns``, the index of
  the span it opened inside (-1 at the top) and the scan number (-1:
  its parent's).  It allocates no Python object that the collector
  tracks.  Under a recording ``torch.profiler`` it also enters
  ``torch.profiler.record_function(name)``, so the span sits on the
  profiler's timeline beside the card's kernels.
* ``count(name, k=1)`` adds to a host counter.
* ``stamp(stage)``, in ``filter/step.py::_correct``: where a step runs
  under a stage clock (``clocked``), the time since the clock's previous
  stamp goes to ``stage``.  A step captured while tracing is on holds its
  stamps as nodes of the graph (``ops/trace_stamp.py``: a one-thread
  kernel reading the card's global timer), one clock a program; an eager
  step on the CPU stamps with ``perf_counter_ns``.  Captured with tracing
  off, a step has no stamp nodes.
* ``collect()`` reads everything once (one wait on the card): per span
  name the total, the self time (the total less its child spans') and the
  count; the counters; each program's time and stamps by stage; the runs
  of each conditional body by name (a captured body's counter on the
  card, ``ops/_cuda.py::add_replayed``; ``ran`` in ``run_if``'s plain
  version).
* ``reset()`` clears the spans and counters and queues the zeroing of the
  stage clocks and a snapshot of the bodies' counters.

The spans, counters and stages the online localizer records, and the
metrics that read them, are listed in PERF.md §3.  ``trace`` wraps
torch.profiler and writes a chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

TRACE_FILE = "trace.json"
# the filter step's stages, in the order _correct stamps them: "begin"
# opens a scan (its stamp only counts), each later stamp closes the stage
# named after it
STAGES = ("begin", "score", "mh", "estimate", "resample")
_STAGE = {s: i for i, s in enumerate(STAGES)}
_CAPACITY = 1 << 16     # span records before the columns first grow

_on = False


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace (the host, and the card when there is
    one) into ``log_dir``/trace.json, viewable in chrome://tracing or
    Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def enable(on: bool = True) -> None:
    """Turn tracing on or off for the whole process.  A captured step
    holds stamp nodes only where tracing was on when it was captured; a
    ``filter/captured.py::CapturedStep`` captures anew at its next run when
    the switch has changed since."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


class _NoSpan:
    """The context ``span`` returns while tracing is off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Spans:
    """The span records, in columns that double when full, and the open
    spans.  ``span`` sets the name and scan of the next record, and the
    same object is the context that opens and closes it."""

    def __init__(self, capacity: int = _CAPACITY):
        self.names: list[str] = []
        self.ids: dict[str, int] = {}
        self._alloc(capacity)
        self.n = 0
        self.stack: list[int] = []      # open spans' indices
        self.rfs: list = []             # their record_function, or None
        self.next_name = 0
        self.next_scan = -1

    def _alloc(self, capacity: int) -> None:
        self.name = np.zeros(capacity, np.int32)
        self.parent = np.zeros(capacity, np.int64)
        self.scan = np.zeros(capacity, np.int64)
        self.start = np.zeros(capacity, np.int64)
        self.end = np.zeros(capacity, np.int64)

    def _grow(self) -> None:
        n = self.n
        old = (self.name, self.parent, self.scan, self.start, self.end)
        self._alloc(2 * len(self.start))
        for new, col in zip((self.name, self.parent, self.scan, self.start,
                             self.end), old):
            new[:n] = col[:n]

    def intern(self, name: str) -> int:
        i = self.ids.get(name)
        if i is None:
            i = self.ids[name] = len(self.names)
            self.names.append(name)
        return i

    def __enter__(self):
        i = self.n
        if i == len(self.start):
            self._grow()
        stack = self.stack
        parent = stack[-1] if stack else -1
        scan = self.next_scan
        if scan < 0 and parent >= 0:
            scan = self.scan[parent]
        self.name[i] = self.next_name
        self.parent[i] = parent
        self.scan[i] = scan
        self.end[i] = -1
        stack.append(i)
        self.n = i + 1
        if torch.autograd.profiler._is_profiler_enabled:
            rf = torch.profiler.record_function(self.names[self.next_name])
            rf.__enter__()
            self.rfs.append(rf)
        else:
            self.rfs.append(None)
        self.start[i] = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        self.end[self.stack.pop()] = t
        rf = self.rfs.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        return False

    def clear(self) -> None:
        if self.stack:
            raise RuntimeError("profiling.reset: spans are open")
        self.n = 0
        self.names.clear()
        self.ids.clear()

    def records(self) -> dict:
        n = self.n
        return {"names": list(self.names), "name": self.name[:n].copy(),
                "parent": self.parent[:n].copy(), "scan": self.scan[:n].copy(),
                "start_ns": self.start[:n].copy(), "end_ns": self.end[:n].copy()}

    def totals(self) -> dict:
        """{name: {"total_ns", "self_ns", "count"}} of the closed spans."""
        n = self.n
        done = self.end[:n] >= 0
        dur = np.where(done, self.end[:n] - self.start[:n], 0)
        parent = self.parent[:n]
        child = np.zeros(n, np.int64)
        inner = done & (parent >= 0)
        np.add.at(child, parent[inner], dur[inner])
        k = len(self.names)
        name = self.name[:n]
        total = np.zeros(k, np.int64)
        own = np.zeros(k, np.int64)
        count = np.zeros(k, np.int64)
        np.add.at(total, name[done], dur[done])
        np.add.at(own, name[done], (dur - child)[done])
        np.add.at(count, name[done], 1)
        return {self.names[i]: {"total_ns": int(total[i]),
                                "self_ns": int(own[i]),
                                "count": int(count[i])}
                for i in range(k) if count[i]}


_spans = _Spans()
_counts: dict[str, int] = {}


def span(name: str, scan: int = -1):
    """A context that records one span of ``name`` while tracing is on;
    ``scan``: the scan it belongs to (-1: its parent's)."""
    if not _on:
        return _NO_SPAN
    s = _spans
    s.next_name = s.intern(name)
    s.next_scan = scan
    return s


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the host counter ``name`` while tracing is on."""
    if _on:
        _counts[name] = _counts.get(name, 0) + k


_ran: dict[str, int] = {}


def ran(body: str) -> None:
    """Count one run of the conditional body ``body`` in ``run_if``'s
    plain version (a captured body counts its runs on the card)."""
    if _on:
        _ran[body] = _ran.get(body, 0) + 1


class StageClock:
    """One program's time by stage: (len(STAGES),) accumulated ns and
    stamps, and the time of the last stamp, in one int64 buffer on the
    program's device, which the captured graph's stamp nodes update."""

    def __init__(self, device):
        self.buf = torch.zeros(2 * len(STAGES) + 1, dtype=torch.int64,
                               device=device)

    def stamp(self, stage: int) -> None:
        from mcmh_localization_tpu_torch.ops.trace_stamp import trace_stamp

        trace_stamp(self.buf, stage, len(STAGES))


_clock: StageClock | None = None
_clocks: dict[tuple, StageClock] = {}


def stage_clock(label: str, device) -> StageClock:
    """The stage clock of the program ``label`` on ``device``, made at
    first use and kept for the process (a graph's nodes hold its
    address)."""
    key = (label, str(torch.device(device)))
    if key not in _clocks:
        _clocks[key] = StageClock(device)
    return _clocks[key]


@contextlib.contextmanager
def clocked(clock: StageClock | None):
    """Send the stamps of the steps run or captured inside to ``clock``
    (None: nowhere)."""
    global _clock
    prev, _clock = _clock, clock
    try:
        yield clock
    finally:
        _clock = prev


def stamp(stage: str) -> None:
    """Close ``stage`` of the running step on its stage clock, if any."""
    if _clock is not None:
        _clock.stamp(_STAGE[stage])


_taken_base: dict[int, torch.Tensor] = {}


def reset() -> None:
    """Clear the spans and counters; queue the zeroing of the stage clocks
    and a snapshot of the conditional bodies' counters, from which
    ``collect`` counts (``ops/_cuda.py::launch_counts`` reads the counters
    themselves, untouched)."""
    from mcmh_localization_tpu_torch.ops import _cuda

    _spans.clear()
    _counts.clear()
    _ran.clear()
    for c in _clocks.values():
        c.buf[:2 * len(STAGES)].zero_()
    _taken_base.clear()
    for taken, _ in _cuda.body_counters():
        _taken_base[id(taken)] = taken.clone()


def collect() -> dict:
    """Everything recorded since ``reset``, read with one wait on the card:
    ``{"spans": {name: {"total_ns", "self_ns", "count"}}, "counters":
    {name: k}, "stages": {program: {stage: {"ns", "count"}}}, "bodies":
    {body name: runs}}``."""
    from mcmh_localization_tpu_torch.ops import _cuda

    clocks = sorted(_clocks.items())
    replayed = _cuda.body_counters()
    parts = [c.buf[:2 * len(STAGES)] for _, c in clocks]
    for taken, _ in replayed:
        base = _taken_base.get(id(taken))
        parts.append(taken if base is None else taken - base)
    host = []
    if parts:
        dev = next((p.device for p in parts if p.is_cuda), parts[0].device)
        flat = torch.cat([p.to(dev) for p in parts]).cpu().numpy()
        at = 0
        for p in parts:
            host.append(flat[at:at + p.numel()])
            at += p.numel()
    s = len(STAGES)
    stages: dict[str, dict] = {}
    for ((label, _), _), v in zip(clocks, host):
        prog = stages.setdefault(label, {st: {"ns": 0, "count": 0}
                                         for st in STAGES})
        for i, st in enumerate(STAGES):
            prog[st]["ns"] += int(v[i])
            prog[st]["count"] += int(v[s + i])
    bodies = dict(_ran)
    for (_, names), v in zip(replayed, host[len(clocks):]):
        for name, runs in zip(names, v.tolist()):
            bodies[name] = bodies.get(name, 0) + int(runs)
    return {"spans": _spans.totals(), "counters": dict(_counts),
            "stages": stages, "bodies": bodies}


def records() -> dict:
    """The span records since ``reset``, as numpy columns: ``names`` (a
    list: a name id's name), ``name``, ``parent`` (-1 at the top),
    ``scan``, ``start_ns``, ``end_ns`` (-1 while open)."""
    return _spans.records()
