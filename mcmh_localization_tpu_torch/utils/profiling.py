"""Profiling hooks: torch.profiler traces + wall-clock phase timers (port of
``mcmh_localization_tpu/utils/profiling.py``, where ``jax.profiler`` does
the tracing).

The reference has no profiling at all (SURVEY.md §5).  ``trace`` wraps
torch.profiler and writes a chrome trace; ``PhaseTimer`` accumulates
host-side wall-clock per named phase (ms/scan is a headline metric,
BASELINE.md).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

TRACE_FILE = "trace.json"


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


def annotate(name: str):
    """Named region that shows up in profiler traces
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a tensor, a sequence, a mapping
    or a NamedTuple/dataclass-like object of them."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    elif hasattr(tree, "__dataclass_fields__"):
        items = [getattr(tree, f) for f in tree.__dataclass_fields__]
    else:
        return set()
    return set().union(*(_cuda_devices(x) for x in items))


class PhaseTimer:
    """Accumulates wall-clock by phase; synchronizes the devices of the
    ``block_on`` tensors, so the measured time covers the actual
    computation, not dispatch."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in _cuda_devices(block_on):
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in self.totals
        }
