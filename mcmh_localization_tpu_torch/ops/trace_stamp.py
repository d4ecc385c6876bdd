"""The stage stamp of ``utils/profiling.py``: the CUDA kernel
``csrc/trace_stamp.cu`` (the card's global timer, a node of a captured
step) and its plain version on the CPU, where operations run in order on
the host and ``time.perf_counter_ns`` takes the timer's place.  The JAX
package has no counterpart: it times its step from outside."""

from __future__ import annotations

import time

import torch

from mcmh_localization_tpu_torch.ops import _cuda


def trace_stamp_plain(buf: torch.Tensor, stage: int, stages: int) -> None:
    now = time.perf_counter_ns()
    b = buf.numpy()
    if stage > 0:
        b[stage] += now - b[2 * stages]
    b[stages + stage] += 1
    b[2 * stages] = now


def trace_stamp(buf: torch.Tensor, stage: int, stages: int) -> None:
    """Close ``stage`` on the clock ``buf``, (2 * stages + 1,) int64: add
    the time since the last stamp to ``buf[stage]`` (not for stage 0,
    which opens a scan), 1 to ``buf[stages + stage]``, and keep the time
    in ``buf[2 * stages]``.  A CPU tensor takes the plain version."""
    if buf.dtype != torch.int64 or buf.shape != (2 * stages + 1,):
        raise ValueError("trace_stamp: buf must be (2 * stages + 1,) int64")
    if not 0 <= stage < stages:
        raise ValueError(f"trace_stamp: stage {stage} not in [0, {stages})")
    if buf.device.type == "cpu":
        trace_stamp_plain(buf, stage, stages)
        return
    _cuda.require_cuda("trace_stamp", buf)
    _cuda.check_launch("trace_stamp", _cuda.library().mcmh_trace_stamp(
        buf.data_ptr(), stage, stages, _cuda.stream_of(buf)))
