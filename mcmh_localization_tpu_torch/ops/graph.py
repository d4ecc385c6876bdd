"""Device control flow for the captured filter step: ``run_if``.

The JAX step makes its data-dependent choices on the device and pays
nothing for a branch it does not take: the injection ``lax.cond``
(filter/step.py:529), the ESS gate's 0/1-iteration ``while_loop``
(:719-752) and the KLD escalation's ``while_loop`` (ops/resampling.py:
425-464).  ``run_if(pred, body, carry)`` is the port's form of all three:

* while a step is being captured into a CUDA graph (``capturing``), the
  branch becomes an IF conditional node (``csrc/graph_cond.cu``): a
  one-thread kernel reads ``pred`` on the card and sets the node's handle,
  and the body's work, captured on a stream of its own into the node's
  body graph, runs on a replay only where ``pred`` holds;
* anywhere else (the CPU, a plain eager step on the card) the same call
  reads ``pred`` on the host and runs ``body`` behind an ``if``: the
  helper's plain version, as every kernel has one.

``run_always(body, carry)`` is a body with no gate, counted as a gated
one is.

Under tracing (``utils/profiling.py``) both forms count the runs of each
body by its function's name: the node's counter on the card, a host
counter in the plain version.

A body allocates from a memory pool of the capture's own (the step's
graph pool serves the capturing stream only), which lives as long as the
graph.  The wrappers' launch counts made while capturing go to the
capture's tally (``ops/_cuda.py``): the top level's and each body's, with
a counter on the card of the replays that ran the body.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from mcmh_localization_tpu_torch.ops import _cuda
from mcmh_localization_tpu_torch.utils import profiling

# the conditional nodes one capture may hold, and how deep they may nest
MAX_CONDS = 64
MAX_DEPTH = 4


class Capture:
    """One step's capture: the body streams (one for each nesting level),
    the pool the bodies allocate from, each conditional node's body graph,
    launches and taken counter."""

    def __init__(self, device: torch.device):
        self.device = device
        self.index = (device.index if device.index is not None
                      else torch.cuda.current_device())
        self.streams = [torch.cuda.Stream(device) for _ in range(MAX_DEPTH)]
        self.pool = torch.cuda.graph_pool_handle()
        self.taken = torch.zeros(MAX_CONDS, dtype=torch.int64, device=device)
        self.bodies: list[int] = []          # body graph handles
        self.names: list[str] = []           # each body's function name
        self.launches: list[dict] = [{}]     # 0: the top level, i + 1: body i
        self._stack: list = []               # open bodies: (stream ctx, sink)

    def begin(self, pred: torch.Tensor, name: str = "") -> None:
        """Add an IF node on ``pred`` after the work captured so far and
        capture what follows into its body, until ``end``."""
        depth = len(self._stack)
        slot = len(self.bodies)
        if depth >= MAX_DEPTH or slot >= MAX_CONDS:
            raise RuntimeError(
                f"run_if: more than {MAX_CONDS} conditional nodes or "
                f"{MAX_DEPTH} levels in one capture")
        parent = torch.cuda.current_stream(self.device)
        body_stream = self.streams[depth]
        out = ctypes.c_void_p()
        _cuda.check_launch("run_if", _cuda.library().mcmh_cond_begin(
            parent.cuda_stream, pred.data_ptr(),
            self.taken.data_ptr() + 8 * slot, body_stream.cuda_stream,
            ctypes.addressof(out)))
        self.bodies.append(out.value)
        self.names.append(name)
        self.launches.append({})
        if depth == 0:
            torch._C._cuda_beginAllocateToPool(self.index, self.pool)
        ctx = torch.cuda.stream(body_stream)
        ctx.__enter__()
        self._stack.append((ctx, _cuda.set_sink(self.launches[-1])))

    def end(self) -> None:
        ctx, sink = self._stack.pop()
        _cuda.set_sink(sink)
        body_stream = torch.cuda.current_stream(self.device)
        ctx.__exit__(None, None, None)
        code = _cuda.library().mcmh_cond_end(body_stream.cuda_stream)
        if not self._stack:
            torch._C._cuda_endAllocateToPool(self.index, self.pool)
        if code != 0:
            msg = _cuda.library().mcmh_error_string(code).decode()
            raise RuntimeError(f"run_if: ending the body's capture failed "
                               f"({code}: {msg})")

    def release(self) -> None:
        """Give the bodies' pool back; only once the graph is gone."""
        torch._C._cuda_releasePool(self.index, self.pool)


_active: Capture | None = None


@contextlib.contextmanager
def capturing(device: torch.device):
    """The bookkeeping ``run_if`` needs while a step is captured on
    ``device`` (inside ``torch.cuda.graph``): yields the ``Capture``, whose
    ``launches[0]`` is the top level's tally."""
    global _active
    if _active is not None:
        raise RuntimeError("ops.graph.capturing: a capture is under way")
    cap = Capture(device)
    sink = _cuda.set_sink(cap.launches[0])
    _active = cap
    try:
        yield cap
    finally:
        _active = None
        _cuda.set_sink(sink)


def _host_predicate(pred: torch.Tensor) -> bool:
    """The plain version's host read of the predicate: the one read of a
    device value that a step of a graph-capturable config makes (a
    ``host_sync`` to ``utils/profiling.py``)."""
    profiling.count("host_sync")
    return bool(pred)


def run_if(pred: torch.Tensor, body, carry: list, donate: bool = False
           ) -> list:
    """``body()`` where the 0-d bool ``pred`` holds, else ``carry``.

    ``body`` returns tensors of ``carry``'s shapes and dtypes.  Captured,
    the result is ``carry``'s tensors (or clones of them unless
    ``donate``: a donated carry is fresh, and nothing reads it but the
    result) with the body's results copied in by the body itself, so a
    replay that skips the body leaves ``carry``'s values.  A body makes no
    random draws: a replay advances the generator by the whole graph's
    draws, a skipped eager branch by none of the body's."""
    capturing_now = (pred.device.type == "cuda"
                     and torch.cuda.is_current_stream_capturing())
    if not capturing_now:
        if not _host_predicate(pred):
            return list(carry)
        profiling.ran(getattr(body, "__name__", ""))
        return list(body())
    cap = _active
    if cap is None:
        raise RuntimeError(
            "run_if: this capture was not started under ops.graph.capturing")
    pred = pred.reshape(()).to(torch.bool).contiguous()
    out = list(carry) if donate else [c.clone() for c in carry]
    cap.begin(pred, getattr(body, "__name__", ""))
    try:
        res = list(body())
        if len(res) != len(out):
            raise ValueError("run_if: body and carry differ in length")
        for o, r in zip(out, res):
            o.copy_(r)
    finally:
        cap.end()
    return out


def run_always(body, carry) -> list:
    """``body()``, a body that runs on every step, counted under tracing
    (``utils/profiling.py``) as ``run_if`` counts a body that ran: while a
    step is captured with tracing on, as the body of an IF node on a true
    predicate, whose counter counts the replays (``carry()`` gives the
    node's outputs, tensors of the body's shapes and dtypes); anywhere
    else, the call and the plain version's count.  With tracing off it is
    the call alone, captured or not."""
    if (profiling.enabled() and _active is not None
            and torch.cuda.is_current_stream_capturing()):
        out = carry()
        return run_if(torch.ones((), dtype=torch.bool, device=out[0].device),
                      body, out, donate=True)
    profiling.ran(getattr(body, "__name__", ""))
    return list(body())


# libcuda's CUgraphNodeType values that node_counts names
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 13: "conditional"}


def node_counts(graph: int) -> dict[str, int]:
    """A graph's own nodes by type (a conditional node's body is a graph
    of its own), read through libcuda (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``): the captured step's launches
    a replay (``ops/_cuda.py`` counts the wrappers' launches on the host,
    at capture and not at replay)."""
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    g = ctypes.c_void_p(graph)
    code = cu.cuGraphGetNodes(g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if code == 0:
        code = cu.cuGraphGetNodes(g, nodes, ctypes.byref(n))
    if code != 0:
        raise RuntimeError(f"node_counts: cuGraphGetNodes failed ({code})")
    counts = dict.fromkeys(list(_NODE_TYPES.values()) + ["other"], 0)
    kind = ctypes.c_int(0)
    for i in range(n.value):
        code = cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                     ctypes.byref(kind))
        if code != 0:
            raise RuntimeError(f"node_counts: cuGraphNodeGetType failed "
                               f"({code})")
        name = _NODE_TYPES.get(kind.value, "other")
        counts[name] += 1
    return counts
