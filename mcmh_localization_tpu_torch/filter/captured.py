"""The filter step captured in a CUDA graph: the port's counterpart of the
JAX package's compiled trajectory run (``make_run`` wraps the step in
``lax.scan`` so a whole trajectory compiles once and runs on device,
filter/step.py:872-882).

On a CUDA device, ``FilterModel.run`` replays one captured step per scan
for every config, in any mode, resampler, ESS gate and motion validity:

* the likelihood-field "corr" scorer over the full map (the staged BIG
  program), a window without the coarse fallback (the staged SMALL
  program) or a window with it, gated or not (the single-program
  flagship): the window origin is a tensor that the field build and the
  lookups read from device memory, and the coarse build's escapee gate is
  a conditional node;
* the exact scorer, "jnp" and "pallas" ("auto" where it resolves to one
  of them), under motion_validity "score" or "reject";
* the beam model in every ``beam_impl``: the score field (its LUT matrix
  sized by the table's bins, ``ops/bin_lut.py``; its window read in
  place at the device-held origin, ``ops/beam_field.py::lut_field_at``;
  its coarse build's escapee gate a conditional node), the range table
  and the ray march;
* the 3-D lidar (``sensor_model="lidar3d"``).

Their steps read nothing on the host: every gate is a conditional node
(``ops/graph.py::run_if``).  The multi-device filter's ``DistModel.run``
replays its captured step the same way on an NCCL group, the collectives
inside the graph (``parallel/distributed.py``); on a gloo group it runs
on the CPU, eagerly.  The batched fleet (``parallel/batched.py``) runs
eager steps.  A capture or a replay that fails raises.

``CapturedStep`` holds the graph and its static buffers: the state (the
graph reads it and copies the step's new state back into it), the scans'
inputs for up to ``MAX_SCANS`` replays, and a (MAX_SCANS, ...) record of
each scan's StepInfo that the graph writes at the scan's slot, so a replay
never overwrites what an earlier one recorded.  A run copies the state in,
replays once per scan and copies the state out.  The random draws advance
on every replay: the graph is captured with its own generator registered
(``CUDAGraph.register_generator_state``), which takes the caller's
generator state before the replays and gives it back after them, so the
caller's stream moves as under eager steps, draw for draw.

A correct-only step (``predict=False``, the one ``OnlineLocalizer.on_scan``
replays) also serves the odometry: ``capture_odom`` captures one
message's device work, ``predict_in_place`` on the same buffers from the
two poses in ``poses`` (the delta, the proposal, the anchor's advance:
torch's draw and one kernel, ``ops/motion.py``), into the correct graph's
memory pool, drawing from the same registered generator.  The facade
makes the buffers hold its state (``load``: a copy only where they hold
another), copies the poses in and replays
(``replay_odom``); the state it then holds is the buffers themselves, the
generator included, so a scan's run copies nothing in.  Neither graph
leaves a live tensor in the pool (the buffers are allocated before both
captures), and both replay on one stream, so they share it.
"""

from __future__ import annotations

import contextlib
import weakref

import torch

from mcmh_localization_tpu_torch.filter.estimate import PoseEstimate
from mcmh_localization_tpu_torch.filter.state import FilterState, copy_generator
from mcmh_localization_tpu_torch.models.motion import compute_motion
from mcmh_localization_tpu_torch.ops import _cuda
from mcmh_localization_tpu_torch.ops import graph as cgraph
from mcmh_localization_tpu_torch.ops import motion
from mcmh_localization_tpu_torch.utils import profiling

# the scans one replay loop records before the record is copied out
MAX_SCANS = 64

STATE_TENSORS = ("particles", "prev_particles", "weights", "count", "w_slow",
                 "w_fast", "delta", "anchor", "anchor_streak")
# StepInfo's f32 scalars, packed in one record row after mean and cov
_INFO_SCALARS = ("ess", "accept_rate", "p_random", "w_slow", "w_fast",
                 "anchor_mass")


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _store(buf: FilterState, new: FilterState) -> None:
    """Copy a step's new state into the buffers ``buf``: a field whose new
    value is another field's buffer first (prev_particles takes the buffer
    of particles), before that buffer is overwritten."""
    order = sorted(STATE_TENSORS, key=lambda f: not any(
        _storage(getattr(new, f)) == _storage(getattr(buf, g))
        for g in STATE_TENSORS if g != f))
    for f in order:
        src, dst = getattr(new, f), getattr(buf, f)
        if src.data_ptr() != dst.data_ptr():
            dst.copy_(src)


def predict_in_place(model, buf: FilterState, poses: torch.Tensor) -> None:
    """One odometry message on the buffers ``buf``, in place: the delta
    between the (2, 3) ``poses`` (previous, current), ``model``'s motion
    step on it (drawing from ``buf.key``) and the new state written back
    (``ops/motion.py::predict_in_place``: on the card torch's draw and one
    kernel).  What ``CapturedStep.capture_odom`` captures; it equals
    ``model.predict`` on the delta followed by ``_store``, and eagerly the
    facade's eager ``on_odom`` with the delta computed where ``poses``
    lives."""
    motion.predict_in_place(buf, poses, model.config, model.grid_map)


class CapturedStep:
    """One scan of ``model`` (its ``step``, or ``correct`` alone with
    ``predict=False``) captured on the card for states of ``n_max`` slots
    and scans of ``beams`` ranges.  ``model`` is a ``FilterModel`` or a
    ``parallel/distributed.py::DistModel`` (whose step's collectives are
    captured too; every rank captures and replays the same graph)."""

    def __init__(self, model, state: FilterState, beams: int,
                 predict: bool = True):
        dev = model.device
        if not model.replays_graph:
            raise ValueError("CapturedStep: this model does not replay a "
                             "captured step (its replays_graph is False: "
                             "it must live on the card)")
        self.model = model
        self.predict = predict
        self.n_max = state.n_max
        self.beams = beams
        self.gen = copy_generator(state.key)
        self.buf = FilterState(
            **{f: getattr(state, f).clone() for f in STATE_TENSORS},
            key=self.gen)
        f32 = dict(dtype=torch.float32, device=dev)
        self.ranges = torch.zeros((MAX_SCANS, beams), **f32)
        # the predicts' deltas; a correct-only step takes an odometry
        # message's two poses instead (``replay_odom``)
        self.deltas = torch.zeros((MAX_SCANS, 3), **f32) if predict else None
        self.poses = None if predict else torch.zeros((2, 3), **f32)
        self.angles = None   # (beams,) or (beams, 2), set by the first run
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.record = torch.zeros((MAX_SCANS, 12 + len(_INFO_SCALARS)),
                                  **f32)
        self.counts = torch.zeros(MAX_SCANS, dtype=torch.int32, device=dev)
        self.graph = None
        self.odom_graph = None  # capture_odom's, its launches and nodes
        self.odom_launches: dict[str, int] = {}
        self.odom_nodes: dict[str, int] = {}
        # the state the buffers hold (``holds``): a weak reference, so a
        # run's result is not kept alive by the step
        self._held = None
        self._buf_ref = weakref.ref(self.buf)
        self.traced = False     # tracing was on at the capture
        # what one replay adds to the model's own tallies (the
        # collectives a DistModel's step calls), recorded at capture
        self.tallies = None

    def _capture(self) -> None:
        """Warm the step up eagerly on a throwaway copy of the state and
        the first scan's inputs, then capture it: on the card, capturing
        runs nothing.  With tracing on (``utils/profiling.py``), the
        step's stage stamps go into the graph, on the clock of the
        model's ``name``.  A step captured before drops its graphs first,
        and captures the odometry's again where it had one."""
        with profiling.span("graph.capture"):
            odom = self.odom_graph is not None
            self._drop_graph()
            self._capture_graph()
            if odom:
                self._capture_odom_graph()

    def _capture_graph(self) -> None:
        model = self.model
        warm = self.buf.replace(
            **{f: getattr(self.buf, f).clone() for f in STATE_TENSORS},
            key=copy_generator(self.gen))
        tally = getattr(model, "tally", contextlib.nullcontext)
        sink = _cuda.set_sink({})   # the warm-up's launches are not the run's
        try:
            with tally(), profiling.clocked(None):
                self._step(warm)
        finally:
            _cuda.set_sink(sink)
        torch.cuda.synchronize(model.device)
        traced = profiling.enabled()
        clock = (profiling.stage_clock(getattr(model, "name", "step"),
                                       model.device) if traced else None)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.register_generator_state(self.gen)
        # thread_local: a process group's watchdog thread may query its
        # events while this thread captures
        with (cgraph.capturing(model.device) as cap, tally() as tallies,
              profiling.clocked(clock),
              torch.cuda.graph(g, capture_error_mode="thread_local")):
            self._scan_body()
        self.tallies = tallies
        self.capture = cap
        self.nodes = cgraph.node_counts(g.raw_cuda_graph())
        self.body_nodes = [cgraph.node_counts(b) for b in cap.bodies]
        g.instantiate()
        self.graph = g
        self.traced = traced
        _cuda.add_replayed(cap.taken, cap.launches[1:], cap.names)

    def capture_odom(self) -> None:
        """Capture one odometry message (``predict_in_place`` on the
        buffers from ``poses``) into the correct graph's memory pool, with
        the same generator registered.  The correct step must be captured
        first."""
        if self.predict or self.graph is None:
            raise ValueError("CapturedStep.capture_odom: a correct-only "
                             "step, captured first")
        with profiling.span("graph.capture"):
            self._capture_odom_graph()

    def _capture_odom_graph(self) -> None:
        dev = self.model.device
        # the warm-up: the predict alone (it writes nothing in place) on a
        # copy of the generator
        sink = _cuda.set_sink({})   # the warm-up's launches are not the run's
        try:
            self.model.predict(self.buf.replace(key=copy_generator(self.gen)),
                               compute_motion(self.poses[0], self.poses[1]))
        finally:
            _cuda.set_sink(sink)
        torch.cuda.synchronize(dev)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.register_generator_state(self.gen)
        launches: dict[str, int] = {}
        sink = _cuda.set_sink(launches)
        try:
            with torch.cuda.graph(g, pool=self.graph.pool(),
                                  capture_error_mode="thread_local"):
                self._odom_body()
        finally:
            _cuda.set_sink(sink)
        self.odom_nodes = cgraph.node_counts(g.raw_cuda_graph())
        g.instantiate()
        self.odom_graph, self.odom_launches = g, launches

    def holds(self, state: FilterState) -> bool:
        """True where the buffers hold ``state``: the state a run of this
        step returned, or the buffers after an odometry replay, and no run
        on another state since."""
        return self._held is not None and self._held() is state

    def load(self, state: FilterState) -> bool:
        """Make the buffers and the generator hold ``state`` before an
        odometry replay: its tensors copied in where the buffers hold
        another state (returns True then), its generator's state taken
        where it is not the step's own."""
        copied = not self.holds(state)
        if copied:
            _store(self.buf, state)
        if state.key is not self.gen:
            self.gen.set_state(state.key.get_state())
        return copied

    def replay_odom(self) -> FilterState:
        """One replay of ``capture_odom``'s graph on the poses in
        ``poses``: the new state is the buffers, ``key`` the step's
        generator, advanced as by the eager predict."""
        self.odom_graph.replay()
        _cuda.add_launches(self.odom_launches)
        self._held = self._buf_ref
        return self.buf

    def _drop_graph(self) -> None:
        """The graphs go first, then the bodies' pool."""
        cap = getattr(self, "capture", None)
        self.odom_graph = None
        self.graph = None
        if cap is not None:
            self.capture = None
            cap.release()

    def _scan_body(self) -> None:
        """What the correct (or whole) step's graph holds: one scan on the
        buffers, its new state stored and its StepInfo recorded."""
        new, info = self._step(self.buf)
        _store(self.buf, new)
        self._record(info)

    def _odom_body(self) -> None:
        """What the odometry's graph holds."""
        predict_in_place(self.model, self.buf, self.poses)

    def _step(self, state: FilterState):
        """One scan on the inputs at the record's slot."""
        ranges = self.ranges.index_select(0, self.slot).reshape(self.beams)
        if self.predict:
            delta = self.deltas.index_select(0, self.slot).reshape(3)
            return self.model.step(state, ranges, self.angles, delta)
        return self.model.correct(state, ranges, self.angles)

    def _record(self, info) -> None:
        est = info.estimate
        row = torch.cat([est.mean.reshape(3), est.cov.reshape(9),
                         torch.stack([getattr(info, f) for f in
                                      _INFO_SCALARS]).to(torch.float32)])
        self.record.index_copy_(0, self.slot, row[None])
        self.counts.index_copy_(0, self.slot,
                                info.count.reshape(1).to(torch.int32))
        self.slot.add_(1)

    def _infos(self, t: int):
        from mcmh_localization_tpu_torch.filter.step import StepInfo

        rec = self.record[:t].clone()
        scalars = {f: rec[:, 12 + i].contiguous()
                   for i, f in enumerate(_INFO_SCALARS)}
        return StepInfo(
            estimate=PoseEstimate(mean=rec[:, :3].contiguous(),
                                  cov=rec[:, 3:12].reshape(t, 3, 3)),
            count=self.counts[:t].clone(), **scalars)

    def run(self, state: FilterState, ranges_seq: torch.Tensor,
            angles: torch.Tensor, deltas: torch.Tensor | None = None):
        """(final state, stacked StepInfo) of ``ranges_seq`` (T, beams)
        (and ``deltas`` (T, 3) when the step predicts) from ``state``,
        one replay a scan; ``state.key`` advances as under eager steps.
        A zero-scan trajectory captures and replays nothing: clones of
        the state and an empty StepInfo (``lax.scan`` of length 0)."""
        from mcmh_localization_tpu_torch.filter.step import (
            concat_infos,
            empty_infos,
        )

        if state.n_max != self.n_max or ranges_seq.shape[1] != self.beams:
            raise ValueError("CapturedStep.run: the state or scans do not "
                             "have the captured shapes")
        if ranges_seq.shape[0] == 0:
            return (state.replace(**{f: getattr(state, f).clone()
                                     for f in STATE_TENSORS}),
                    empty_infos(self.model.device))
        if self.angles is None:
            self.angles = angles.clone()
        else:
            self.angles.copy_(angles)
        for f in STATE_TENSORS:
            getattr(self.buf, f).copy_(getattr(state, f))
        self.gen.set_state(state.key.get_state())
        chunks = []
        for t0 in range(0, ranges_seq.shape[0], MAX_SCANS):
            t = min(MAX_SCANS, ranges_seq.shape[0] - t0)
            self.ranges[:t].copy_(ranges_seq[t0:t0 + t])
            if self.predict:
                self.deltas[:t].copy_(deltas[t0:t0 + t])
            self.slot.zero_()
            if self.graph is None or self.traced != profiling.enabled():
                self._capture()
            for _ in range(t):
                self.graph.replay()
            _cuda.add_launches(self.capture.launches[0], t)
            if self.tallies:
                self.model.add_tallies(self.tallies, t)
            chunks.append(self._infos(t))
        state.key.set_state(self.gen.get_state())
        out = state.replace(**{f: getattr(self.buf, f).clone()
                               for f in STATE_TENSORS})
        self._held = weakref.ref(out)
        return out, chunks[0] if len(chunks) == 1 else concat_infos(chunks)

    def scan(self, state: FilterState, ranges: torch.Tensor,
             angles: torch.Tensor, delta: torch.Tensor | None = None):
        """(new state, StepInfo) of one scan: ``run`` of a one-scan
        trajectory."""
        from mcmh_localization_tpu_torch.filter.step import StepInfo

        st, infos = self.run(state, ranges[None], angles,
                             None if delta is None else delta[None])
        info = StepInfo(
            estimate=PoseEstimate(mean=infos.estimate.mean[0],
                                  cov=infos.estimate.cov[0]),
            **{f: getattr(infos, f)[0] for f in StepInfo._fields
               if f != "estimate"})
        return st, info

    def launches_per_scan(self) -> dict[str, int]:
        """The graph's nodes of one replay: the top level's, and those of
        every conditional body (run only where its predicate holds)."""
        body = {k: sum(b[k] for b in self.body_nodes) for k in self.nodes}
        return {"top": dict(self.nodes), "bodies": body,
                "conditional_bodies": len(self.body_nodes)}

    def __del__(self):
        try:
            self._drop_graph()
        except Exception:   # torch is already torn down at exit
            pass
