"""The filter step captured in a CUDA graph: the port's counterpart of the
JAX package's compiled trajectory run (``make_run`` wraps the step in
``lax.scan`` so a whole trajectory compiles once and runs on device,
filter/step.py:872-882).

On a CUDA device, ``FilterModel.run`` replays one captured step per scan
for every config (``graph_capturable``), in any mode, resampler, ESS gate
and motion validity:

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
"""

from __future__ import annotations

import contextlib

import torch

from mcmh_localization_tpu_torch.filter.estimate import PoseEstimate
from mcmh_localization_tpu_torch.filter.state import FilterState, copy_generator
from mcmh_localization_tpu_torch.ops import _cuda
from mcmh_localization_tpu_torch.ops import graph as cgraph

# the scans one replay loop records before the record is copied out
MAX_SCANS = 64

STATE_TENSORS = ("particles", "prev_particles", "weights", "count", "w_slow",
                 "w_fast", "delta", "anchor", "anchor_streak")
# StepInfo's f32 scalars, packed in one record row after mean and cov
_INFO_SCALARS = ("ess", "accept_rate", "p_random", "w_slow", "w_fast",
                 "anchor_mass")


def graph_capturable(config) -> bool:
    """True for the configs whose step reads nothing on the host, so that
    ``FilterModel.run`` replays it as a CUDA graph on a CUDA device: every
    sensor model (the likelihood field in each scorer and window form, the
    beam model in every ``beam_impl``, the 3-D lidar); see the module
    docstring."""
    return config.sensor_model in ("likelihood_field", "beam", "lidar3d")


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class CapturedStep:
    """One scan of ``model`` (its ``step``, or ``correct`` alone with
    ``predict=False``) captured on the card for states of ``n_max`` slots
    and scans of ``beams`` ranges.  ``model`` is a ``FilterModel`` or a
    ``parallel/distributed.py::DistModel`` (whose step's collectives are
    captured too; every rank captures and replays the same graph)."""

    def __init__(self, model, state: FilterState, beams: int,
                 predict: bool = True):
        dev = model.device
        if dev.type != "cuda":
            raise ValueError("CapturedStep: the model must live on the card")
        if not model.replays_graph:
            raise ValueError("CapturedStep: this model does not replay a "
                             "captured step (its replays_graph is False)")
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
        self.deltas = torch.zeros((MAX_SCANS, 3), **f32)
        self.angles = None   # (beams,) or (beams, 2), set by the first run
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.record = torch.zeros((MAX_SCANS, 12 + len(_INFO_SCALARS)),
                                  **f32)
        self.counts = torch.zeros(MAX_SCANS, dtype=torch.int32, device=dev)
        self.graph = None
        # what one replay adds to the model's own tallies (the
        # collectives a DistModel's step calls), recorded at capture
        self.tallies = None

    def _capture(self) -> None:
        """Warm the step up eagerly on a throwaway copy of the state and
        the first scan's inputs, then capture it: on the card, capturing
        runs nothing."""
        model = self.model
        warm = self.buf.replace(
            **{f: getattr(self.buf, f).clone() for f in STATE_TENSORS},
            key=copy_generator(self.gen))
        tally = getattr(model, "tally", contextlib.nullcontext)
        sink = _cuda.set_sink({})   # the warm-up's launches are not the run's
        try:
            with tally():
                self._step(warm)
        finally:
            _cuda.set_sink(sink)
        torch.cuda.synchronize(model.device)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.register_generator_state(self.gen)
        # thread_local: a process group's watchdog thread may query its
        # events while this thread captures
        with (cgraph.capturing(model.device) as cap, tally() as tallies,
              torch.cuda.graph(g, capture_error_mode="thread_local")):
            new, info = self._step(self.buf)
            self._store(new)
            self._record(info)
        self.tallies = tallies
        self.capture = cap
        self.nodes = cgraph.node_counts(g.raw_cuda_graph())
        self.body_nodes = [cgraph.node_counts(b) for b in cap.bodies]
        g.instantiate()
        self.graph = g
        _cuda.add_replayed(cap.taken, cap.launches[1:])

    def _step(self, state: FilterState):
        """One scan on the inputs at the record's slot."""
        ranges = self.ranges.index_select(0, self.slot).reshape(self.beams)
        if self.predict:
            delta = self.deltas.index_select(0, self.slot).reshape(3)
            return self.model.step(state, ranges, self.angles, delta)
        return self.model.correct(state, ranges, self.angles)

    def _store(self, new: FilterState) -> None:
        """Copy the step's new state into the buffers: a field whose new
        value is another field's buffer first (prev_particles takes the
        buffer of particles), before that buffer is overwritten."""
        buf = self.buf
        order = sorted(STATE_TENSORS, key=lambda f: not any(
            _storage(getattr(new, f)) == _storage(getattr(buf, g))
            for g in STATE_TENSORS if g != f))
        for f in order:
            src, dst = getattr(new, f), getattr(buf, f)
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)

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
            if self.graph is None:
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
        cap = getattr(self, "capture", None)
        if cap is not None:
            self.graph = None   # the graph goes first, then its bodies' pool
            try:
                cap.release()
            except Exception:   # torch is already torn down at exit
                pass
