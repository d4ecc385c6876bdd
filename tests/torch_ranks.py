"""gloo CPU ranks for the port's multi-rank tests, and the jobs they run.

``RankPool(world, store_dir)`` spawns ``world`` processes that join one
gloo process group through a ``FileStore`` (every group has a timeout)
and then serve jobs: ``pool.run(job, *args)`` calls ``job(*args)`` on every
rank and returns the ranks' results in rank order.  A job that raises, or a
pool that does not answer within ``timeout`` seconds, fails the call and
ends the pool's processes, so a rank that skips a collective fails its
test instead of hanging the run.

This module and its jobs import torch and the port only, never jax: the
ranks are fresh interpreters that import it by name.  The jobs take and
return numpy arrays and plain values; the test files hold them to the JAX
package.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import traceback

import numpy as np

# a collective that a rank never joins fails after this many seconds
GROUP_TIMEOUT_S = 60


def _serve(rank: int, world: int, store_path: str, group_timeout: float,
           inbox, outbox) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=group_timeout))
    try:
        while True:
            job = inbox.get()
            if job is None:
                break
            fn, args = job
            try:
                outbox.put((rank, True, fn(*args)))
            except Exception:
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` spawned gloo ranks serving jobs (see the module doc)."""

    def __init__(self, world: int, store_dir, timeout: float = 300.0,
                 group_timeout: float = GROUP_TIMEOUT_S):
        ctx = mp.get_context("spawn")
        self.world = world
        self.timeout = timeout
        store = os.path.join(str(store_dir), f"store_{world}")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(world)]
        self._procs = [
            ctx.Process(target=_serve, daemon=True,
                        args=(r, world, store, group_timeout,
                              self._inboxes[r], self._outbox))
            for r in range(world)]
        for p in self._procs:
            p.start()

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(p.is_alive() for p in self._procs)

    def run(self, fn, *args, timeout: float | None = None) -> list:
        """``fn(*args)`` on every rank; the results in rank order."""
        if not self.alive:
            raise RuntimeError("the rank pool is closed")
        for box in self._inboxes:
            box.put((fn, args))
        results, errors = {}, []
        try:
            for _ in range(self.world):
                rank, ok, value = self._outbox.get(
                    timeout=timeout or self.timeout)
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            self.close(force=True)
            raise TimeoutError(
                f"{fn.__name__}: ranks {sorted(set(range(self.world)) - set(results))} "
                f"gave no answer in {timeout or self.timeout} s") from None
        if errors:
            self.close(force=True)
            raise AssertionError("\n".join(errors))
        return [results[r] for r in range(self.world)]

    def close(self, force: bool = False) -> None:
        if not force:
            for box in self._inboxes:
                box.put(None)
        for p in self._procs:
            p.join(timeout=0 if force else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = []


# ---------------------------------------------------------------------------
# helpers the jobs share
# ---------------------------------------------------------------------------

def _mesh():
    from mcmh_localization_tpu_torch.parallel.sharding import make_mesh

    return make_mesh()


def _map(m: dict):
    from mcmh_localization_tpu_torch.convert import grid_map_from_numpy

    return grid_map_from_numpy(m["occupancy"], m["resolution"], m["origin"],
                               distance=m["distance"], device="cpu")


def _cfg(kw: dict):
    from mcmh_localization_tpu_torch.config import FilterConfig

    return FilterConfig(**kw)


def _np(x):
    return x.detach().cpu().numpy()


def _infos(infos) -> dict:
    return {"mean": _np(infos.estimate.mean), "count": _np(infos.count),
            "ess": _np(infos.ess), "p_random": _np(infos.p_random),
            "anchor_mass": _np(infos.anchor_mass)}


def rank_of() -> tuple[int, int]:
    """(rank, world size): a job that checks the pool itself."""
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def _draws(d: dict | None):
    import torch

    from mcmh_localization_tpu_torch.filter.step import Draws

    if d is None:
        return None
    return Draws(**{k: None if v is None else torch.from_numpy(np.array(v))
                    for k, v in d.items()})


def _rows(x, rank: int, world: int):
    nl = x.shape[0] // world
    return x[rank * nl:(rank + 1) * nl]


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------

def sharded_steps(m, kw, scans, angles, deltas, jax_state, jax_draws):
    """``make_sharded_model`` on this rank: T steps beside ``make_model``'s
    on a copy of one generator (returns both rank blocks), then T steps
    from JAX's initial state on JAX's draws."""
    from mcmh_localization_tpu_torch.convert import state_from_numpy
    from mcmh_localization_tpu_torch.filter.state import copy_generator
    from mcmh_localization_tpu_torch.filter.step import make_model
    from mcmh_localization_tpu_torch.parallel.sharding import (
        make_sharded_model,
        shard_state,
    )

    mesh, gm, cfg = _mesh(), _map(m), _cfg(kw)
    single = make_model(cfg, gm)
    sharded = make_sharded_model(cfg, gm, mesh)
    s1 = single.init(0)
    s2 = shard_state(s1.replace(key=copy_generator(s1.key)), mesh)
    for t in range(scans.shape[0]):
        s1, i1 = single.step(s1, scans[t], angles, deltas[t])
        s2, i2 = sharded.step(s2, scans[t], angles, deltas[t])
    rank, world = rank_of()
    out = {"max_particles": sharded.config.max_particles,
           "single": {f: _np(_rows(getattr(s1, f), rank, world))
                      for f in ("particles", "prev_particles", "weights")},
           "sharded": {f: _np(getattr(s2, f))
                       for f in ("particles", "prev_particles", "weights")},
           "counts": (int(s1.count), int(s2.count)),
           "means": (_np(i1.estimate.mean), _np(i2.estimate.mean))}
    s3 = shard_state(state_from_numpy(jax_state, device="cpu"), mesh)
    for t in range(scans.shape[0]):
        s3, i3 = sharded.step(s3, scans[t], angles, deltas[t],
                              draws=_draws(jax_draws[t]))
    out["jax_draws"] = {"particles": _np(s3.particles), "count": int(s3.count),
                        "mean": _np(i3.estimate.mean)}
    return out


def sharded_init(m, kw, seed):
    """The rank's block and the replicated scalars of a sharded init."""
    from mcmh_localization_tpu_torch.parallel.sharding import make_sharded_model

    model = make_sharded_model(_cfg(kw), _map(m), _mesh())
    st = model.init(seed)
    return {"shape": tuple(st.particles.shape), "count": int(st.count),
            "weights": tuple(st.weights.shape),
            "max_particles": model.config.max_particles}


def sharded_run(m, kw, scans, angles, deltas, seed, steps_only=False):
    """A sharded run (``run``, or ``step`` a scan at a time): the infos and
    the rank's rows after it."""
    from mcmh_localization_tpu_torch.parallel.sharding import make_sharded_model

    model = make_sharded_model(_cfg(kw), _map(m), _mesh())
    st = model.init(seed)
    if steps_only:
        for t in range(scans.shape[0]):
            st, info = model.step(st, scans[t], angles, deltas[t])
        return {"mean": _np(info.estimate.mean),
                "rows": tuple(st.particles.shape)}
    st, infos = model.run(st, scans, angles, deltas)
    return {**_infos(infos), "rows": tuple(st.particles.shape),
            "max_particles": model.config.max_particles}


def dist_scan(m, kw, state_np, ranges, angles, delta, draws, log_field=None):
    """One ``_dist_step`` from a global state (numpy) on this rank's draws
    (``draws[rank]``); returns the rank's rows and the step's info."""
    import torch

    from mcmh_localization_tpu_torch.convert import state_from_numpy
    from mcmh_localization_tpu_torch.parallel.distributed import make_dist_model
    from mcmh_localization_tpu_torch.parallel.sharding import shard_state

    mesh = _mesh()
    model = make_dist_model(_cfg(kw), _map(m), mesh)
    if log_field is not None:
        model.log_field = torch.from_numpy(np.array(log_field))
    st = shard_state(state_from_numpy(state_np, device="cpu"), mesh)
    rank, _ = rank_of()
    st, info = model.step(st, ranges, angles, delta, draws=_draws(draws[rank]))
    return {"particles": _np(st.particles), "weights": _np(st.weights),
            "count": int(st.count), "anchor": _np(st.anchor),
            "mean": _np(info.estimate.mean),
            **{f: float(getattr(info, f)) for f in (
                "ess", "w_slow", "w_fast", "p_random", "anchor_mass",
                "accept_rate")}}


def dist_step_guarded(m, kw, ranges, angles, delta, w=None):
    """One ``make_dist_model`` step from ``init(0)`` (the augmented-MCL
    averages set to ``w`` = (w_slow, w_fast) when given) under the host-read
    guard (``tests/torch_guard.py``), and the same step unguarded on a copy
    of the rank's generator: whether every state and StepInfo field is
    ``torch.equal``, and the step's p_random and count."""
    import pytest
    import torch

    from mcmh_localization_tpu_torch.filter.captured import STATE_TENSORS
    from mcmh_localization_tpu_torch.filter.state import copy_generator
    from mcmh_localization_tpu_torch.parallel.distributed import make_dist_model
    from tests.torch_guard import no_host_reads

    model = make_dist_model(_cfg(kw), _map(m), _mesh())
    st = model.init(0)
    if w is not None:
        st = st.replace(w_slow=torch.tensor(w[0]), w_fast=torch.tensor(w[1]))
    eager, e_info = model.step(st.replace(key=copy_generator(st.key)),
                               ranges, angles, delta)
    mp = pytest.MonkeyPatch()
    try:
        with no_host_reads(mp):
            guarded, g_info = model.step(
                st.replace(key=copy_generator(st.key)), ranges, angles, delta)
    finally:
        mp.undo()
    same = all(torch.equal(getattr(eager, f), getattr(guarded, f))
               for f in STATE_TENSORS)
    same &= all(torch.equal(a, b) for a, b in (
        (e_info.estimate.mean, g_info.estimate.mean),
        (e_info.estimate.cov, g_info.estimate.cov), (e_info.ess, g_info.ess),
        (e_info.p_random, g_info.p_random), (e_info.count, g_info.count)))
    return {"equal": bool(same), "p_random": float(g_info.p_random),
            "count": int(g_info.count)}


def dist_track(m, kw, scans, angles, deltas, seed=0):
    """A ``make_dist_model`` run from ``init(seed)``: its infos."""
    from mcmh_localization_tpu_torch.parallel.distributed import make_dist_model

    model = make_dist_model(_cfg(kw), _map(m), _mesh())
    _, infos = model.run(model.init(seed), scans, angles, deltas)
    return _infos(infos)


def dist_track_lidar(vm, kw, scans, directions, deltas, seed=0):
    """``dist_track`` for the 3-D lidar on a voxel map's arrays (its nav
    slice at z = 0.1)."""
    from mcmh_localization_tpu_torch.convert import voxel_map_from_numpy
    from mcmh_localization_tpu_torch.maps.voxel_map import nav_slice
    from mcmh_localization_tpu_torch.parallel.distributed import make_dist_model

    room = voxel_map_from_numpy(vm["occupancy"], vm["distance"],
                                vm["resolution"], vm["origin"],
                                vm["max_distance"], device="cpu")
    model = make_dist_model(_cfg(kw), nav_slice(room, z=0.1), _mesh(),
                            voxel_map=room)
    _, infos = model.run(model.init(seed), scans, directions, deltas)
    return _infos(infos)


def dist_mixing(m, kw, parts, ranges, angles, steps):
    """The island-mixing run: each rank starts from its block of ``parts``
    and records the share of its rows within 0.5 m of (1, -1) after each
    step, with zero odometry."""
    import torch

    from mcmh_localization_tpu_torch.parallel.distributed import make_dist_model

    model = make_dist_model(_cfg(kw), _map(m), _mesh(),
                            migration_fraction=0.125)
    st = model.init(0)
    rank, world = rank_of()
    st = st.replace(particles=torch.from_numpy(_rows(parts, rank, world)))
    fracs = []
    for _ in range(steps):
        st, info = model.step(st, ranges, angles, torch.zeros(3))
        p = st.particles
        fracs.append(float((torch.hypot(p[:, 0] - 1.0, p[:, 1] + 1.0) < 0.5)
                           .float().mean()))
    return {"fracs": fracs, "mean": _np(info.estimate.mean)}


def dist_step_collectives(m, kw, ranges, angles, delta):
    """The collectives of one ``make_dist_model`` step (after one
    unrecorded step): (calls, bytes, largest call) per collective."""
    from mcmh_localization_tpu_torch.parallel import distributed

    model = distributed.make_dist_model(_cfg(kw), _map(m), _mesh())
    st, _ = model.step(model.init(0), ranges, angles, delta)
    distributed.reset_collective_counts()
    _, info = model.step(st, ranges, angles, delta)
    return {"counts": distributed.collective_counts(),
            "mean": _np(info.estimate.mean), "nl": model.nl}


def corr_stacks(m, kw, parts, ranges, angles, n_theta, window_origin=None):
    """Corr scores of this rank's rows of ``parts`` through the
    theta-sharded build, and the same rows of the local build's scores."""
    from mcmh_localization_tpu_torch.models.corr_field import (
        correlation_field_scores,
    )
    from mcmh_localization_tpu_torch.parallel import distributed

    import torch

    gm, cfg = _map(m), _cfg(kw)
    group = _mesh().get_group("data")
    rank, world = rank_of()
    parts = torch.from_numpy(parts)
    ranges, angles = torch.from_numpy(ranges), torch.from_numpy(angles)
    local = correlation_field_scores(parts, ranges, angles, gm, cfg,
                                     n_theta=n_theta,
                                     window_origin=window_origin)
    distributed.reset_collective_counts()
    sharded = correlation_field_scores(
        _rows(parts, rank, world), ranges, angles, gm, cfg, n_theta=n_theta,
        window_origin=window_origin, shard_bins_axis=group)
    return {"local": _np(_rows(local, rank, world)), "sharded": _np(sharded),
            "all_local": _np(local),
            "gathers": distributed.collective_counts().get("all_gather")}


def beam_stacks(m, kw, parts, ranges, angles, n_theta, window_origin):
    """``corr_stacks`` for the beam score field."""
    import torch

    from mcmh_localization_tpu_torch.models.range_table import (
        beam_field_scores,
        make_beam_tables,
    )
    from mcmh_localization_tpu_torch.parallel import distributed

    gm, cfg = _map(m), _cfg(kw)
    tables = make_beam_tables(gm, cfg)
    group = _mesh().get_group("data")
    rank, world = rank_of()
    parts = torch.from_numpy(parts)
    ranges, angles = torch.from_numpy(ranges), torch.from_numpy(angles)
    local = beam_field_scores(parts, ranges, angles, gm, cfg, tables, n_theta,
                              window_origin)
    distributed.reset_collective_counts()
    sharded = beam_field_scores(_rows(parts, rank, world), ranges, angles, gm,
                                cfg, tables, n_theta, window_origin,
                                shard_bins_axis=group)
    return {"local": _np(_rows(local, rank, world)), "sharded": _np(sharded),
            "all_local": _np(local),
            "gathers": distributed.collective_counts().get("all_gather")}


def staged_handoff(m, kw, parts, cap, pose):
    """The per-rank hand-off of ``make_staged_dist_model``: this rank's rows
    after shrink and after grow, and the program ``run_staged`` starts in
    from the shrunk state (one scan from ``pose``)."""
    import torch

    from mcmh_localization_tpu_torch.filter.staged import (
        make_staged_dist_model,
        run_staged,
    )
    from mcmh_localization_tpu_torch.filter.state import (
        make_generator,
        make_state,
    )
    from mcmh_localization_tpu_torch.models.sensor import raycast
    from mcmh_localization_tpu_torch.parallel.sharding import shard_state

    gm, cfg, mesh = _map(m), _cfg(kw), _mesh()
    staged = make_staged_dist_model(cfg, gm, mesh, tracking_capacity=cap)
    n_big = staged.config.max_particles
    st = shard_state(make_state(torch.from_numpy(parts), 256,
                                make_generator(0, "cpu"), n_big), mesh)
    small = staged.shrink(st)
    back = staged.grow(small)
    angles = torch.linspace(-np.pi, np.pi, 90)
    p = torch.tensor(pose, dtype=torch.float32)
    ranges = raycast(p[:2], p[2] + angles, gm, cfg.max_range, hit_unknown=True)
    out = run_staged(staged, small, ranges[None], angles, torch.zeros(1, 3),
                     chunk=1)
    return {"small": _np(small.particles), "back": _np(back.particles),
            "modes": out.modes.tolist(), "count": int(small.count)}


def staged_kidnap(m, kw, scans, angles, deltas, cap, seed):
    """A ``run_staged`` run of ``make_staged_dist_model``."""
    from mcmh_localization_tpu_torch.filter.staged import (
        make_staged_dist_model,
        run_staged,
    )

    staged = make_staged_dist_model(_cfg(kw), _map(m), _mesh(),
                                    tracking_capacity=cap)
    out = run_staged(staged, staged.init(seed), scans, angles, deltas,
                     chunk=8)
    return {"mean": _np(out.infos.estimate.mean), "modes": out.modes.tolist(),
            "switches": out.switches, "count": _np(out.infos.count)}


def zero_scan_runs(m, kw, angles):
    """The sharded and the distributed models' ``run`` over a zero-scan
    trajectory: each StepInfo field's (shape, dtype name), whether the
    state's tensors come back equal to the input and the generator
    unmoved."""
    import torch

    from mcmh_localization_tpu_torch.filter.captured import STATE_TENSORS
    from mcmh_localization_tpu_torch.filter.step import StepInfo
    from mcmh_localization_tpu_torch.parallel.distributed import make_dist_model
    from mcmh_localization_tpu_torch.parallel.sharding import make_sharded_model

    mesh = _mesh()
    out = {}
    for name, make in (("sharded", make_sharded_model),
                       ("dist", make_dist_model)):
        model = make(_cfg(kw), _map(m), mesh)
        st = model.init(0)
        key = st.key.get_state()
        new, infos = model.run(st, np.zeros((0, angles.shape[0]), np.float32),
                               angles, np.zeros((0, 3), np.float32))
        fields = {f: getattr(infos, f) for f in StepInfo._fields
                  if f != "estimate"}
        fields.update(mean=infos.estimate.mean, cov=infos.estimate.cov)
        out[name] = {
            "infos": {f: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
                      for f, x in fields.items()},
            "state_equal": all(torch.equal(getattr(new, f), getattr(st, f))
                               for f in STATE_TENSORS),
            "key_unmoved": bool(torch.equal(new.key.get_state(), key)),
        }
    return out


def dryrun(n_devices, device="cpu"):
    """``graft_entry.dryrun_multichip(n_devices, device)``; its
    RuntimeError's message when it raises."""
    from mcmh_localization_tpu_torch import graft_entry

    try:
        graft_entry.dryrun_multichip(n_devices, device=device)
    except RuntimeError as e:
        return str(e)
    return "ok"


def skip_collective():
    """Rank 0 enters a psum that no other rank joins."""
    import torch

    from mcmh_localization_tpu_torch.parallel.distributed import psum

    rank, _ = rank_of()
    if rank == 0:
        psum(torch.ones(1), None)
    return rank
