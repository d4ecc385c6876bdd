"""One run of one cell of the localizer's benchmark.

The cell names a configuration and a traffic mix (``BENCHMARK.json``); the
run makes the map and the traffic from the seed, builds the live entry
point ``filter/online.py::OnlineLocalizer`` on them and warms it up
(loading the kernels, capturing each program's step), settles it on the
first scans, then replays the stream closed-loop for the window: for each
scan, its odometry messages through ``on_odom`` and the scan's ranges,
from the host, through ``on_scan``, which returns the pose on the host.
With ``trace`` a profiled stretch of scans follows the window.  Then the
sampled scans are recomputed by the plain reference
(``reference/check.py``) and the metrics read by their readers
(``metrics/<name>.py``).
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from benchmark import profiled
from benchmark import world
from benchmark.reference import check
from benchmark.reference import filter as ref
from benchmark.traffic import generate

FORBIDDEN = ("jax", "jaxlib", "flax", "mcmh_localization_tpu")


class Cell(NamedTuple):
    name: str
    conf: dict         # configs/<config>.json
    traffic: dict      # traffic/<traffic>.json
    run: dict          # workloads/<name>.json
    map: dict          # maps/<map>.json
    end_to_end: list   # metric entries this cell reports untraced
    per_layer: list    # and traced


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files.
    ``overrides``: {"filter": {...}, "traffic": {...}, "run": {...},
    "map": map spec} merged over the files (the CPU tests' small sizes)."""
    spec = world.benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = world.load("configs", entry["config"])
    traffic = world.load("traffic", entry["traffic"])
    run = world.load("workloads", name)
    mp = world.load("maps", conf["map"])
    o = overrides or {}
    conf = {**conf, "filter": {**conf["filter"], **o.get("filter", {})}}
    if "staged" in o:
        conf["staged"] = o["staged"]
    return Cell(name, conf, {**traffic, **o.get("traffic", {})},
                {**run, **o.get("run", {})}, o.get("map", mp),
                [m for m in spec["end_to_end"] if _reports(m, name)],
                [m for m in spec["per_layer"] if _reports(m, name)])


class Pinned:
    """Host buffers for the state of one sampled scan, filled by copies on
    a side stream so the program's stream never waits for them."""

    def __init__(self, n_max: int, device):
        pin = device.type == "cuda"
        self.particles = torch.empty((n_max, 3), pin_memory=pin)
        self.weights = torch.empty(n_max, pin_memory=pin)
        self.f32 = torch.empty(5, pin_memory=pin)       # w_slow, w_fast, anchor
        self.i32 = torch.empty(2, dtype=torch.int32, pin_memory=pin)


class Sampler:
    """The sampled scans' records: the state before the scan's odometry,
    and the program's outputs and state after the scan."""

    def __init__(self, scans: set, n_max: int, small_cap: int | None,
                 device):
        self.scans = scans
        self.device = device
        self.side = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.free = [Pinned(n_max, device) for _ in range(2 * len(scans))]
        self.small_cap = small_cap
        self.pre = {}
        self.post = {}

    def program(self, n_max: int) -> str:
        if self.small_cap is None:
            return "single"
        return "small" if n_max == self.small_cap else "big"

    def _copy(self, st):
        """A host copy of ``st`` in a free buffer: (buffer, capacity)."""
        buf = self.free.pop()
        n = st.n_max
        srcs = [(buf.particles[:n], st.particles), (buf.weights[:n], st.weights),
                (buf.f32[0:1], st.w_slow.reshape(1)),
                (buf.f32[1:2], st.w_fast.reshape(1)),
                (buf.f32[2:5], st.anchor), (buf.i32[0:1], st.count.reshape(1)),
                (buf.i32[1:2], st.anchor_streak.reshape(1))]
        if self.side is not None:
            self.side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.side):
                for dst, src in srcs:
                    dst.copy_(src, non_blocking=True)
            for _, src in srcs:
                src.record_stream(self.side)
        else:
            for dst, src in srcs:
                dst.copy_(src)
        return buf, n

    def before(self, t: int, st, last_odom, msgs) -> None:
        gen = st.key.get_state()
        self.pre[t] = (*self._copy(st), gen,
                       np.asarray(last_odom, np.float32), msgs)

    def after(self, t: int, est: dict, info, st) -> None:
        gen = st.key.get_state()
        self.post[t] = (est, info, *self._copy(st), gen)

    def records(self) -> list:
        """The finished scans' records, on the host (the program's tensors
        read once, after the window)."""
        if self.side is not None:
            self.side.synchronize()
        out = []
        for t in sorted(self.post):
            buf, n, gen, last, msgs = self.pre[t]
            est, info, after, n_after, gen_after = self.post[t]
            cov = np.asarray(est["covariance"], np.float64)[list(check.COV_SLOTS)]
            k = int(after.i32[0])
            out.append(check.Record(
                scan=t, program=self.program(n),
                particles=buf.particles[:n].clone(),
                weights=buf.weights[:n].clone(),
                count=int(buf.i32[0]), w_slow=float(buf.f32[0]),
                w_fast=float(buf.f32[1]), anchor=buf.f32[2:5].clone(),
                streak=int(buf.i32[1]), gen_state=gen, last_odom=last,
                odom_msgs=msgs, pose=tuple(est["pose3"]),
                cov=cov.reshape(3, 3), ess=float(info.ess),
                accept_rate=float(info.accept_rate),
                out_count=int(info.count), p_random=float(info.p_random),
                anchor_mass=float(info.anchor_mass),
                w_fast_after=float(after.f32[1]),
                small_after=(None if self.small_cap is None
                             else n_after == self.small_cap),
                set_particles=after.particles[:k].clone(),
                set_weights=after.weights[:k].clone(),
                gen_after=gen_after))
        return out


def sample_scans(c: Cell, seed: int, first: int, seconds: float) -> set:
    """The window's scans the reference recomputes, drawn from the seed:
    ``check.scans`` of the first ``seconds x min_scans_per_s`` scans, and
    in a kidnap mix the first ``check.after_kidnap`` scans after
    ``check.kidnaps`` of the teleports among them."""
    chk = c.run["check"]
    rng = np.random.default_rng(generate.seeds(seed, 4)[3])
    span = max(int(seconds * chk["min_scans_per_s"]), chk["scans"])
    picked = set((first + rng.choice(span, chk["scans"], replace=False)).tolist())
    every = c.traffic.get("kidnap_every", 0)
    if every:
        settle = c.traffic["settle_scans"]
        jumps = [t for t in range(settle + every, first + span, every)
                 if t >= first]
        for t in rng.choice(jumps, min(chk["kidnaps"], len(jumps)),
                            replace=False).tolist():
            picked.update(range(t, t + chk["after_kidnap"]))
    return picked


def _messages(traffic: generate.Traffic) -> np.ndarray:
    """(T, k, 3) odometry messages before each scan (row 0 unused)."""
    k = traffic.odom_per_scan
    a, b = traffic.odom[:-1].astype(np.float64), traffic.odom[1:].astype(np.float64)
    f = (np.arange(1, k + 1) / k)[None, :, None]
    turn = generate.wrap(b[:, 2] - a[:, 2])
    xy = a[:, None, :2] + f * (b - a)[:, None, :2]
    th = generate.wrap(a[:, None, 2] + f[..., 0] * turn[:, None])
    out = np.concatenate([xy, th[..., None]], axis=2)
    return np.concatenate([np.zeros((1, k, 3)), out])


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, overrides: dict | None = None,
             log=lambda *a: print(*a, file=sys.stderr, flush=True),
             control: bool = False) -> dict:
    """One run; returns the result line's object.  ``control``: also put
    the reference in bfloat16 in the program's place, and return both
    sides' numbers under ``readings`` (the limits' readings; the
    benchmark's own runs do not)."""
    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.filter.online import OnlineLocalizer
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map

    device = torch.device(device)
    cuda = device.type == "cuda"
    c = cell(name, overrides)
    res, origin = c.map["resolution"], tuple(c.map["origin"])
    occ = world.occupancy(c.map)
    dist = world.distance(occ, res)
    settle = c.traffic["settle_scans"]
    n_prof = c.run["profiled_scans"] if traced else 0
    total = settle + 1 + int(seconds * c.run["max_scans_per_s"]) + n_prof
    phases = {"start": time.perf_counter() - t_start}
    traffic = generate.make(c.traffic, occ, dist, res, origin, total, seed,
                            device)
    msgs = _messages(traffic)
    fseed = generate.seeds(seed)[2]
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    phases["traffic"] = time.perf_counter() - t_start

    # the localizer's set-up: map, programs, warm-up (captures), settle
    gm = build_grid_map(occ, res, origin, device=device)
    staged = c.conf.get("staged") or {}
    loc = OnlineLocalizer(FilterConfig(**c.conf["filter"]), gm, seed=fseed,
                          initial_pose=tuple(map(float, traffic.gt[0])),
                          staged=bool(staged), **staged)
    phases["localizer"] = time.perf_counter() - t_start
    loc.warmup(traffic.ranges[0])
    phases["warmup"] = time.perf_counter() - t_start
    loc.on_odom(*map(float, traffic.odom[0]))
    for t in range(1, settle + 1):
        for m in msgs[t].tolist():
            loc.on_odom(*m)
        loc.on_scan(traffic.ranges[t])
    if cuda:
        torch.cuda.synchronize(device)
    progs = ref.programs(c.conf)
    small_cap = progs["small"].n_max if "small" in progs else None
    n_big = max(p.n_max for p in progs.values())
    first = settle + 1
    sampler = Sampler(sample_scans(c, seed, first, seconds), n_big, small_cap,
                      device)
    # the set-up's objects leave the collector's generations: the window's
    # collections then walk only what the window allocates
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    phases["settle"] = setup_s
    log("set-up (s since start, cumulative): " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()))

    attempted = failed = good = 0
    odom_s, scan_s, caps = [], [], []

    def one(t: int, spans: bool = False) -> None:
        nonlocal attempted, failed, good
        span = (torch.profiler.record_function if spans
                else lambda name: contextlib.nullcontext())
        row = msgs[t].tolist()
        if t in sampler.scans:
            sampler.before(t, loc.state, msgs[t - 1][-1] if t > 1
                           else traffic.odom[0], row)
        attempted += 1
        t0 = time.perf_counter()
        try:
            with span("bench.on_odom"):
                for m in row:
                    loc.on_odom(*m)
            t1 = time.perf_counter()
            with span("bench.on_scan"):
                est = loc.on_scan(traffic.ranges[t])
            t2 = time.perf_counter()
        except Exception as e:  # a scan that raised counts as failed
            failed += 1
            log(f"scan {t} raised {type(e).__name__}: {e}")
            return
        if est and np.all(np.isfinite(est["pose3"])):
            good += 1
        else:
            failed += 1
        odom_s.append(t1 - t0)
        scan_s.append(t2 - t1)
        caps.append(loc.state.n_max)
        if t in sampler.scans:
            sampler.after(t, est, loc.last_info, loc.state)

    # the window
    t = first
    w0 = time.perf_counter()
    while True:
        if t >= total - n_prof:
            raise RuntimeError(f"the traffic ran out at scan {t}: raise "
                               "max_scans_per_s in the workload file")
        one(t)
        t += 1
        if (time.perf_counter() - w0 >= seconds
                and t - first >= c.run.get("min_window_scans", 0)):
            break
    window_s = time.perf_counter() - w0
    done, n_win = good, len(scan_s)

    summary = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            if cuda:
                torch.cuda.synchronize(device)
            p0 = time.perf_counter()
            for _ in range(n_prof):
                one(t, spans=True)
                t += 1
            if cuda:
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - p0
        summary = profiled.summarize(prof, n_prof, wall)
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_reserved(device) if cuda else 0

    # what a metric reader reads (metrics/<name>.py::read(run))
    run = SimpleNamespace(
        window_s=window_s, scans=done, odom_s=np.asarray(odom_s[:n_win]),
        scan_s=np.asarray(scan_s[:n_win]), capacities=np.asarray(caps[:n_win]),
        n_big=n_big, small_cap=small_cap, setup_s=setup_s,
        memory_peak_bytes=peak, trace=summary, loc=loc, traffic=traffic,
        device=device, cuda=cuda)
    wanted = c.per_layer if traced else c.end_to_end
    metrics = {}
    for m in wanted:
        value = world.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the program's state goes before the reference runs
    records = sampler.records()
    del run, loc, sampler
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rmap = ref.make_map(occ, dist, res, origin, c.conf["filter"], device)
    angles = torch.linspace(-math.pi, math.pi, traffic.n_beams,
                            dtype=torch.float32, device=device)
    rmap16 = (ref.make_map(occ, dist, res, origin, c.conf["filter"], device,
                           torch.bfloat16) if control else None)
    rows, ctrl = [], []
    for rec in records:
        rec = rec._replace(particles=rec.particles.to(device),
                           weights=rec.weights.to(device),
                           anchor=rec.anchor.to(device))
        ranges = torch.from_numpy(traffic.ranges[rec.scan]).to(device)
        want = check.recompute(rec, c.conf, rmap, ranges, angles)
        rows.append(check.gaps(rec, want, c.conf))
        if control:
            low = check.recompute(rec, c.conf, rmap16, ranges, angles,
                                  torch.bfloat16)
            ctrl.append(check.gaps(check.control_record(rec, low, c.conf),
                                   want, c.conf))
    numbers = check.worst(rows)
    limits = world.load("reference/limits", c.name)
    correct, shown = check.judge(numbers, limits)
    correct = correct and len(rows) > 0 and failed == 0

    loaded = sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))
    if loaded:
        raise RuntimeError(f"modules that must not load were loaded: {loaded}")
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics}
    out["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s, window_s=summary.wall_s)
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps[:10]}
    if control:
        out["readings"] = {"program": numbers, "control": check.worst(ctrl),
                           "programs": [r.program for r in records]}
    out["checks"] = shown
    log(f"compared {len(rows)} sampled scans: {[r.scan for r in records]}")
    for k, (v, lim) in shown.items():
        log(f"check {k} {v!r} limit {lim!r}")
    return out
