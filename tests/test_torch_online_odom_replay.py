"""The odometry's replay path of the port's OnlineLocalizer, on the CPU.

On the card each ``on_odom`` message is one replay of a CUDA graph that
holds ``filter/captured.py::predict_in_place`` on the correct step's
buffers; the graphs themselves run only there (``chip_smoke.py``'s
``[online]`` phase).  Here: the captured function, run eagerly, against
the eager ``on_odom`` bitwise and under the host-read guard; the facade's
replay path with each graph's CPU stand-in (a replay runs the captured
body eagerly, drawing from the step's generator as a registered replay
does) against the eager facade bitwise, its copy-in rule through the
``odom_copy_in`` counter, and ``warmup`` after replays; the pose ring's
reuse rule on a fake event.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.filter import online  # noqa: E402
from mcmh_localization_tpu_torch.filter.captured import (  # noqa: E402
    STATE_TENSORS,
    CapturedStep,
    predict_in_place,
)
from mcmh_localization_tpu_torch.filter.online import OnlineLocalizer  # noqa: E402
from mcmh_localization_tpu_torch.filter.staged import (  # noqa: E402
    make_staged_model,
    shrink_state,
)
from mcmh_localization_tpu_torch.filter.state import copy_generator  # noqa: E402
from mcmh_localization_tpu_torch.filter.step import (  # noqa: E402
    FilterModel,
    make_model,
)
from mcmh_localization_tpu_torch.models.motion import compute_motion  # noqa: E402
from mcmh_localization_tpu_torch.utils import profiling  # noqa: E402
from tests.test_torch_compiled_run import _main_path_kw  # noqa: E402
from tests.test_torch_online import (  # noqa: E402
    ANGLES,
    STAGED,
    _advance,
    _scan,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401
from tests.torch_guard import no_host_reads  # noqa: E402

ODOM = ("particles", "prev_particles", "delta", "anchor")


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


def _program(name, torch_map):
    """(model, state) of the staged BIG and SMALL programs at CPU size
    (SMALL's state shrunk from BIG's), or ``FilterConfig()`` with its
    "reject" retries."""
    if name == "default":
        model = make_model(FilterConfig(), torch_map)
        return model, model.init(0)
    staged = make_staged_model(FilterConfig(**_main_path_kw()), torch_map,
                               tracking_capacity=4096,
                               tracking_ess_threshold=0.9)
    state = staged.big.init(0)
    if name == "big":
        return staged.big, state
    return staged.small, shrink_state(state, 4096)


def _messages(n=20):
    """``n`` odometry poses along a turning path, float32 as on_odom has
    them (the first only seeds)."""
    pose = np.array([1.0, 1.0, 0.4])
    out = [pose.astype(np.float32)]
    for k in range(n):
        pose = _advance(pose, 0.03 + 0.01 * (k % 3))
        pose[2] += 0.05 * np.sin(k)
        out.append(pose.astype(np.float32))
    return out


@pytest.mark.parametrize("program", ["big", "small", "default"])
def test_predict_in_place_matches_eager_on_odom(torch_map, program):
    """20 messages: ``predict_in_place`` on buffers from the poses equals
    the eager ``on_odom``'s predict (the delta from ``compute_motion`` on
    the host's float32 poses) bitwise after every message: the proposal,
    the previous set, the delta, the anchor and the generator's state."""
    model, state = _program(program, torch_map)
    if program == "default":
        assert model.config.motion_validity == "reject"
        assert model.config.motion_retries > 0
    buf = state.replace(**{f: getattr(state, f).clone()
                           for f in STATE_TENSORS},
                        key=copy_generator(state.key))
    poses = torch.zeros((2, 3))
    msgs = _messages()
    for prev, curr in zip(msgs, msgs[1:]):
        delta = compute_motion(torch.from_numpy(prev), torch.from_numpy(curr))
        state = model.predict(state, delta)
        poses.copy_(torch.from_numpy(np.stack([prev, curr])))
        predict_in_place(model, buf, poses)
        for f in ODOM:
            assert torch.equal(getattr(buf, f), getattr(state, f)), f
        assert torch.equal(buf.key.get_state(), state.key.get_state())
    for f in ("weights", "count", "w_slow", "w_fast", "anchor_streak"):
        assert torch.equal(getattr(buf, f), getattr(state, f)), f


@pytest.mark.parametrize("program", ["big", "small", "default"])
def test_predict_in_place_reads_nothing_on_the_host(torch_map, monkeypatch,
                                                    program):
    """The captured function reads no device value on the host: no gate,
    no count, the delta computed where the poses are."""
    model, state = _program(program, torch_map)
    poses = torch.from_numpy(np.stack(_messages(1)))
    with no_host_reads(monkeypatch):
        predict_in_place(model, state, poses)


class _EagerGraph:
    """A CUDA graph's CPU stand-in: a replay runs the captured body."""

    def __init__(self, body):
        self.replay = body


class _NoCapture:
    launches = [{}]

    def release(self):
        pass


def _use_eager_graphs(mp):
    """Every model replays its steps, each graph a ``_EagerGraph`` of the
    body the card's capture holds."""
    def capture(self):
        self.graph = _EagerGraph(self._scan_body)
        self.capture = _NoCapture()
        self.traced = profiling.enabled()

    def capture_odom(self):
        self.odom_graph = _EagerGraph(self._odom_body)
        self.odom_launches = {}

    mp.setattr(FilterModel, "replays_graph", property(lambda self: True))
    mp.setattr(CapturedStep, "_capture_graph", capture)
    mp.setattr(CapturedStep, "_capture_odom_graph", capture_odom)


@pytest.fixture
def eager_graphs(monkeypatch):
    _use_eager_graphs(monkeypatch)


def _staged(torch_map):
    """The facade tests' staged configuration at 36 field bins: it hands
    off to the 1024-slot program after its first scan."""
    return OnlineLocalizer(FilterConfig(**{**STAGED, "corr_n_theta": 36}),
                           torch_map, seed=0, staged=True,
                           tracking_capacity=1024, tracking_ess_threshold=0.9)


SCANS = 16
SAVE_AT = 4         # save_checkpoint after this scan
REINIT_AT = 8       # set_initial_pose before this scan's odometry
RELOAD_AT = 12      # load_checkpoint before this scan's odometry


def _drive(loc, house_map, path, warm=True, scans=SCANS):
    """The staged facade over ``scans`` scans of 3 messages, re-initialized
    and reloaded on the way.  Returns the snapshots after every message
    and scan (state tensors, generator state, capacity, estimate), and
    for every predicting message whether the state it started from had
    been replaced since the last replay (the start, a hand-off,
    ``set_initial_pose``, ``load_checkpoint``), with the odometry
    counters after it."""
    pose = np.array([1.0, -1.0, 0.0])
    if warm:
        loc.warmup(_scan(house_map, pose), ANGLES)
    loc.on_odom(*pose)
    snaps, msgs = [], []
    replaced = True

    def snap(est=None):
        st = loc.state
        snaps.append(({f: getattr(st, f).clone() for f in STATE_TENSORS},
                      st.key.get_state().clone(), st.n_max,
                      None if est is None else est["pose3"]))

    for t in range(scans):
        if t == REINIT_AT:
            loc.set_initial_pose(*pose, seed=3)
            loc.on_odom(*pose)
            replaced = True
        if t == RELOAD_AT:
            loc.load_checkpoint(path)
            loc.on_odom(*pose)
            replaced = True
        for _ in range(3):
            pose = _advance(pose, 0.04)
            loc.on_odom(*pose)
            msgs.append((replaced, dict(profiling.collect()["counters"])))
            replaced = False
            snap()
        n = loc.state.n_max
        snap(loc.on_scan(_scan(house_map, pose), ANGLES))
        replaced = loc.state.n_max != n
        if t == SAVE_AT:
            loc.save_checkpoint(path)
    return snaps, msgs


@pytest.fixture(scope="module")
def drives(house_map, torch_map, tmp_path_factory):
    """The eager facade's drive, then the replaying facade's (each graph's
    CPU stand-in) with tracing on for its counters."""
    tmp = tmp_path_factory.mktemp("odom")
    eager, _ = _drive(_staged(torch_map), house_map, str(tmp / "a.npz"))
    with pytest.MonkeyPatch.context() as m:
        _use_eager_graphs(m)
        profiling.enable()
        try:
            profiling.reset()
            loc = _staged(torch_map)
            replayed, msgs = _drive(loc, house_map, str(tmp / "b.npz"))
        finally:
            profiling.enable(False)
        assert loc._poses is not None and len(loc._odom_steps) == 2
    return eager, replayed, msgs


def test_replayed_on_odom_matches_eager_facade(drives):
    """The staged facade with its odometry replayed against the eager
    facade, bitwise after every message and scan over 16 scans with
    hand-offs, a re-initialization and a checkpoint's reload: the state,
    the generator, the program and the estimate."""
    eager, replayed, _ = drives
    sizes = [s[2] for s in eager]
    # BIG at the start and after the re-initialization, SMALL after each
    # hand-off
    assert sizes[0] == 2000 and 1024 in sizes
    assert 2000 in sizes[4 * REINIT_AT:4 * REINIT_AT + 4]
    for i, (a, b) in enumerate(zip(eager, replayed)):
        for f in STATE_TENSORS:
            assert torch.equal(a[0][f], b[0][f]), (i, f)
        assert torch.equal(a[1], b[1]), i
        assert a[2:] == b[2:], i


def test_copy_in_rule(drives):
    """``odom_copy_in`` counts a copy into the step's buffers exactly on
    the first predicting message after the state was replaced (the start,
    each hand-off, ``set_initial_pose``, ``load_checkpoint``) and on no
    message after a scan; every message is a replay once warmed."""
    _, _, msgs = drives
    prev = 0
    replaced = 0
    for i, (was_replaced, counts) in enumerate(msgs):
        copied = counts.get("odom_copy_in", 0) - prev
        prev = counts.get("odom_copy_in", 0)
        assert copied == int(was_replaced), i
        replaced += was_replaced
        assert counts.get("odom_replay", 0) == i + 1
        assert counts.get("odom_eager", 0) == 0
    # the start, two hand-offs, set_initial_pose, load_checkpoint
    assert replaced >= 5
    assert len(msgs) - replaced >= 40      # messages after a plain scan


def test_eager_until_captured(house_map, torch_map, tmp_path, eager_graphs):
    """Without ``warmup``, a message before its program's step was ever
    captured runs eagerly (``odom_eager``); once a scan has captured it,
    every message replays."""
    profiling.enable()
    try:
        profiling.reset()
        _, msgs = _drive(_staged(torch_map), house_map,
                         str(tmp_path / "d.npz"), warm=False, scans=4)
    finally:
        profiling.enable(False)
    eager = [c.get("odom_eager", 0) for _, c in msgs]
    # BIG's first scan's odometry, then SMALL's (handed off after it)
    assert eager == [1, 2, 3, 4, 5, 6, 6, 6, 6, 6, 6, 6]
    assert msgs[-1][1]["odom_replay"] == 6


def test_warmup_after_replays_leaves_state_and_stream(house_map, torch_map,
                                                      eager_graphs):
    """``warmup`` between replayed messages and the scan: the state (the
    step's buffers) and the generator (the step's) keep their values, and
    the localizer goes on as if it had not warmed."""
    runs = []
    for warm in (False, True):
        loc = _staged(torch_map)
        pose = np.array([1.0, -1.0, 0.0])
        scan = _scan(house_map, pose)
        loc.warmup(scan, ANGLES)
        loc.on_odom(*pose)
        for _ in range(3):
            pose = _advance(pose, 0.04)
            loc.on_odom(*pose)
        assert loc.state is loc._odom_steps[loc.model].buf
        before = ({f: getattr(loc.state, f).clone() for f in STATE_TENSORS},
                  loc.state.key.get_state().clone())
        if warm:
            loc.warmup(scan, ANGLES)
        for f in STATE_TENSORS:
            assert torch.equal(getattr(loc.state, f), before[0][f]), f
        assert torch.equal(loc.state.key.get_state(), before[1])
        for _ in range(3):
            pose = _advance(pose, 0.04)
            loc.on_odom(*pose)
        runs.append(loc.on_scan(_scan(house_map, pose), ANGLES)["pose3"])
    assert runs[0] == runs[1]


def test_cpu_path_stays_eager(house_map, torch_map):
    """On the CPU every predicting message is eager and no ring is made."""
    profiling.enable()
    try:
        profiling.reset()
        loc = _staged(torch_map)
        pose = np.array([1.0, -1.0, 0.0])
        loc.warmup(_scan(house_map, pose), ANGLES)
        for _ in range(4):
            loc.on_odom(*pose)
            pose = _advance(pose, 0.04)
        counts = profiling.collect()["counters"]
    finally:
        profiling.enable(False)
    assert counts.get("odom_eager") == 3 and "odom_replay" not in counts
    assert loc._poses is None and loc._ranges is None
    assert not loc._odom_steps


class _Event:
    def __init__(self, log, i):
        self.log, self.i = log, i

    def record(self):
        self.log.append(("record", self.i))

    def synchronize(self):
        self.log.append(("wait", self.i))


def test_ring_waits_on_the_oldest_slot_when_it_wraps(monkeypatch):
    """More messages than slots between two scans: each message past the
    ring's size waits on the event of the slot it takes, the oldest; after
    a scan's read (``drained``) no slot waits until the ring wraps again.
    Each copy carries what was written into its slot."""
    log = []
    made = []

    def event():
        made.append(_Event(log, len(made)))
        return made[-1]

    monkeypatch.setattr(online, "_Done", event)
    ring = online._PinnedRing(torch.device("cpu"), (2, 3), 4)
    dst = torch.zeros((2, 3))

    def send(k):
        prev = np.float32([k, 0, 0])
        curr = np.float32([k + 1, 1, 0.5])
        slot = ring.take()
        slot[0] = prev
        slot[1] = curr
        assert ring.send(dst) is dst
        assert torch.equal(dst, torch.from_numpy(np.stack([prev, curr])))

    for k in range(4):
        send(k)
    assert [e for e in log if e[0] == "wait"] == []
    for k in range(4, 7):
        send(k)
    assert [e for e in log if e[0] == "wait"] == [("wait", 0), ("wait", 1),
                                                  ("wait", 2)]
    assert log[-2:] == [("wait", 2), ("record", 2)]
    ring.drained()
    log.clear()
    for k in range(4):
        send(k)     # slots 3, 0, 1, 2: none waits
    assert [e for e in log if e[0] == "wait"] == []
    send(9)         # slot 3 again before a scan
    assert log[-2:] == [("wait", 3), ("record", 3)]
