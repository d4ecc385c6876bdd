"""The odometry message's motion step (``ops/motion.py``) on the CPU: its
plain version against the chain ``filter/step.py::_predict`` and
``filter/captured.py::predict_in_place`` were made of before it
(``compute_motion``, ``sample_motion``, ``advance_anchor``, ``_store``),
bit for bit, in both forms; the "reject" retries' cases; the in-place form
against the functional form followed by ``_store``; the plain version
against the JAX motion model on JAX's draws; the wrapper's device rule and
launch plan.  The kernel (``csrc/motion.cu``) is held to the plain version
on the card by ``chip_smoke.py``'s ``[motion]`` phase and by the CUDA case
here, which skips where there is no card."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.filter.captured import (  # noqa: E402
    STATE_TENSORS,
    _store,
    predict_in_place,
)
from mcmh_localization_tpu_torch.filter.state import (  # noqa: E402
    FilterState,
    copy_generator,
)
from mcmh_localization_tpu_torch.filter.step import _predict, make_model  # noqa: E402
from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map  # noqa: E402
from mcmh_localization_tpu_torch.models.motion import (  # noqa: E402
    advance_anchor,
    compute_motion,
    sample_motion,
)
from mcmh_localization_tpu_torch.ops import _cuda  # noqa: E402
from mcmh_localization_tpu_torch.ops import motion  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

ALPHA = (0.2, 0.3, 0.8, 0.2)
VALIDITY = {"score": dict(motion_validity="score"),
            "reject": dict(motion_validity="reject", motion_retries=4)}
POSES = ((1.0, 1.0, 0.4), (1.25, 1.12, -0.15))


def _config(validity, alpha=ALPHA):
    return FilterConfig(**dict(zip(("alpha1", "alpha2", "alpha3", "alpha4"),
                                   alpha)), **VALIDITY[validity])


@pytest.fixture(scope="module")
def tmap(house_occupancy):
    return build_grid_map(house_occupancy, 0.05, (-4.8, -4.8), device="cpu")


def _state(n, seed=3, device="cpu"):
    """n slots spread over the house (walls and the unknown band too, so
    every "reject" outcome occurs) with headings near the wrap."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 3), generator=g)
    parts = torch.stack([-4.6 + 9.2 * u[:, 0], -4.6 + 9.2 * u[:, 1],
                         math.pi * (2 * u[:, 2] - 1)], 1)
    f = dict(dtype=torch.float32, device=device)
    return FilterState(
        particles=parts.to(device), prev_particles=torch.zeros((n, 3), **f),
        weights=torch.full((n,), 1.0 / n, **f),
        count=torch.tensor(n, dtype=torch.int32, device=device),
        w_slow=torch.zeros((), **f), w_fast=torch.zeros((), **f),
        delta=torch.zeros(3, **f),
        anchor=torch.tensor([0.3, -0.2, 3.1], **f),
        anchor_streak=torch.zeros((), dtype=torch.int32, device=device),
        key=torch.Generator(device=device).manual_seed(seed + 1))


def _copy(state):
    return state.replace(**{f: getattr(state, f).clone()
                            for f in STATE_TENSORS},
                         key=copy_generator(state.key))


def _same(a, b) -> bool:
    return (all(torch.equal(getattr(a, f), getattr(b, f))
                for f in STATE_TENSORS)
            and torch.equal(a.key.get_state(), b.key.get_state()))


def _chain_predict(state, delta, config, grid_map):
    """``filter/step.py::_predict`` as it was before ``ops/motion.py``."""
    delta = torch.as_tensor(delta, dtype=torch.float32, device=state.device)
    proposed = sample_motion(
        state.particles, delta, config.alpha, generator=state.key,
        grid_map=grid_map,
        retries=(0 if config.motion_validity == "score"
                 else config.motion_retries))
    return state.replace(prev_particles=state.particles, particles=proposed,
                         delta=delta, anchor=advance_anchor(state.anchor, delta))


@pytest.mark.parametrize("form", ["delta", "poses"])
@pytest.mark.parametrize("validity", sorted(VALIDITY))
def test_plain_version_is_the_chain(tmap, validity, form):
    """The plain version bitwise the chain it replaced, its generator
    advanced alike: the delta form through ``_predict``, the poses form
    through ``predict_in_place`` against ``compute_motion``, the chain and
    ``_store`` on buffers."""
    config = _config(validity)
    state = _state(1003)
    poses = torch.tensor(POSES, dtype=torch.float32)
    got, want = _copy(state), _copy(state)
    if form == "delta":
        delta = compute_motion(poses[0], poses[1])
        src = got
        got = _predict(src, delta, tmap, config)
        want = _chain_predict(want, delta, config, tmap)
        assert got.prev_particles is src.particles
    else:
        predict_in_place(make_model(config, tmap), got, poses)
        _store(want, _chain_predict(
            want, compute_motion(poses[0], poses[1]), config, tmap))
    assert _same(got, want)
    assert not torch.equal(got.particles, state.particles)
    if validity == "reject":
        kept = (got.particles == state.particles).all(1)
        assert kept.any() and not kept.all()


# the "reject" cases of one slot at (1.05, 1.05 + 0.1 * row) on a map of
# 0.1 m cells that is occupied but for ``free`` (columns of the slot's
# row): delta (0, 0.5, rot2), alpha (0, 0, 1, 0), so candidate r moves the
# slot by 0.5 + 0.5 * z[r] along its heading and nothing else is noised;
# (heading, z, free columns, rot2, the candidate taken or None)
REJECT_CASES = {
    "none_free": (0.0, (0.0, 1.0, 2.0, 3.0), (), 0.0, None),
    "only_first_free": (0.0, (0.0, 1.0, 2.0, 3.0), (15,), 0.0, 0),
    "only_last_free": (0.0, (0.0, 1.0, 2.0, 3.0), (30,), 0.0, 3),
    # candidates 0 and 1 leave the map on either side, where the clamped
    # cells (columns 39 and 0) are free: out of the map is not free
    "out_of_map": (0.0, (100.0, -10.0, 1.0, 3.0), (0, 20, 39), 0.0, 2),
    # heading 3.1 plus rot2 0.1 wraps to -pi + 0.0584
    "theta_wrap": (3.1, (0.0, 1.0, 2.0, 3.0), (5,), 0.1, 0),
}


@pytest.mark.parametrize("case", sorted(REJECT_CASES))
def test_reject_cases(case):
    heading, z, free, rot2, taken = REJECT_CASES[case]
    row = 10
    occ = np.full((20, 40), 100, dtype=np.int8)
    occ[row, list(free)] = 0
    gm = build_grid_map(occ, 0.1, (0.0, 0.0), device="cpu")
    config = _config("reject", alpha=(0.0, 0.0, 1.0, 0.0))
    parts = torch.tensor([[1.05, 0.05 + 0.1 * row, heading]])
    noise = torch.zeros((4, 1, 3))
    noise[:, 0, 1] = torch.tensor(z)
    delta = torch.tensor([0.0, 0.5, rot2])
    state = FilterState(
        particles=parts, prev_particles=parts.clone(),
        weights=torch.ones(1), count=torch.tensor(1, dtype=torch.int32),
        w_slow=torch.zeros(()), w_fast=torch.zeros(()), delta=delta,
        anchor=parts[0].clone(), anchor_streak=torch.zeros((), dtype=torch.int32),
        key=torch.Generator())
    got, anchor = motion.predict(state, delta, config, gm, noise=noise)
    cands = [sample_motion(parts, delta, config.alpha, noise=noise[r])
             for r in range(4)]
    ok = [bool(gm.valid_mask(c)[0]) for c in cands]
    assert ok.index(True) == taken if taken is not None else not any(ok)
    assert torch.equal(got, parts if taken is None else cands[taken])
    assert torch.equal(anchor, advance_anchor(parts[0], delta))
    if case == "theta_wrap":
        th = float(got[0, 2])
        assert -math.pi <= th < -3.0
        assert float(cands[0][0, 0]) < 1.05 - 0.45


@pytest.mark.parametrize("validity", sorted(VALIDITY))
def test_in_place_is_functional_then_store(tmap, validity):
    """``predict_in_place`` on buffers equals ``_predict`` on the delta of
    the same poses followed by ``_store``: prev_particles, particles,
    delta, anchor and the generator, message after message."""
    config = _config(validity)
    model = make_model(config, tmap)
    a = _state(517, seed=5)
    b = _copy(a)
    pose = torch.tensor(POSES[0])
    for k in range(4):
        nxt = pose + torch.tensor([0.02, -0.01 * k, 0.05 * (-1) ** k])
        poses = torch.stack([pose, nxt])
        predict_in_place(model, a, poses)
        _store(b, _predict(b, compute_motion(poses[0], poses[1]), tmap,
                           config))
        assert _same(a, b), k
        pose = nxt


@pytest.mark.parametrize("validity", sorted(VALIDITY))
def test_plain_version_matches_jax(house_map, validity):
    """The plain version against the JAX motion model and its
    ``advance_anchor`` on JAX's own normals and delta.  cos/sin ulps can
    move a "reject" candidate across a cell edge: at most 0.1% of the slots
    may pick another draw; the rest agree to 2e-6."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from mcmh_localization_tpu.filter.step import advance_anchor as j_advance
    from mcmh_localization_tpu.models import motion as jmotion
    from mcmh_localization_tpu_torch.convert import grid_map_from_numpy

    gm = grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")
    config = _config(validity)
    r = motion.retries(config)
    state = _state(6000, seed=9)
    parts = state.particles.numpy()
    poses = np.float32(POSES)
    jdelta = jmotion.compute_motion(jnp.asarray(poses[0]), jnp.asarray(poses[1]))
    delta = compute_motion(torch.from_numpy(poses[0]), torch.from_numpy(poses[1]))
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), atol=1e-6)
    key = jax.random.PRNGKey(8)
    want = np.asarray(jmotion.sample_motion(
        key, jnp.asarray(parts), jdelta, ALPHA, house_map, retries=r,
        rng_impl="threefry"))
    noise = jax.random.normal(key, (parts.shape[0], 3) if r == 0
                              else (r, parts.shape[0], 3), jnp.float32)
    got, anchor = motion.predict_plain(
        state, torch.from_numpy(np.array(jdelta)), config, gm,
        noise=torch.from_numpy(np.array(noise)))
    d = np.abs(got.numpy() - want)
    d[:, 2] = np.minimum(d[:, 2], 2 * np.pi - d[:, 2])
    off = d.max(axis=1) > 2e-6
    assert off.mean() <= (1e-3 if r else 0.0), off.mean()
    np.testing.assert_allclose(
        anchor.numpy(), np.asarray(j_advance(jnp.asarray(state.anchor.numpy()),
                                             jdelta)), atol=2e-6)


@pytest.mark.parametrize("n", [4096, 5003])
@pytest.mark.parametrize("validity", sorted(VALIDITY))
def test_kernel_bitwise_the_plain_version_on_the_card(house_occupancy,
                                                      validity, n):
    """On a card: the kernel in both forms bitwise the plain version on
    the card's tensors, the generator advanced alike (n = 5003 runs the
    ragged last thread).  Skips where there is no card."""
    if not torch.cuda.is_available():  # decided here, never at import
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    dev = torch.device("cuda")
    gm = build_grid_map(house_occupancy, 0.05, (-4.8, -4.8), device=dev)
    config = _config(validity)
    state = _state(n, device=dev)
    poses = torch.tensor(POSES, dtype=torch.float32, device=dev)
    delta = compute_motion(poses[0], poses[1])
    a, b = _copy(state), _copy(state)
    got = motion.predict(a, delta, config, gm)
    want = motion.predict_plain(b, delta, config, gm)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(a.key.get_state(), b.key.get_state())
    a, b = _copy(state), _copy(state)
    motion.predict_in_place(a, poses, config, gm)
    motion.predict_in_place_plain(b, poses, config, gm)
    assert _same(a, b)


def _meta_state(n):
    meta = dict(dtype=torch.float32, device="meta")
    return FilterState(
        particles=torch.empty((n, 3), **meta),
        prev_particles=torch.empty((n, 3), **meta),
        weights=torch.empty((n,), **meta),
        count=torch.empty((), dtype=torch.int32, device="meta"),
        w_slow=torch.empty((), **meta), w_fast=torch.empty((), **meta),
        delta=torch.empty((3,), **meta), anchor=torch.empty((3,), **meta),
        anchor_streak=torch.empty((), dtype=torch.int32, device="meta"),
        key=torch.Generator())


class _Map:
    """A card map's fields the wrapper reads, on meta tensors."""

    free_mask = torch.empty((384, 384), dtype=torch.float32, device="meta")
    res = 0.05
    origin_xy = (-9.6, -9.6)


def _noise(n, config):
    r = motion.retries(config)
    return torch.empty((n, 3) if r == 0 else (r, n, 3), device="meta")


def test_wrapper_refuses_what_is_not_on_the_card(monkeypatch):
    """A tensor that is neither on the CPU nor on the card raises in both
    forms; the plain version never runs for it."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(motion, "predict_plain", plain)
    monkeypatch.setattr(motion, "predict_in_place_plain", plain)
    config = _config("reject")
    state = _meta_state(1000)
    with pytest.raises(ValueError, match="CUDA device"):
        motion.predict(state, state.delta, config, _Map(),
                       noise=_noise(1000, config))
    with pytest.raises(ValueError, match="CUDA device"):
        motion.predict_in_place(state, torch.empty((2, 3), device="meta"),
                                config, _Map(), noise=_noise(1000, config))


class _FakeLib:
    """csrc/motion.cu's entry point, recording each call."""

    def __init__(self):
        self.calls = []

    def mcmh_motion(self, args, stream):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("form", ["delta", "poses"])
@pytest.mark.parametrize("validity", sorted(VALIDITY))
@pytest.mark.parametrize("n", [5000, 100_000, 130_048, 1_000_000])
def test_wrapper_launches_one_kernel(monkeypatch, n, validity, form):
    """On a card's tensors (meta tensors and a stand-in library here) a
    message is one launch, counted as ``motion``, with none of the plain
    chain's functions: the functional form writes new tensors from the
    delta, the in-place form the state's own from the poses; R and the
    free mask under "reject" only."""
    config = _config(validity)
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    # the tensors by identity: meta tensors have no addresses
    monkeypatch.setattr(motion, "_ptr", lambda t: None if t is None else id(t))

    def forbidden(*a, **k):
        raise AssertionError("a plain chain function ran on the card path")

    for f in ("predict_plain", "predict_in_place_plain", "sample_motion",
              "compute_motion", "advance_anchor"):
        monkeypatch.setattr(motion, f, forbidden)
    state, gm = _meta_state(n), _Map()
    noise = _noise(n, config)
    poses = torch.empty((2, 3), device="meta")
    _cuda.reset_launch_counts()
    try:
        if form == "delta":
            out = motion.predict(state, state.delta, config, gm, noise=noise)
        else:
            out = motion.predict_in_place(state, poses, config, gm,
                                          noise=noise)
        launched = _cuda.launch_counts().get("motion", 0)
    finally:
        _cuda.reset_launch_counts()
    assert launched == 1 and len(lib.calls) == 1
    a = lib.calls[0]
    assert a.n == n and a.retries == motion.retries(config)
    assert a.noise == id(noise) and a.particles == id(state.particles)
    assert a.anchor == id(state.anchor)
    assert (a.free_mask == id(gm.free_mask)) == (validity == "reject")
    assert (a.h, a.w) == ((384, 384) if validity == "reject" else (0, 0))
    assert (a.res, a.origin_x) == (pytest.approx(0.05), pytest.approx(-9.6))
    assert [a.a1, a.a2, a.a3, a.a4] == pytest.approx(list(ALPHA))
    if form == "delta":
        proposed, anchor = out
        assert proposed.shape == (n, 3) and anchor.shape == (3,)
        assert (a.proposed, a.anchor_out) == (id(proposed), id(anchor))
        assert a.delta == id(state.delta) and a.poses is None
        assert a.prev_out is None and a.delta_out is None
    else:
        assert out is None
        assert a.poses == id(poses) and a.delta is None
        assert (a.proposed, a.prev_out, a.delta_out, a.anchor_out) == (
            id(state.particles), id(state.prev_particles), id(state.delta),
            id(state.anchor))


def test_wrapper_refuses_shapes_the_kernel_does_not_take(monkeypatch):
    """Noise of another shape than R gives, a delta that is not (3,) and
    poses that are not (2, 3) raise before any launch."""
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "library", lambda: pytest.fail("launched"))
    config = _config("reject")
    state = _meta_state(64)
    with pytest.raises(ValueError, match="noise has shape"):
        motion.predict(state, state.delta, config, _Map(),
                       noise=torch.empty((64, 3), device="meta"))
    with pytest.raises(ValueError, match="poses must be"):
        motion.predict(state, torch.empty((2, 3), device="meta"), config,
                       _Map(), noise=_noise(64, config))
    with pytest.raises(ValueError, match="poses must be"):
        motion.predict_in_place(state, torch.empty((3,), device="meta"),
                                config, _Map(), noise=_noise(64, config))


def test_smoke_phase_helpers_on_the_cpu():
    """``chip_smoke.py``'s ``[motion]`` helpers on the CPU: its states
    spread over the house give every "reject" outcome (the first
    candidate, a later one, none), the candidates a slot reads are counted
    up to its first free one, and a changed row or generator is named."""
    import chip_smoke as cs

    cpu = torch.device("cpu")
    half = cs.MAP_CELLS * cs.RES / 2
    gm = build_grid_map(cs.house_occupancy(), cs.RES, (-half, -half),
                        device=cpu)
    config = FilterConfig()
    state = cs.motion_state(2001, cpu, 4)
    poses = torch.tensor(cs.MOTION_POSES["long"])
    delta = compute_motion(poses[0], poses[1])
    noise = motion.draw_noise(cs.motion_copy(state), config)
    tried = cs.motion_tried(state, delta, config, noise, gm)
    assert ((tried == 1).any() and ((tried > 1) & (tried < 4)).any()
            and (tried == 4).any())
    got, _ = motion.predict(cs.motion_copy(state), delta, config, gm,
                            noise=noise)
    kept = (got == state.particles).all(1)
    assert kept.any() and bool((tried[kept] == 4).all())
    a, b = cs.motion_copy(state), cs.motion_copy(state)
    assert cs.motion_mismatch(a, b) == []
    a.particles[7, 1] += 1.0
    assert cs.motion_mismatch(a, b) == ["particles: 1 rows differ, first [7]"]
    pair = motion.predict(b, delta, config, gm, noise=noise)
    assert cs.motion_mismatch(pair, (pair[0], pair[1] + 1)) == [
        "anchor: 3 rows differ, first [0, 1, 2]"]


@pytest.mark.parametrize("validity", sorted(VALIDITY))
def test_raw_draw_is_written_over_its_normals(monkeypatch, validity):
    """On the card's path, where the wrapper draws the normals itself and
    the draw is raw, the proposal is written over them (one (n_max, 3)
    tensor a message); under "reject", and with normals handed in, the
    proposal is a tensor of its own."""
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(motion, "_ptr", lambda t: None if t is None else id(t))
    config = _config(validity)
    state = _meta_state(512)
    proposed, _ = motion.predict(state, state.delta, config, _Map())
    given = _noise(512, config)
    other, _ = motion.predict(state, state.delta, config, _Map(), noise=given)
    drawn, handed = lib.calls
    assert (drawn.proposed == drawn.noise) == (validity == "score")
    assert drawn.proposed == id(proposed) and proposed.shape == (512, 3)
    assert handed.noise == id(given) and handed.proposed == id(other) != id(given)
