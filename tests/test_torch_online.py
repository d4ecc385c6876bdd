"""The port's OnlineLocalizer against the JAX facade's tests
(tests/test_online.py) at their sizes, on the CPU: the same configurations,
trajectories and gates, the scans ray-cast by the JAX package and fed to
both; plus the port's own rule: warmup works on a copy of the generator."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter.estimate import (  # noqa: E402
    covariance_6x6 as j_cov6,
)
from mcmh_localization_tpu.filter.online import (  # noqa: E402
    OnlineLocalizer as JOnline,
)
from mcmh_localization_tpu.models.sensor import raycast  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.filter.online import (  # noqa: E402
    OnlineLocalizer,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

ANGLES = np.linspace(-np.pi, np.pi, 90).astype(np.float32)
STAGED = dict(mode="AMHAMCL", num_particles=2000, min_particles=300,
              max_particles=2000, initialized=True,
              initial_pose=(1.0, -1.0, 0.0), max_range=5.0,
              likelihood_impl="corr", corr_n_theta=90, corr_window_cells=96,
              estimate_mode="cluster")
SINGLE = dict(mode="MHAMCL", num_particles=300, min_particles=50,
              max_particles=400, initialized=True,
              initial_pose=(1.0, -1.0, 0.0), max_range=5.0)


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


def _scan(house_map, pose):
    return np.asarray(raycast(jnp.asarray(pose[:2]), pose[2] + ANGLES,
                              house_map, 5.0, hit_unknown=True))


def _advance(pose, step=0.05):
    pose = pose + [step * np.cos(pose[2]), step * np.sin(pose[2]), 0.02]
    pose[2] = (pose[2] + np.pi) % (2 * np.pi) - np.pi
    return pose


def _track(loc, house_map, scans, odom_per_scan=3, step=0.05,
           pose=(1.0, -1.0, 0.0), on_odom_check=None):
    pose = np.array(pose)
    est = None
    for _ in range(scans):
        for _ in range(odom_per_scan):
            pose = _advance(pose, step)
            before = loc.state
            loc.on_odom(*pose)
            if on_odom_check is not None:
                on_odom_check(before, loc)
        est = loc.on_scan(_scan(house_map, pose), ANGLES)
    return pose, est


def _err(est, pose):
    return float(np.hypot(est["pose3"][0] - pose[0], est["pose3"][1] - pose[1]))


def test_online_localizer_tracks(house_map, torch_map):
    """Twin of test_online_localizer_tracks: 3 odometry updates per scan,
    30 scans, under 0.3 m at the end."""
    loc = OnlineLocalizer(FilterConfig(**SINGLE), torch_map, seed=0)
    pose, est = _track(loc, house_map, 30)
    assert _err(est, pose) < 0.3, (est["pose3"], pose)
    assert est["covariance"].shape == (36,)
    assert est["covariance"].dtype == np.float32
    parts, weights = loc.particles()
    assert parts.shape[1] == 3
    assert len(parts) == len(weights) == int(loc.state.count)


def test_online_quaternion_odom(torch_map):
    cfg = FilterConfig(mode="MCL", num_particles=100, initialized=True,
                       initial_pose=(1.0, -1.0, 0.5), max_range=5.0)
    loc = OnlineLocalizer(cfg, torch_map, seed=1)
    yaw = 0.5
    loc.on_odom_quaternion(1.0, -1.0, 0, 0, np.sin(yaw / 2), np.cos(yaw / 2))
    assert loc._last_odom is not None
    np.testing.assert_allclose(loc._last_odom[2], yaw, atol=1e-6)


def test_online_per_scan_batching_tracks(house_map, torch_map):
    """Twin of test_online_per_scan_batching_tracks: under "per_scan"
    on_odom dispatches nothing (the state object stays); both batchings
    track under 0.3 m."""
    def no_dispatch(before, loc):
        assert loc.state is before

    for batching in ("per_message", "per_scan"):
        cfg = FilterConfig(**SINGLE, predict_batching=batching)
        loc = OnlineLocalizer(cfg, torch_map, seed=0)
        pose, est = _track(loc, house_map, 30, on_odom_check=(
            no_dispatch if batching == "per_scan" else None))
        assert _err(est, pose) < 0.3, (batching, est["pose3"], pose)


def test_online_staged_tracks_and_shrinks(house_map, torch_map):
    """Twin of test_online_staged_tracks_and_shrinks: the facade hands off
    to the 1024-slot tracking program, tracks under 0.3 m, and a
    re-initialization returns to the big program."""
    loc = OnlineLocalizer(FilterConfig(**STAGED), torch_map, seed=0,
                          staged=True, tracking_capacity=1024,
                          tracking_ess_threshold=0.9)
    pose, est = _track(loc, house_map, 40, step=0.04)
    assert loc._in_small, "never handed off to the tracking program"
    assert loc.state.particles.shape[0] == 1024
    assert _err(est, pose) < 0.3, (est["pose3"], pose)
    loc.set_initial_pose(2.0, 1.0, 0.3)
    assert not loc._in_small
    assert loc.state.particles.shape[0] == 2000


def test_online_staged_checkpoint_resume(house_map, torch_map, tmp_path):
    """Twin of test_online_staged_checkpoint_resume: a checkpoint taken in
    the tracking program selects it on resume, and five more scans give
    the same estimates bitwise (the generator's state included); a
    capacity matching neither program is refused."""
    def make():
        return OnlineLocalizer(FilterConfig(**STAGED), torch_map, seed=0,
                               staged=True, tracking_capacity=1024,
                               tracking_ess_threshold=0.9)

    def drive(loc, pose, n):
        ests = []
        for _ in range(n):
            pose = _advance(pose, 0.04)
            loc.on_odom(*pose)
            ests.append(loc.on_scan(_scan(house_map, pose), ANGLES)["pose3"])
        return pose, np.array(ests)

    loc = make()
    pose, _ = drive(loc, np.array([1.0, -1.0, 0.0]), 35)
    assert loc._in_small  # checkpoint taken IN the tracking program
    path = str(tmp_path / "staged.npz")
    loc.save_checkpoint(path)
    _, est_a = drive(loc, pose.copy(), 5)

    loc2 = make()
    assert not loc2._in_small
    loc2.load_checkpoint(path)
    assert loc2._in_small and loc2.state.particles.shape[0] == 1024
    loc2.on_odom(*pose)  # odometry bookkeeping resets: re-seed it
    _, est_b = drive(loc2, pose.copy(), 5)
    np.testing.assert_array_equal(est_a, est_b)

    from mcmh_localization_tpu_torch.utils.checkpoint import save_state

    bad = str(tmp_path / "bad.npz")
    save_state(bad, loc.state.replace(
        particles=loc.state.particles[:512],
        prev_particles=loc.state.prev_particles[:512],
        weights=loc.state.weights[:512]))
    with pytest.raises(ValueError, match="neither"):
        loc2.load_checkpoint(bad)


def test_single_program_checkpoint_capacity_checked(torch_map, tmp_path):
    from mcmh_localization_tpu_torch.utils.checkpoint import save_state

    loc = OnlineLocalizer(FilterConfig(**SINGLE), torch_map, seed=0)
    bad = str(tmp_path / "bad.npz")
    save_state(bad, loc.state.replace(
        particles=loc.state.particles[:100],
        prev_particles=loc.state.prev_particles[:100],
        weights=loc.state.weights[:100]))
    with pytest.raises(ValueError, match="capacity"):
        loc.load_checkpoint(bad)


@pytest.mark.parametrize("staged", [False, True], ids=["single", "staged"])
def test_warmup_leaves_state_stream_and_cache(house_map, torch_map, staged):
    """Twin of test_online_warmup_no_mutation (after one scan, so the staged
    facade warms from the tracking program), and the port's own rule: the
    throwaway steps run on copies of the generator, so its state is the
    same after warmup (JAX reuses a key value there), and so is the
    estimate cache."""
    cfg = FilterConfig(**{**STAGED, "estimate_mode": "mean"})
    loc = OnlineLocalizer(cfg, torch_map, seed=0, staged=staged,
                          tracking_capacity=1024 if staged else None)
    scan = _scan(house_map, np.array([1.0, -1.0, 0.0]))
    loc.on_odom(1.0, -1.0, 0.0)
    est = loc.on_scan(scan, ANGLES)
    state_before = loc.state
    gen_before = loc.state.key.get_state().clone()
    odom_before = loc._last_odom
    in_small = staged and loc._in_small
    loc.warmup(scan, ANGLES)
    assert loc.state is state_before  # untouched, not just equal
    assert torch.equal(loc.state.key.get_state(), gen_before)
    assert loc._last_odom is odom_before
    assert loc.estimate() is est
    if staged:
        assert loc._in_small == in_small
        assert loc.state.particles.shape[0] == (1024 if in_small else 2000)
    # the facade still works normally after warming
    loc.on_odom(1.02, -1.0, 0.0)
    assert "pose3" in loc.on_scan(scan, ANGLES)


def test_warmup_matches_an_unwarmed_run(house_map, torch_map):
    """The stream is untouched: a localizer warmed first gives the same
    estimates, bitwise, as one that was not."""
    cfg = FilterConfig(**SINGLE)
    runs = []
    for warm in (False, True):
        loc = OnlineLocalizer(cfg, torch_map, seed=0)
        if warm:
            loc.warmup(_scan(house_map, np.array([1.0, -1.0, 0.0])), ANGLES)
        _, est = _track(loc, house_map, 4)
        runs.append(est["pose3"])
    assert runs[0] == runs[1]


def test_estimate_cached_and_packed(house_map, torch_map):
    """Twin of test_online_estimate_cached_and_packed: the cached dict, its
    host-side 6x6 packing equal to the port's and JAX's covariance_6x6 of
    the same covariance, and a new scan invalidating the cache."""
    from mcmh_localization_tpu_torch.filter.estimate import covariance_6x6

    cfg = FilterConfig(mode="MCL", num_particles=200, initialized=True,
                       initial_pose=(1.0, -1.0, 0.0), max_range=5.0)
    loc = OnlineLocalizer(cfg, torch_map, seed=0)
    pose = np.array([1.0, -1.0, 0.0])
    loc.on_odom(*pose)
    est = loc.on_scan(_scan(house_map, pose), ANGLES)
    assert loc.estimate() is est
    assert loc.estimate() is est
    cov = loc.last_info.estimate.cov
    np.testing.assert_array_equal(est["covariance"],
                                  covariance_6x6(cov).numpy())
    np.testing.assert_array_equal(est["covariance"],
                                  np.asarray(j_cov6(jnp.asarray(cov.numpy()))))
    loc.on_odom(*(pose + [0.05, 0.0, 0.0]))
    est2 = loc.on_scan(_scan(house_map, pose + [0.05, 0.0, 0.0]), ANGLES)
    assert est2 is not est
    assert loc.estimate() is est2


def test_reanchor_stream_matches_jax(house_map, torch_map):
    """The facade's map->odom broadcasts: one a scan once odometry has
    arrived, composing back to the estimate, and the same transform as the
    JAX facade's re-anchorer gives for the port's estimate."""
    from mcmh_localization_tpu.viz import TFReanchorer as JReanchorer
    from mcmh_localization_tpu_torch.viz import _pose_to_matrix

    cfg = FilterConfig(mode="MCL", num_particles=200, initialized=True,
                       initial_pose=(1.0, -1.0, 0.0), max_range=5.0)
    loc = OnlineLocalizer(cfg, torch_map, seed=0)
    loc.on_scan(_scan(house_map, np.array([1.0, -1.0, 0.0])), ANGLES)
    assert loc.reanchor.latest() is None
    pose = np.array([1.0, -1.0, 0.0])
    odom = np.zeros(3)
    jr = JReanchorer()
    for _ in range(5):
        for _ in range(3):
            step = np.array([0.05 * np.cos(pose[2]), 0.05 * np.sin(pose[2]),
                             0.02])
            pose, odom = pose + step, odom + step
            loc.on_odom(*odom)
            jr.on_odom(*odom)
        est = loc.on_scan(_scan(house_map, pose), ANGLES)
        want = jr.on_estimate(est["pose3"])
        assert loc.reanchor.latest() == want
    assert len(loc.reanchor.transforms) == 5
    t = loc.reanchor.latest()
    yaw_mo = 2 * np.arctan2(t["rotation"][2], t["rotation"][3])
    t_mb = (_pose_to_matrix(t["translation"][0], t["translation"][1], yaw_mo)
            @ _pose_to_matrix(*odom))
    assert abs(t_mb[0, 3] - est["pose3"][0]) < 1e-5
    assert abs(t_mb[1, 3] - est["pose3"][1]) < 1e-5


def test_set_initial_pose(torch_map):
    cfg = FilterConfig(mode="MCL", num_particles=100, initialized=True,
                       initial_pose=(1.0, -1.0, 0.0), max_range=5.0)
    loc = OnlineLocalizer(cfg, torch_map)
    loc.set_initial_pose(2.0, 1.0, 0.3)
    parts, _ = loc.particles()
    np.testing.assert_allclose(parts[:, 0].mean(), 2.0, atol=0.2)
    np.testing.assert_allclose(parts[:, 1].mean(), 1.0, atol=0.2)


def test_frame_recorder_is_refused(house_map, torch_map, tmp_path):
    """(The name is kept from when the facade refused a recorder.)  The
    facade's frame hook, the twin of test_sim_eval.py::
    test_frame_recorder_staged through the facade: a staged localizer
    given a viz.FrameRecorder renders every 4th scan and assembles a GIF;
    one set later through ``.frame_recorder`` renders too."""
    from mcmh_localization_tpu_torch.viz import FrameRecorder

    rec = FrameRecorder(torch_map, str(tmp_path / "frames"), every=4)
    loc = OnlineLocalizer(FilterConfig(**STAGED), torch_map, seed=0,
                          staged=True, tracking_capacity=1024,
                          tracking_ess_threshold=0.9, frame_recorder=rec)
    pose, est = _track(loc, house_map, 10, step=0.04)
    assert loc._in_small, "never handed off to the tracking program"
    assert np.all(np.isfinite(est["pose3"]))
    assert len(rec.frames) == -(-10 // 4) and len(rec.trail) == 10
    assert rec.to_gif() == str(tmp_path / "frames" / "run.gif")
    assert (tmp_path / "frames" / "run.gif").exists()
    later = FrameRecorder(torch_map, str(tmp_path / "later"))
    single = OnlineLocalizer(FilterConfig(**SINGLE), torch_map, seed=0)
    single.frame_recorder = later
    _track(single, house_map, 2)
    assert len(later.frames) == 2


def test_facade_parameters_match_jax():
    import inspect

    def params(cls, name):
        return [(p.name, p.default) for p in
                inspect.signature(getattr(cls, name)).parameters.values()]

    for name in ("__init__", "set_initial_pose", "warmup", "on_odom",
                 "on_odom_quaternion", "on_scan", "estimate", "particles",
                 "save_checkpoint", "load_checkpoint"):
        assert params(OnlineLocalizer, name) == params(JOnline, name), name
    assert JConfig().predict_batching == FilterConfig().predict_batching
