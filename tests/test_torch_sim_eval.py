"""The port's simulator, bag files, evaluator, plots and experiment runner
against the JAX package's (tests/test_sim_eval.py), on the CPU: twins of
every JAX test there (the CLI twin passes ``--map``, a map written here, and
``--device cpu``), the same trajectories and placements, ray-cast scans
within one ray step on at most 2% of beams, the odometry noise on JAX's
derived seed, npz bags and results files that cross between the packages
bitwise, ``warmup_staged`` that leaves a run as it was, and whole-filter
parity: the RMSE of both packages on the same JAX-simulated bag."""

import argparse
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.eval import evaluator as jeval  # noqa: E402
from mcmh_localization_tpu.eval import runner as jrunner  # noqa: E402
from mcmh_localization_tpu.sim import bag as jbag  # noqa: E402
from mcmh_localization_tpu.sim import simulator as jsim  # noqa: E402
from mcmh_localization_tpu.sim import trajectory as jtraj  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.eval.evaluator import (  # noqa: E402
    evaluate_run,
    parse_poses_file,
    parse_results_file,
    save_results,
)
from mcmh_localization_tpu_torch.eval.runner import run_filter_on_bag  # noqa: E402
from mcmh_localization_tpu_torch.io.pgm import write_pgm  # noqa: E402
from mcmh_localization_tpu_torch.sim.bag import load_bag, save_bag  # noqa: E402
from mcmh_localization_tpu_torch.sim.simulator import (  # noqa: E402
    _noisy_odometry,
    odometry_deltas,
    simulate_bag,
)
from mcmh_localization_tpu_torch.sim.trajectory import (  # noqa: E402
    SCENARIOS,
    fit_trajectory_to_map,
    second_placement,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

SINGLE = dict(mode="MHAMCL", num_particles=300, min_particles=50,
              max_particles=400, initialized=True, max_range=5.0)
STAGED = dict(mode="AMHAMCL", num_particles=2048, min_particles=100,
              max_particles=2048, initialized=True, likelihood_impl="corr",
              corr_window_cells=48, estimate_mode="cluster")


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


@pytest.fixture(scope="module")
def small_bag(torch_map):
    """The JAX module's ``small_bag``, simulated by the port."""
    gt = SCENARIOS["square"](duration=10.0, rate=5.0)
    return simulate_bag(0, torch_map, gt, n_beams=90, max_range=5.0,
                        range_noise=0.01, name="square")


@pytest.fixture(scope="module")
def jax_small_bag(house_map):
    """The JAX module's ``small_bag`` itself."""
    gt = jtraj.SCENARIOS["square"](duration=10.0, rate=5.0)
    return jsim.simulate_bag(jax.random.PRNGKey(0), house_map, gt, n_beams=90,
                             max_range=5.0, range_noise=0.01, name="square")


def _write_map_yaml(path_dir, occ, resolution, origin) -> str:
    """A map_server YAML + PGM pair for a trinary occupancy grid."""
    img = np.where(occ == 0, 254, np.where(occ > 0, 0, 205)).astype(np.uint8)
    write_pgm(str(path_dir / "map.pgm"), img[::-1])
    (path_dir / "map.yaml").write_text(
        f"image: map.pgm\nresolution: {resolution}\n"
        f"origin: [{origin[0]}, {origin[1]}, 0.0]\nnegate: 0\n"
        "occupied_thresh: 0.65\nfree_thresh: 0.196\n")
    return str(path_dir / "map.yaml")


# ---------------------------------------------------------------------------
# trajectories and placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(jtraj.SCENARIOS))
def test_trajectories_shapes_and_wrap(name):
    """Twin of test_trajectories_shapes_and_wrap, and the same poses as
    JAX's generator, bitwise."""
    poses = SCENARIOS[name](duration=10.0, rate=5.0)
    assert poses.shape[1] == 3
    assert len(poses) >= 50
    assert (np.abs(poses[:, 2]) <= np.pi + 1e-6).all(), name
    np.testing.assert_array_equal(
        poses, jtraj.SCENARIOS[name](duration=10.0, rate=5.0))


def test_static_trajectory_is_static():
    poses = SCENARIOS["static"](duration=5.0, rate=5.0)
    assert np.allclose(poses, poses[0])


@pytest.mark.parametrize("name", list(jtraj.SCENARIOS))
def test_fit_trajectory_to_map_matches_jax(house_map, torch_map, name):
    gt = SCENARIOS[name](duration=10.0, rate=5.0)
    np.testing.assert_array_equal(
        fit_trajectory_to_map(torch_map, gt, min_clearance=0.15),
        jtraj.fit_trajectory_to_map(house_map, gt, min_clearance=0.15))


def test_second_placement_kidnap_legs(house_map, torch_map):
    """Twin of test_second_placement_kidnap_legs, with both legs equal to
    JAX's."""
    gt_a = fit_trajectory_to_map(
        torch_map, SCENARIOS["square"](duration=10.0, rate=5.0),
        min_clearance=0.15,
    )
    gt_b = second_placement(torch_map, gt_a, min_clearance=0.15, min_dist=2.0)
    np.testing.assert_array_equal(gt_b, jtraj.second_placement(
        house_map, gt_a, min_clearance=0.15, min_dist=2.0))
    shift = gt_b[:, :2] - gt_a[:, :2]
    assert np.allclose(shift, shift[0], atol=1e-5)
    assert np.allclose(gt_b[:, 2], gt_a[:, 2])
    assert np.hypot(*shift[0]) >= 2.0
    occ = torch_map.occupancy.numpy()
    dist = torch_map.distance.numpy()
    res = torch_map.res
    origin = torch_map.origin_xy
    cx = ((gt_b[:, 0] - origin[0]) / res).astype(int)
    cy = ((gt_b[:, 1] - origin[1]) / res).astype(int)
    assert (occ[cy, cx] == 0).all()
    assert (dist[cy, cx] >= 0.15).all()
    with pytest.raises(ValueError):
        second_placement(torch_map, gt_a, min_clearance=0.15, min_dist=1e6)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

def test_simulate_bag_shapes(small_bag):
    t, m = small_bag.ranges.shape
    assert m == 90
    assert small_bag.odom.shape == (t, 3)
    assert small_bag.gt.shape == (t, 3)
    assert small_bag.times.shape == (t,)
    assert np.all(small_bag.ranges <= 5.0 + 1e-5)
    assert np.all(small_bag.ranges > 0)
    for a in (small_bag.ranges, small_bag.angles, small_bag.odom,
              small_bag.gt, small_bag.times):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32


def test_odometry_drifts_but_tracks(small_bag):
    err = np.hypot(*(small_bag.odom[:, :2] - small_bag.gt[:, :2]).T)
    assert err[0] == 0
    assert err.max() < 0.5  # drifty but sane
    assert err[-1] > 0  # noise actually applied


def test_odometry_deltas_first_zero(small_bag):
    d = odometry_deltas(small_bag.odom)
    assert d.shape == (len(small_bag.times), 3)
    assert np.all(d[0] == 0)


def test_odometry_deltas_match_jax(jax_small_bag):
    for odom in (jax_small_bag.odom, jax_small_bag.gt):
        got = odometry_deltas(odom)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, jsim.odometry_deltas(odom), rtol=0,
                                   atol=1e-6)


def test_noisy_odometry_matches_jax_on_its_seed(jax_small_bag):
    """Given the integer JAX derives from its key, the port's odometry
    noise is JAX's: within 1e-5 m / rad (the per-step motion's ulps)."""
    k_odom, _ = jax.random.split(jax.random.PRNGKey(3))
    seed = int(np.asarray(jax.random.key_data(k_odom)).ravel()[-1])
    alpha = (0.002, 0.002, 0.01, 0.002)
    want = jsim._noisy_odometry(k_odom, jax_small_bag.gt, alpha)
    got = _noisy_odometry(seed, jax_small_bag.gt, alpha)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_simulate_bag_scans_match_jax(house_map, torch_map):
    """Noise-free scans: equal to JAX's per-pose raycast except one-step
    (0.02 m) differences on at most 2% of beams, where an ulp of cos/sin
    moves a ray sample across a cell edge; beam angles, truth and times as
    JAX's."""
    gt = jtraj.fit_trajectory_to_map(
        house_map, jtraj.SCENARIOS["straight_line_spin"](duration=8.0,
                                                         rate=5.0))
    want = jsim.simulate_bag(jax.random.PRNGKey(0), house_map, gt,
                             n_beams=90, max_range=5.0)
    got = simulate_bag(0, torch_map, gt, n_beams=90, max_range=5.0)
    diff = np.abs(got.ranges - want.ranges)
    assert diff.max() <= 0.02 + 1e-5
    assert (diff > 1e-5).mean() <= 0.02
    np.testing.assert_allclose(got.angles, want.angles, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.gt, want.gt)
    np.testing.assert_array_equal(got.times, want.times)
    assert got.meta == want.meta and got.max_range == want.max_range


def test_simulate_bag_seeds(torch_map):
    """An integer seed repeats; a generator is consumed (the odometry seed
    and the range noise drawn from it)."""
    gt = SCENARIOS["static"](duration=2.0, rate=5.0)
    gt = fit_trajectory_to_map(torch_map, gt)
    a = simulate_bag(7, torch_map, gt, n_beams=30, range_noise=0.01)
    b = simulate_bag(7, torch_map, gt, n_beams=30, range_noise=0.01)
    np.testing.assert_array_equal(a.ranges, b.ranges)
    np.testing.assert_array_equal(a.odom, b.odom)
    gen = torch.Generator().manual_seed(7)
    c = simulate_bag(gen, torch_map, gt, n_beams=30, range_noise=0.01)
    d = simulate_bag(gen, torch_map, gt, n_beams=30, range_noise=0.01)
    assert not np.array_equal(c.ranges, d.ranges)


# ---------------------------------------------------------------------------
# bag files and results files
# ---------------------------------------------------------------------------

def test_bag_roundtrip(tmp_path, small_bag):
    path = str(tmp_path / "bag.npz")
    save_bag(path, small_bag)
    back = load_bag(path)
    np.testing.assert_array_equal(back.ranges, small_bag.ranges)
    np.testing.assert_array_equal(back.odom, small_bag.odom)
    np.testing.assert_array_equal(back.gt, small_bag.gt)
    assert back.max_range == small_bag.max_range
    assert back.meta["name"] == "square"


def _assert_bags_equal(a, b):
    for f in ("ranges", "angles", "odom", "gt", "times"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.max_range == b.max_range and a.meta == b.meta


def test_bags_cross_load_between_packages(tmp_path, small_bag, jax_small_bag):
    """An npz bag saved by either package loads in the other, bitwise."""
    jbag.save_bag(str(tmp_path / "jax.npz"), jax_small_bag)
    _assert_bags_equal(load_bag(str(tmp_path / "jax.npz")), jax_small_bag)
    save_bag(str(tmp_path / "port.npz"), small_bag)
    _assert_bags_equal(jbag.load_bag(str(tmp_path / "port.npz")), small_bag)


def test_results_file_format(tmp_path):
    times = np.array([0.0, 0.2, 0.4])
    est = np.array([[0, 0, 0], [1, 1, 0.5], [2, 2, 1.0]], dtype=float)
    gt = est + 0.1
    r = evaluate_run(times, est, gt)
    path = save_results(r, "square_MCL_run0", str(tmp_path))
    text = open(path).read()
    # byte-format parity with evaluate_localization.py:120-125
    assert text.startswith("time,error\n")
    assert f"\nRMSE final: {r.rmse:.4f}\n" in text
    lines = text.splitlines()
    assert lines[1] == "0.000,0.1414"
    t2, est2, gt2 = parse_poses_file(str(tmp_path / "poses_square_MCL_run0.txt"))
    np.testing.assert_allclose(est2, est, atol=1e-4)
    np.testing.assert_allclose(gt2, gt, atol=1e-4)
    summary = open(tmp_path / "summary_results.txt").read()
    assert summary == f"square_MCL_run0.txt,{r.rmse:.4f}\n"
    t3, e3, rmse3 = parse_results_file(path)
    np.testing.assert_allclose(e3, r.errors, atol=1e-4)
    assert abs(rmse3 - r.rmse) < 1e-4


def test_results_files_byte_identical_to_jax(tmp_path, jax_small_bag):
    """The same run through both evaluators writes the same three files,
    byte for byte."""
    rng = np.random.default_rng(5)
    est = jax_small_bag.gt + rng.normal(0, 0.05, jax_small_bag.gt.shape)
    for tag, ev in (("port", None), ("jax", jeval)):
        out = tmp_path / tag
        for run in range(2):
            name = f"square_AMHAMCL_run{run}"
            if ev is None:
                save_results(evaluate_run(jax_small_bag.times, est + run,
                                          jax_small_bag.gt), name, str(out))
            else:
                ev.save_results(ev.evaluate_run(jax_small_bag.times, est + run,
                                                jax_small_bag.gt), name,
                                str(out))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 5
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes()), n


def test_plots_report(tmp_path):
    rng = np.random.default_rng(0)
    times = np.arange(20) * 0.2
    for algo in ("MCL", "AMHAMCL"):
        for run in range(2):
            est = np.cumsum(rng.normal(0, 0.05, size=(20, 3)), axis=0)
            gt = est + rng.normal(0, 0.05, size=(20, 3))
            r = evaluate_run(times, est, gt)
            save_results(r, f"square_{algo}_run{run}", str(tmp_path))
            save_results(r, f"square_{algo}_{250 * (run + 1)}p_run0", str(tmp_path))
    from mcmh_localization_tpu_torch.eval.plots import (
        collect_runs,
        collect_sweep,
        plot_rmse_report,
        plot_sweep_report,
    )

    runs = collect_runs(str(tmp_path))
    assert set(runs) == {("square", "MCL"), ("square", "AMHAMCL")}
    assert all(len(v) == 2 for v in runs.values())
    sweep = collect_sweep(str(tmp_path))
    assert ("square", "MCL", 250) in sweep and ("square", "AMHAMCL", 500) in sweep

    from PIL import Image

    os.makedirs(tmp_path / "frames", exist_ok=True)
    Image.new("RGB", (8, 8)).save(tmp_path / "frames" / "run.gif")

    html = plot_rmse_report(str(tmp_path))
    assert os.path.exists(html)
    assert os.path.exists(tmp_path / "plots" / "square_error_vs_time.png")
    text = open(html).read()
    assert "run.gif" in text and "live run" in text
    html2 = plot_sweep_report(str(tmp_path))
    assert os.path.exists(html2)


# ---------------------------------------------------------------------------
# runs on bags
# ---------------------------------------------------------------------------

def test_full_run_on_bag(small_bag, torch_map):
    cfg = FilterConfig(initial_pose=tuple(map(float, small_bag.gt[0])),
                       **SINGLE)
    est, infos, wall = run_filter_on_bag(small_bag, cfg, torch_map, 1)
    result = evaluate_run(small_bag.times, est, small_bag.gt)
    assert result.rmse < 0.5
    assert len(result.errors) == len(small_bag.times)
    assert infos.ess.shape == (len(small_bag.times),) and wall > 0


def test_run_filter_on_bag_warmup_keeps_the_draws(small_bag, torch_map):
    """The warmup step runs on a copy of the generator: the estimates are
    those of a run without it, bitwise."""
    cfg = FilterConfig(initial_pose=tuple(map(float, small_bag.gt[0])),
                       **SINGLE)
    a, _, _ = run_filter_on_bag(small_bag, cfg, torch_map, 2, warmup=True)
    b, _, _ = run_filter_on_bag(small_bag, cfg, torch_map, 2, warmup=False)
    np.testing.assert_array_equal(a, b)


def test_whole_filter_parity_on_a_jax_bag(tmp_path, house_map, torch_map,
                                          jax_small_bag):
    """The North star's whole-filter parity: the JAX-simulated small_bag,
    saved by JAX and loaded by the port, run by both packages with MHAMCL
    300 / 50 / 400 on seeds 1-4.  Each run under 0.1 m; the two mean RMSEs
    within 0.025 m (the draws differ, so the runs agree in statistics)."""
    path = str(tmp_path / "bag.npz")
    jbag.save_bag(path, jax_small_bag)
    bag = load_bag(path)
    pose0 = tuple(map(float, bag.gt[0]))
    jcfg = JConfig(initial_pose=pose0, **SINGLE)
    tcfg = FilterConfig(initial_pose=pose0, **SINGLE)
    rmse = {"jax": [], "port": []}
    for seed in (1, 2, 3, 4):
        est, _, _ = jrunner.run_filter_on_bag(jax_small_bag, jcfg, house_map,
                                              jax.random.PRNGKey(seed))
        rmse["jax"].append(jeval.evaluate_run(bag.times, est, bag.gt).rmse)
        est, _, _ = run_filter_on_bag(bag, tcfg, torch_map, seed)
        rmse["port"].append(evaluate_run(bag.times, est, bag.gt).rmse)
    print(f"whole-filter RMSE (m), seeds 1-4: {rmse}")
    for tag, vals in rmse.items():
        assert max(vals) < 0.1, (tag, vals)
    assert abs(np.mean(rmse["jax"]) - np.mean(rmse["port"])) <= 0.025, rmse


def test_drive_bag_command_stream(torch_map):
    """Twin of test_drive_bag_command_stream: a closed-loop controller
    drives, walls stop translation, and the bag feeds the filter."""
    from mcmh_localization_tpu_torch.sim.simulator import drive_bag

    def ctrl(t, pose):
        return (0.25, 0.6 if (t % 3) < 1.0 else 0.0)

    bag = drive_bag(0, torch_map, ctrl, duration=6.0, rate=5.0,
                    start_pose=(1.0, -1.0, 0.0), n_beams=90)
    assert bag.ranges.shape == (30, 90)
    assert np.ptp(bag.gt[:, 0]) > 0.2
    cmds = np.tile([[1.0, 0.0]], (40, 1))
    bag_wall = drive_bag(1, torch_map, cmds, start_pose=(1.0, -1.0, 0.0),
                         n_beams=30)
    assert np.all(np.isfinite(bag_wall.gt))
    d = torch_map.distance.numpy()
    res = torch_map.res
    for x, y, _ in bag_wall.gt:
        mx = int((x - torch_map.origin_xy[0]) / res)
        my = int((y - torch_map.origin_xy[1]) / res)
        assert d[my, mx] >= 0.15 - 1e-6
    cfg = FilterConfig(mode="MCL", num_particles=300, initialized=True,
                       initial_pose=(1.0, -1.0, 0.0), max_range=5.0)
    est, infos, wall = run_filter_on_bag(bag, cfg, torch_map, 2)
    errs = np.hypot(est[:, 0] - bag.gt[:, 0], est[:, 1] - bag.gt[:, 1])
    assert errs[-1] < 0.4, errs[-5:]


def test_drive_bag_truth_matches_jax(house_map, torch_map):
    """The same commands drive the same ground truth in both packages."""
    from mcmh_localization_tpu.sim.simulator import drive_bag as jdrive
    from mcmh_localization_tpu_torch.sim.simulator import drive_bag

    cmds = np.tile([[1.0, 0.4]], (25, 1))
    got = drive_bag(0, torch_map, cmds, start_pose=(1.0, -1.0, 0.0), n_beams=8)
    want = jdrive(jax.random.PRNGKey(0), house_map, cmds,
                  start_pose=(1.0, -1.0, 0.0), n_beams=8)
    np.testing.assert_array_equal(got.gt, want.gt)


def test_frame_recorder_live_view(small_bag, torch_map, tmp_path):
    from mcmh_localization_tpu_torch.eval.runner import _run_with_frames

    cfg = FilterConfig(mode="MCL", num_particles=200, initialized=True,
                       initial_pose=tuple(map(float, small_bag.gt[0])),
                       max_range=small_bag.max_range)
    args = argparse.Namespace(save_frames=str(tmp_path / "frames"),
                              frame_every=3)
    est, infos, wall = _run_with_frames(small_bag, cfg, torch_map, 0, args)
    frames = sorted(os.listdir(tmp_path / "frames"))
    pngs = [f for f in frames if f.endswith(".png")]
    assert len(pngs) == -(-len(small_bag.times) // 3)
    assert "run.gif" in frames
    assert est.shape == (len(small_bag.times), 3)
    np.testing.assert_array_equal(est, infos.estimate.mean.numpy())


def test_frame_recorder_staged(small_bag, torch_map, tmp_path):
    """--save-frames + --staged: the live view runs through the facade's
    staged mode and its frame hook, frames + GIF."""
    from mcmh_localization_tpu_torch.eval.runner import _run_with_frames

    cfg = FilterConfig(initial_pose=tuple(map(float, small_bag.gt[0])),
                       max_range=small_bag.max_range, **STAGED)
    args = argparse.Namespace(save_frames=str(tmp_path / "frames"),
                              frame_every=4, staged=True,
                              tracking_ess=0.9, tracking_theta_bins=None,
                              tracking_window=40)
    est, infos, wall = _run_with_frames(small_bag, cfg, torch_map, 0, args)
    frames = sorted(os.listdir(tmp_path / "frames"))
    pngs = [f for f in frames if f.endswith(".png")]
    assert len(pngs) == -(-len(small_bag.times) // 4)
    assert "run.gif" in frames
    assert est.shape == (len(small_bag.times), 3)
    assert np.all(np.isfinite(est))
    assert infos.count.shape == (len(small_bag.times),)


def test_runner_cli_single_staged(tmp_path, capsys, house_occupancy):
    """Twin of test_runner_cli_single_staged through the argparse surface,
    on a map written here and on the CPU: the staged path runs, reports
    the tracking-program share, and writes the results and metrics."""
    from mcmh_localization_tpu_torch.eval.runner import main
    from mcmh_localization_tpu_torch.utils.metrics import read_metrics

    yaml = _write_map_yaml(tmp_path, house_occupancy, 0.05, (-4.8, -4.8))
    res = main([
        "single", "--staged", "--initialized",
        "--mode", "AMHAMCL", "--scenario", "square",
        "--particles", "600", "--duration", "8.0", "--beams", "90",
        "--results-dir", str(tmp_path), "--result-name", "staged_cli",
        "--seed", "0", "--map", yaml, "--device", "cpu", "--metrics",
    ])
    out = capsys.readouterr().out
    assert "scans in the tracking program" in out
    assert res.rmse < 0.5, out
    txt = (tmp_path / "staged_cli.txt").read_text()
    assert "RMSE final:" in txt
    recs = read_metrics(str(tmp_path / "staged_cli.jsonl"))
    assert len(recs) == len(res.times)
    assert set(recs[0]) == {"step", "est", "ess", "accept_rate", "count",
                            "p_random", "anchor_mass", "t"}


def test_runner_refuses_the_card_without_one(tmp_path, house_occupancy):
    """The runner's default device is the card; without one it raises (no
    CPU fallback)."""
    from mcmh_localization_tpu_torch.eval.runner import build_parser, main

    yaml = _write_map_yaml(tmp_path, house_occupancy, 0.05, (-4.8, -4.8))
    assert build_parser().parse_args(["single", "--map", yaml]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["single", "--map", yaml, "--results-dir", str(tmp_path)])


def test_runner_staged_dispatch(torch_map, capsys):
    """Twin of test_runner_staged_dispatch: _run_bag dispatches adaptive
    modes to the staged runner and falls back (with a note) for
    non-adaptive modes and for sweep points too small to stage."""
    from mcmh_localization_tpu_torch.eval.runner import _run_bag

    gt = fit_trajectory_to_map(
        torch_map, SCENARIOS["static"](duration=3.0, rate=5.0))
    bag = simulate_bag(0, torch_map, gt, n_beams=60, max_range=5.0, rate=5.0,
                       name="static")
    args = argparse.Namespace(staged=True, tracking_ess=None,
                              tracking_theta_bins=None, tracking_window=None)
    base = dict(
        num_particles=900, min_particles=128, max_particles=3000,
        initialized=True, initial_pose=tuple(map(float, bag.gt[0])),
        max_range=5.0,
    )
    _run_bag(bag, FilterConfig(mode="AMHAMCL", **base), torch_map, 1, args)
    out = capsys.readouterr().out
    assert "scans in the tracking program" in out
    _run_bag(bag, FilterConfig(mode="MHMCL", **base), torch_map, 1, args)
    out = capsys.readouterr().out
    assert "tracking program" not in out
    tiny = dict(base, num_particles=250, max_particles=500,
                min_particles=400)
    _run_bag(bag, FilterConfig(mode="AMCL", **tiny), torch_map, 1, args)
    out = capsys.readouterr().out
    assert "staged fallback" in out


def test_warmup_staged_leaves_the_run_as_it_was(small_bag, torch_map):
    """warmup_staged's throwaway chunks run on copies of the generator: the
    generator's state is the same after it, and a staged run gives the same
    estimates, bitwise, with and without it."""
    from mcmh_localization_tpu_torch.filter.staged import (
        make_staged_model,
        run_staged,
        warmup_staged,
    )

    # the exact scorer keeps the BIG program's scans cheap on the CPU
    cfg = FilterConfig(initial_pose=tuple(map(float, small_bag.gt[0])),
                       **{**STAGED, "likelihood_impl": "jnp",
                          "corr_window_cells": 0})
    staged = make_staged_model(cfg, torch_map, tracking_ess_threshold=0.9)
    deltas = odometry_deltas(small_bag.odom)
    runs = []
    for warm in (False, True):
        state = staged.init(5)
        if warm:
            gen_before = state.key.get_state().clone()
            particles = state.particles.clone()
            warmup_staged(staged, state, small_bag.ranges, small_bag.angles,
                          deltas)
            assert torch.equal(state.key.get_state(), gen_before)
            assert torch.equal(state.particles, particles)
        out = run_staged(staged, state, small_bag.ranges, small_bag.angles,
                         deltas)
        runs.append(out)
    assert runs[0].switches >= 1
    np.testing.assert_array_equal(runs[0].modes, runs[1].modes)
    assert torch.equal(runs[0].infos.estimate.mean, runs[1].infos.estimate.mean)
