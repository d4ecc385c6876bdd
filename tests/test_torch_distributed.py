"""The port's multi-rank filter (``parallel/distributed.py``) on gloo CPU
ranks: one scan of ``_dist_step`` against JAX's shard_map step on JAX's
per-shard draws, the theta-sharded corr and beam builds bit for bit
against the local builds, the bytes each collective moves, and twins of
tests/test_distributed.py's ten tests with their gates.  D = 8 where the
JAX assertion depends on it (the island-mixing ring, the non-divisible
theta window), else D = 4 against JAX's 4-device sub-mesh."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.models.corr_field import (  # noqa: E402
    correlation_field_scores as j_corr_scores,
)
from mcmh_localization_tpu.models.sensor import (  # noqa: E402
    log_likelihood_field as j_log_field,
)
from mcmh_localization_tpu.parallel.distributed import (  # noqa: E402
    make_dist_model as j_make_dist_model,
)
from mcmh_localization_tpu.parallel.sharding import make_mesh as j_make_mesh  # noqa: E402
from mcmh_localization_tpu_torch.convert import STATE_FIELDS  # noqa: E402
from mcmh_localization_tpu_torch.ops.resampling import kld_resample  # noqa: E402
from tests import torch_ranks  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401
from tests.test_torch_sharding import house, ranks  # noqa: E402,F401


def _scan_at(house_map, pose, m=90):
    from mcmh_localization_tpu.models.sensor import raycast

    angles = jnp.linspace(-np.pi, np.pi, m)
    r = raycast(jnp.asarray(pose[:2]), pose[2] + angles, house_map, 5.0,
                hit_unknown=True)
    return np.asarray(r), np.asarray(angles)


def _square(house_map, t=18):
    from tests.test_filter import _simulate, _square_trajectory, _wrap

    poses = _square_trajectory(t)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    return (np.asarray(scans), np.asarray(angles), np.asarray(deltas),
            _wrap(poses[-1]))


def _end_error(est, true):
    return float(np.hypot(est[-1, 0] - true[0], est[-1, 1] - true[1]))


# ---------------------------------------------------------------------------
# one scan on JAX's per-shard draws
# ---------------------------------------------------------------------------

def _shard_draws(key, ax, nl, cfg, free_cells):
    """Shard ``ax``'s draws of one JAX ``_dist_step`` (distributed.py:453-
    457: five splits of the state's key, each folded with the axis index;
    then sample_motion, the MH uniforms, kld_resample's (resampling.py:366)
    and init_uniform's (filter/init.py:39) draws at the shard's nl rows)."""
    _, k_mo, k_mh, k_rs, k_rand = jax.random.split(key, 5)
    k_mo, k_mh, k_rs, k_rand = (jax.random.fold_in(k, ax)
                                for k in (k_mo, k_mh, k_rs, k_rand))
    shape = (nl, 3) if cfg.motion_validity == "score" else (
        cfg.motion_retries, nl, 3)
    k_idx, k_noise, _ = jax.random.split(k_rs, 3)
    k_cell, k_off, k_theta = jax.random.split(k_rand, 3)
    d = {
        "motion": jax.random.normal(k_mo, shape, jnp.float32),
        "mh_u": jax.random.uniform(k_mh, (nl,)),
        "kld_r": jax.random.uniform(k_idx, (), minval=0.0, maxval=1.0),
        "kld_noise": jax.random.normal(k_noise, (nl, 3), jnp.float32),
        "inject_cells": jax.random.randint(k_cell, (min(nl, 65536),), 0,
                                           free_cells),
        "inject_jitter": jax.random.uniform(k_off, (nl, 2), minval=-0.5,
                                            maxval=0.5),
        "inject_theta": jax.random.uniform(k_theta, (nl,), minval=-jnp.pi,
                                           maxval=jnp.pi),
    }
    return {k: np.array(v) for k, v in d.items()}


_BASE = dict(mode="AMHAMCL", num_particles=4096, min_particles=600,
             max_particles=4096, initialized=True,
             initial_pose=(1.0, 1.0, 0.4), initial_cov=(0.02, 0.02, 0.05),
             max_range=5.0, motion_validity="score", min_injection_prob=0.02,
             estimate_mode="cluster")
SCAN_CASES = {
    # windowed corr (64 cells, 16 of 48 bins: 4 a rank), the coarse fallback
    "corr_windowed": dict(likelihood_impl="corr", corr_n_theta=48,
                          corr_window_cells=64, corr_theta_window_bins=16),
    # the beam score field (48 table bins, 16 in the window, coarse at 36)
    "beam_field": dict(sensor_model="beam", beam_impl="field",
                       beam_table_n_theta=48, corr_window_cells=64,
                       corr_theta_window_bins=16),
    # the exact scorer
    "exact": dict(likelihood_impl="jnp"),
    # windowed corr with the augmented-MCL averages apart: every island
    # injects, its randoms in the first slots and its kept samples shifted
    # behind them by the device-held count
    "corr_windowed_inject": dict(likelihood_impl="corr", corr_n_theta=48,
                                 corr_window_cells=64,
                                 corr_theta_window_bins=16, inject=True),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_one_dist_scan_matches_jax_on_shard_draws(house_map, house, ranks,
                                                 case):
    """One ``_dist_step`` at D = 4 from JAX's initial state, each rank on
    its shard's JAX draws, against JAX's shard_map step on a 4-device
    mesh, at tests/test_torch_filter.py::
    test_one_scan_matches_jax_on_shared_draws' tolerances: estimate atol
    1e-4, weights rtol 1e-4, the count equal, at most 0.5% of the active
    rows moved."""
    from tests.test_filter import _simulate

    kw = {**_BASE, **SCAN_CASES[case]}
    inject = kw.pop("inject", False)
    jcfg = JConfig(**kw)
    poses = np.float32([[1.0, 1.0, 0.4], [1.1, 1.03, 0.5]])
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    jm = j_make_dist_model(jcfg, house_map, j_make_mesh(jax.devices()[:4]))
    js = jm.init(jax.random.PRNGKey(0))
    if inject:
        js = js.replace(w_slow=jnp.float32(1.0), w_fast=jnp.float32(0.5))
    state_np = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    nl = 4096 // 4
    draws = [_shard_draws(js.key, ax, nl, jcfg, house_map.free_xy.shape[0])
             for ax in range(4)]
    js2, jinfo = jm.step(js, scans[1], angles, deltas[1])
    log_field = (None if jcfg.sensor_model == "beam"
                 else np.asarray(j_log_field(house_map, jcfg)))

    out = ranks(4).run(torch_ranks.dist_scan, house, kw, state_np,
                       np.asarray(scans[1]), np.asarray(angles),
                       np.asarray(deltas[1]), draws, log_field)
    count = int(jinfo.count)
    for r in out:
        assert r["count"] == count
        np.testing.assert_allclose(r["mean"], np.asarray(jinfo.estimate.mean),
                                   atol=1e-4)
        for f in ("ess", "w_slow", "w_fast", "p_random", "anchor_mass",
                  "accept_rate"):
            np.testing.assert_allclose(r[f], float(getattr(jinfo, f)),
                                       rtol=1e-4, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(r["anchor"], np.asarray(js2.anchor),
                                   atol=1e-4)
    w_j = np.asarray(js2.weights)
    w_t = np.concatenate([r["weights"] for r in out])
    np.testing.assert_allclose(w_t, w_j, rtol=1e-4, atol=1e-4 * w_j.max())
    # the active rows of each island: its prefix of count / D rows
    p_j = np.asarray(js2.particles).reshape(4, nl, 3)[:, :count // 4]
    p_t = np.stack([r["particles"] for r in out])[:, :count // 4]
    moved = np.abs(p_j - p_t).max(axis=2) > 1e-4
    assert moved.mean() <= 0.005, moved.mean()
    if inject:
        assert float(jinfo.p_random) > 0.02          # the injection ran


# the dist step's forms under the host-read guard, each injecting: the corr
# window with the coarse fallback and the beam score field (its coarse
# build never gated under sharding) with the KLD island, and the exact
# scorer with the "lvr" island
GUARD_CASES = {
    "corr_windowed": dict(SCAN_CASES["corr_windowed"]),
    "beam_field": dict(SCAN_CASES["beam_field"]),
    "exact_lvr": dict(likelihood_impl="jnp", adaptive_resampler="lvr"),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_dist_step_reads_nothing_on_the_host(house_map, house, ranks, case):
    """One ``_dist_step`` on two gloo ranks under the host-read guard
    (tests/torch_guard.py): no host read escapes outside ``run_if``'s
    plain version (the window origin, the island injection's shift and
    the gates stay on the device), and the guarded step is ``torch.equal``
    to the same step unguarded on the same generator, on every rank."""
    kw = {**_BASE, **GUARD_CASES[case]}
    ranges, angles = _scan_at(house_map, (1.0, 1.0, 0.4))
    out = ranks(2).run(torch_ranks.dist_step_guarded, house, kw, ranges,
                       angles, np.float32([0.0, 0.02, 0.0]), (1.0, 0.5))
    for r in out:
        assert r["equal"]
        assert r["p_random"] > 0.02 and r["count"] > 0


# ---------------------------------------------------------------------------
# theta-sharded builds
# ---------------------------------------------------------------------------

def test_theta_sharded_build_matches_local(house_map, house, default_config,
                                           ranks):
    """The corr field built theta-sharded over 4 ranks (16 of 64 bins a
    rank, one all_gather) scores every rank's rows bitwise as the local
    build does; the local build matches JAX's within f32 sum order (rtol
    1e-5, atol 1e-5, the JAX test's tolerance between its sharded and
    local builds)."""
    ranges, angles = _scan_at(house_map, np.float32([1.0, 1.0, 0.4]))
    rng = np.random.default_rng(0)
    parts = np.stack([rng.uniform(-3, 3, 256), rng.uniform(-3, 3, 256),
                      rng.uniform(-np.pi, np.pi, 256)], 1).astype(np.float32)
    kw = dict(num_particles=512, max_particles=512, min_particles=64,
              max_range=5.0)
    out = ranks(4).run(torch_ranks.corr_stacks, house, kw, parts, ranges,
                       angles, 64)
    for r in out:
        np.testing.assert_array_equal(r["sharded"], r["local"])
        assert r["gathers"][0] == 1
    want = np.asarray(j_corr_scores(jnp.asarray(parts), jnp.asarray(ranges),
                                    jnp.asarray(angles), house_map,
                                    default_config, n_theta=64,
                                    field_impl="xla"))
    np.testing.assert_allclose(out[0]["all_local"], want, rtol=1e-5,
                               atol=1e-5)


def test_dist_beam_field_matches_local(house_map, house, ranks):
    """The beam score field built theta-sharded over 4 ranks (the fine
    field's 16 window bins and the coarse field's 16, 4 a rank), for
    in-window particles and escapees: every
    rank's scores equal the local build's bitwise; the local build matches
    JAX's (its "dense" CPU form) at tests/test_torch_range_table.py's
    tolerance (rtol 1e-5, atol 1e-5 * M * 13.82)."""
    from mcmh_localization_tpu.models.range_table import (
        beam_field_scores,
        make_beam_tables,
    )

    kw = dict(mode="MCL", num_particles=256, max_particles=256,
              min_particles=32, initialized=True,
              initial_pose=(1.0, 1.0, 0.4), max_range=5.0,
              sensor_model="beam", beam_impl="field", beam_table_n_theta=32,
              corr_window_cells=96, corr_theta_window_bins=16,
              corr_coarse_factor=4, corr_coarse_n_theta=16)
    cfg = JConfig(**kw)
    ranges, angles = _scan_at(house_map, np.float32([1.0, 1.0, 0.4]))
    rng = np.random.default_rng(1)
    parts = np.concatenate([
        np.stack([rng.normal(1.0, 0.3, 240), rng.normal(1.0, 0.3, 240),
                  rng.normal(0.4, 0.2, 240)], axis=1),
        np.stack([rng.uniform(-4, 4, 16), rng.uniform(-4, 4, 16),
                  rng.uniform(-np.pi, np.pi, 16)], axis=1),
    ]).astype(np.float32)
    wo = (170, 170, 4)
    out = ranks(4).run(torch_ranks.beam_stacks, house, kw, parts, ranges,
                       angles, 32, wo)
    for r in out:
        np.testing.assert_array_equal(r["sharded"], r["local"])
        assert r["gathers"][0] == 2       # the fine and the coarse stacks
    want = np.asarray(beam_field_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles),
        house_map, cfg, make_beam_tables(house_map, cfg), 32,
        tuple(jnp.int32(o) for o in wo)))
    np.testing.assert_allclose(out[0]["all_local"], want, rtol=1e-5,
                               atol=1e-5 * 90 * 13.82)


# ---------------------------------------------------------------------------
# twins of tests/test_distributed.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["MCL", "AMHAMCL"])
def test_dist_filter_tracks(house_map, house, ranks, mode):
    scans, angles, deltas, true = _square(house_map)
    kw = dict(mode=mode, num_particles=512, min_particles=64,
              max_particles=512, initialized=True,
              initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0)
    out = ranks(4).run(torch_ranks.dist_track, house, kw, scans, angles,
                       deltas)
    assert _end_error(out[0]["mean"], true) < 0.3
    assert np.isfinite(out[0]["ess"]).all()
    for r in out[1:]:   # the infos are psum'd: the same on every rank
        np.testing.assert_array_equal(r["mean"], out[0]["mean"])


def test_dist_corr_windowed_tracks(house_map, house, ranks):
    scans, angles, deltas, true = _square(house_map)
    kw = dict(mode="AMHAMCL", num_particles=512, min_particles=64,
              max_particles=512, initialized=True,
              initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
              likelihood_impl="corr", corr_n_theta=64, corr_window_cells=96,
              corr_theta_window_bins=16)
    out = ranks(4).run(torch_ranks.dist_track, house, kw, scans, angles,
                       deltas)
    assert _end_error(out[0]["mean"], true) < 0.35


def test_dist_step_has_no_big_gather(house_map, house, ranks):
    """At 65 536 particles over 4 ranks, every collective of a windowed
    corr step moves under half the particle bytes from a rank: the
    largest is the theta window's field share (4 bins x 96^2 x 4 B), the
    ring block nl / 8 rows."""
    n = 65536
    kw = dict(mode="AMHAMCL", num_particles=n, min_particles=1024,
              max_particles=n, initialized=True,
              initial_pose=(1.0, -1.0, 0.0), max_range=5.0,
              likelihood_impl="corr", corr_n_theta=64, corr_window_cells=96,
              corr_theta_window_bins=16)
    ranges, angles = _scan_at(house_map, np.float32([1.0, -1.0, 0.0]))
    out = ranks(4).run(torch_ranks.dist_step_collectives, house, kw, ranges,
                       angles, np.float32([0.0, 0.05, 0.0]))
    particle_bytes = n * 3 * 4
    for r in out:
        counts = r["counts"]
        assert {"psum", "pmax", "all_gather", "ppermute"} <= set(counts)
        for name, (calls, nbytes, largest) in counts.items():
            assert largest < particle_bytes // 2, (name, largest)
        assert counts["all_gather"][2] == 4 * 96 * 96 * 4
        assert counts["ppermute"][2] == (r["nl"] // 8) * 3 * 4
        assert np.isfinite(r["mean"]).all()


def test_dist_beam_field_tracks(house_map, house, ranks):
    scans, angles, deltas, true = _square(house_map)
    kw = dict(mode="AMHAMCL", num_particles=512, min_particles=64,
              max_particles=512, initialized=True,
              initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
              sensor_model="beam", beam_impl="field", beam_table_n_theta=64,
              corr_window_cells=96, corr_theta_window_bins=16,
              corr_coarse_factor=0)
    out = ranks(4).run(torch_ranks.dist_track, house, kw, scans, angles,
                       deltas)
    assert _end_error(out[0]["mean"], true) < 0.35


def test_dist_island_mixing(house_map, house, ranks):
    """7 of 8 islands start in the wrong room; the ring migration and the
    islands' resampling spread the good island's mass until every island
    localizes (tests/test_distributed.py's gates)."""
    ranges, angles = _scan_at(house_map, np.float32([1.0, -1.0, 0.0]))
    n, nl = 1024, 1024 // 8
    kw = dict(mode="MCL", num_particles=n, min_particles=128,
              max_particles=n, initialized=True,
              initial_pose=(1.0, -1.0, 0.0), max_range=5.0)
    rng = np.random.default_rng(2)

    def blob(center, k):
        return np.stack([rng.normal(center[0], 0.08, k),
                         rng.normal(center[1], 0.08, k),
                         rng.normal(center[2], 0.05, k)],
                        axis=1).astype(np.float32)

    parts = np.concatenate([blob((1.0, -1.0, 0.0), nl)]
                           + [blob((1.0, 2.4, 0.0), nl) for _ in range(7)])
    d = np.hypot(parts[:, 0] - 1.0, parts[:, 1] + 1.0).reshape(8, nl)
    assert (d < 0.5).mean(axis=1)[1:].max() == 0.0
    out = ranks(8).run(torch_ranks.dist_mixing, house, kw, parts, ranges,
                       angles, 12)
    fracs = np.asarray([r["fracs"] for r in out]).T      # (steps, island)
    assert fracs[2, 1] > 0.2, fracs[2]
    assert (fracs[-1] > 0.6).all(), fracs[-1]
    est = out[0]["mean"]
    assert np.hypot(est[0] - 1.0, est[1] + 1.0) < 0.3, est


def test_dist_lidar3d_tracks(house, ranks):
    """The 3-D lidar through the distributed step: the score volume on
    every rank, lookups local (the JAX room, scans and odometry)."""
    from mcmh_localization_tpu.maps.voxel_map import build_voxel_map
    from mcmh_localization_tpu.models.sensor3d import simulate_scan3d
    from mcmh_localization_tpu.sim.simulator import odometry_deltas

    d, h, w = 30, 100, 100
    occ = np.zeros((d, h, w), dtype=np.int8)
    occ[:, 0, :] = occ[:, -1, :] = 100
    occ[:, :, 0] = occ[:, :, -1] = 100
    occ[0, :, :] = 100
    occ[0:10, 40:60, 60:80] = 100
    room3d = build_voxel_map(occ, 0.1, (-5.0, -5.0, 0.0))
    azimuths = np.linspace(-np.pi, np.pi, 32, endpoint=False)
    rings = np.asarray([-0.15, 0.0, 0.2])
    directions = np.stack([np.repeat(azimuths, 3), np.tile(rings, 32)],
                          1).astype(np.float32)
    kw = dict(mode="MCL", num_particles=512, initialized=True,
              initial_pose=(0.0, -3.0, 0.0), max_range=6.0,
              sensor_model="lidar3d", lidar3d_sensor_z=1.0, sigma_hit=0.2,
              alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01)
    key = jax.random.PRNGKey(1)
    poses = [np.array([0.0, -3.0, 0.0])]
    for _ in range(25):
        p = poses[-1].copy()
        p[2] += 0.08
        p[0] += 0.08 * np.cos(p[2])
        p[1] += 0.08 * np.sin(p[2])
        poses.append(p)
    poses = np.asarray(poses)
    scans = np.stack([np.asarray(simulate_scan3d(
        jax.random.fold_in(key, t), jnp.asarray(p, jnp.float32),
        jnp.asarray(directions), room3d, 6.0, sensor_z=1.0, noise=0.01))
        for t, p in enumerate(poses)])
    deltas = np.asarray(odometry_deltas(poses.astype(np.float32)))
    vm = {"occupancy": np.asarray(room3d.occupancy),
          "distance": np.asarray(room3d.distance),
          "resolution": room3d.resolution, "origin": room3d.origin,
          "max_distance": None}
    out = ranks(4).run(torch_ranks.dist_track_lidar, vm, kw, scans,
                       directions, deltas)
    est = out[0]["mean"]
    assert np.hypot(est[-1, 0] - poses[-1, 0], est[-1, 1] - poses[-1, 1]) < 0.3


def test_dist_island_kld_vs_global_oracle():
    """The island KLD rule (``parallel/distributed.py::_island_resample``:
    each island's stop at epsilon x D and min / D, the count adopted by a
    pmax) on the port's kld_resample against one global KLD run on the
    same cloud: conservative, and at most 3x the global count plus the
    minimum (tests/test_distributed.py's gates)."""
    rng = np.random.default_rng(9)
    n, n_dev = 2048, 8
    centers = rng.uniform(-3, 3, (6, 2))
    idx = rng.integers(0, 6, n)
    parts = torch.from_numpy(np.stack([
        centers[idx, 0] + rng.normal(0, 0.25, n),
        centers[idx, 1] + rng.normal(0, 0.25, n),
        rng.uniform(-np.pi, np.pi, n),
    ], axis=1).astype(np.float32))
    w = rng.exponential(size=n).astype(np.float32)
    w = torch.from_numpy(w / w.sum())
    kw = dict(bin_size_xy=0.2, bin_size_theta=np.pi / 18, z=2.0,
              stop_rule="every_sample")
    _, n_glob = kld_resample(parts, w, max_samples=n, min_particles=64,
                             epsilon=0.03,
                             generator=torch.Generator().manual_seed(3), **kw)
    n_glob = int(n_glob)
    nl = n // n_dev
    island = []
    for s in range(n_dev):
        pw = w[s * nl:(s + 1) * nl]
        _, nk = kld_resample(parts[s * nl:(s + 1) * nl], pw / pw.sum(),
                             max_samples=nl, min_particles=max(64 // n_dev, 1),
                             epsilon=0.03 * n_dev,
                             generator=torch.Generator().manual_seed(s), **kw)
        island.append(int(nk))
    adopted = max(island) * n_dev
    assert adopted >= min(n_glob, n), (adopted, n_glob, island)
    assert adopted <= 3 * n_glob + 64, (adopted, n_glob, island)


def test_dist_theta_window_nondivisible_falls_back(house_map, house, ranks):
    """12 theta-window bins on 8 ranks: every rank builds the whole window
    locally (no all_gather), and the step gives a finite estimate."""
    kw = dict(mode="AMCL", num_particles=256, min_particles=32,
              max_particles=256, initialized=True,
              initial_pose=(1.0, -1.0, 0.0), max_range=5.0,
              likelihood_impl="corr", corr_n_theta=64, corr_window_cells=96,
              corr_theta_window_bins=12)
    ranges, angles = _scan_at(house_map, np.float32([1.0, -1.0, 0.0]))
    out = ranks(8).run(torch_ranks.dist_step_collectives, house, kw, ranges,
                       angles, np.float32([0.0, 0.05, 0.0]))
    for r in out:
        assert "all_gather" not in r["counts"]
        assert np.isfinite(r["mean"]).all()


def test_a_rank_that_skips_a_collective_fails(tmp_path):
    """Rank 0 enters a psum that rank 1 never joins: the group's timeout
    (3 s here) fails the call on rank 0 and the pool reports it, instead
    of the run hanging."""
    import time

    pool = torch_ranks.RankPool(2, tmp_path, group_timeout=3)
    try:
        t0 = time.perf_counter()
        with pytest.raises(AssertionError, match="rank 0"):
            pool.run(torch_ranks.skip_collective, timeout=60)
        assert time.perf_counter() - t0 < 60
        assert not pool.alive
    finally:
        pool.close()
