"""The port's filter (MH, estimate, one scan of the step, the staged
runner) against the JAX package: on shared draws where the draws can be
shared, statistically for whole runs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter import estimate as jest  # noqa: E402
from mcmh_localization_tpu.filter import mh as jmh  # noqa: E402
from mcmh_localization_tpu.filter.staged import (  # noqa: E402
    make_staged_model as j_make_staged,
    run_staged as j_run_staged,
)
from mcmh_localization_tpu.filter.step import make_model as j_make_model  # noqa: E402
from mcmh_localization_tpu.ops import resampling as jres  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import (  # noqa: E402
    STATE_FIELDS,
    grid_map_from_numpy,
    state_from_numpy,
)
from mcmh_localization_tpu_torch.filter import estimate as t_est  # noqa: E402
from mcmh_localization_tpu_torch.filter import mh as tmh  # noqa: E402
from mcmh_localization_tpu_torch.filter.staged import (  # noqa: E402
    make_staged_model,
    run_staged,
)
from mcmh_localization_tpu_torch.filter.step import Draws, make_model  # noqa: E402
from mcmh_localization_tpu_torch.ops import resampling as tres  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


# ---------------------------------------------------------------------------
# MH and estimate
# ---------------------------------------------------------------------------

def test_mh_matches_jax_on_shared_uniforms():
    rng = np.random.default_rng(0)
    n = 6000
    prev = rng.normal(size=(n, 3)).astype(np.float32)
    prop = rng.normal(size=(n, 3)).astype(np.float32)
    wp = rng.dirichlet(np.ones(n)).astype(np.float32)
    wq = rng.dirichlet(np.ones(n)).astype(np.float32)
    fwd = rng.dirichlet(np.ones(n)).astype(np.float32)
    bwd = rng.dirichlet(np.ones(n)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = _t(jax.random.uniform(key, (n,)))
    for guard in (False, True):
        want = jmh.asymmetric_mh(key, jnp.asarray(prev), jnp.asarray(prop),
                                 jnp.asarray(wp), jnp.asarray(wq),
                                 jnp.asarray(fwd), jnp.asarray(bwd),
                                 ref_compat_guard=guard)
        got = tmh.asymmetric_mh(_t(prev), _t(prop), _t(wp), _t(wq), _t(fwd),
                                _t(bwd), ref_compat_guard=guard, u=u)
        # log/exp ulps can flip an acceptance only where u ~ alpha
        acc_w, acc_g = np.asarray(want[2]), got[2].numpy()
        assert (acc_w != acc_g).mean() <= 1e-3
        same = acc_w == acc_g
        np.testing.assert_array_equal(got[0].numpy()[same],
                                      np.asarray(want[0])[same])
    want = jmh.symmetric_mh(key, jnp.asarray(prev), jnp.asarray(prop),
                            jnp.asarray(wp), jnp.asarray(wq))
    got = tmh.symmetric_mh(_t(prev), _t(prop), _t(wp), _t(wq), u=u)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_estimates_match_jax():
    rng = np.random.default_rng(1)
    n = 5000
    p = np.stack([rng.normal(1, 0.3, n), rng.normal(2, 0.2, n),
                  rng.normal(3.0, 0.3, n)], 1).astype(np.float32)
    p[:500] += [4.0, 0.0, 0.0]                    # a second mode
    w = rng.dirichlet(np.ones(n)).astype(np.float32)
    mask = np.arange(n) < 4600
    anchor = np.float32([1.0, 2.0, 3.0])
    # f32 reductions in another order
    tol = dict(rtol=1e-5, atol=1e-6)
    for want, got in (
        (jest.estimate_pose(jnp.asarray(p), jnp.asarray(w), jnp.asarray(mask)),
         t_est.estimate_pose(_t(p), _t(w), _t(mask))),
        (jest.estimate_pose_cluster(jnp.asarray(p), jnp.asarray(w),
                                    jnp.asarray(mask)),
         t_est.estimate_pose_cluster(_t(p), _t(w), _t(mask))),
        (jest.estimate_pose_cluster(jnp.asarray(p), jnp.asarray(w),
                                    jnp.asarray(mask),
                                    anchor=jnp.asarray(anchor)),
         t_est.estimate_pose_cluster(_t(p), _t(w), _t(mask),
                                     anchor=_t(anchor))),
    ):
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                                   **tol)
        np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov),
                                   **tol)
    np.testing.assert_allclose(
        float(t_est.cluster_mass(_t(p), _t(w), _t(anchor), 0.5, 1.0)),
        float(jest.cluster_mass(jnp.asarray(p), jnp.asarray(w),
                                jnp.asarray(anchor), 0.5, 1.0)), rtol=1e-5)


# ---------------------------------------------------------------------------
# one scan of AMHAMCL on shared draws
# ---------------------------------------------------------------------------

def _scan_draws(key, n_max, w1, free_cells, mh=True):
    """The JAX step's draws rebuilt from its key splits: step.py:83
    (predict), :551 (correct), :475 (_resample_kld) and resampling.py:366
    (kld_resample), filter/init.py:39 (injection)."""
    key, sub = jax.random.split(key)
    motion = jax.random.normal(sub, (n_max, 3), jnp.float32)
    _, k_mh, k_rs = jax.random.split(key, 3)
    k_kld, k_rand = jax.random.split(k_rs)
    k_idx, k_noise, k_tail = jax.random.split(k_kld, 3)
    k_cell, k_off, k_theta = jax.random.split(k_rand, 3)
    rows = w1 if w1 < n_max else n_max
    return Draws(
        motion=_t(motion),
        mh_u=_t(jax.random.uniform(k_mh, (n_max,))),
        kld_r=_t(jax.random.uniform(k_idx, (), minval=0.0, maxval=1.0)),
        kld_noise=_t(jax.random.normal(k_noise, (rows, 3), jnp.float32)),
        kld_noise_tail=(_t(jax.random.normal(k_tail, (n_max - w1, 3),
                                             jnp.float32))
                        if w1 < n_max else None),
        inject_cells=_t(jax.random.randint(k_cell, (min(n_max, 65536),), 0,
                                           free_cells)),
        inject_jitter=_t(jax.random.uniform(k_off, (n_max, 2), minval=-0.5,
                                            maxval=0.5)),
        inject_theta=_t(jax.random.uniform(k_theta, (n_max,), minval=-jnp.pi,
                                           maxval=jnp.pi)),
    )


SCAN_CASES = {
    # the BIG program: full map, all bins, "sum", refill, every-scan KLD;
    # the stage-1 prefix shrunk to 1024 so the escalating draw is reached
    "big": dict(score_aggregation="sum", injection_refill=True),
    "big_injection": dict(score_aggregation="sum", injection_refill=True),
    # the SMALL program: windowed + theta window, no coarse fallback, the
    # ESS gate (0.9: skips the resample here) or every-scan resampling
    "small_gated": dict(corr_window_cells=64, corr_theta_window_bins=16,
                        resample_ess_threshold=0.9),
    "small_resampling": dict(corr_window_cells=64, corr_theta_window_bins=16,
                             resample_ess_threshold=1.0),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_one_scan_matches_jax_on_shared_draws(house_map, torch_map,
                                              monkeypatch, case):
    from tests.test_filter import _simulate

    monkeypatch.setattr(jres, "_KLD_STAGE1", 1024)
    monkeypatch.setattr(tres, "_KLD_STAGE1", 1024)
    n_max = 4096
    kw = dict(mode="AMHAMCL", num_particles=n_max, min_particles=600,
              max_particles=n_max, initialized=True,
              initial_pose=(1.0, 1.0, 0.4), initial_cov=(0.02, 0.02, 0.05),
              max_range=5.0, likelihood_impl="corr", corr_n_theta=48,
              motion_validity="score", min_injection_prob=0.02,
              corr_coarse_factor=0, estimate_mode="cluster")
    kw.update(SCAN_CASES[case])
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    poses = np.float32([[1.0, 1.0, 0.4], [1.1, 1.03, 0.5]])
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    jm = j_make_model(jcfg, house_map)
    js = jm.init(jax.random.PRNGKey(0))
    if case == "big_injection":
        js = js.replace(w_slow=jnp.float32(1.0), w_fast=jnp.float32(0.5))
    before = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    js2, jinfo = jm.step(js, scans[1], angles, deltas[1])

    tm = make_model(tcfg, torch_map)
    tm.log_field = torch.from_numpy(np.array(jm.log_field))
    w1 = max(1024, 600 + 600 // 4)
    draws = _scan_draws(js.key, n_max, w1, house_map.free_xy.shape[0])
    ts = state_from_numpy(before, device="cpu")
    ts2, tinfo = tm.step(ts, _t(scans[1]), _t(angles), _t(deltas[1]), draws)

    count = int(jinfo.count)
    assert int(tinfo.count) == count
    # estimate, ESS and bookkeeping: f32 reductions in another order
    np.testing.assert_allclose(tinfo.estimate.mean.numpy(),
                               np.asarray(jinfo.estimate.mean), atol=1e-4)
    for f in ("ess", "w_slow", "w_fast", "p_random", "anchor_mass",
              "accept_rate"):
        np.testing.assert_allclose(float(getattr(tinfo, f)),
                                   float(getattr(jinfo, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    w_j, w_t = np.asarray(js2.weights), ts2.weights.numpy()
    np.testing.assert_allclose(w_t, w_j, rtol=1e-4, atol=1e-4 * w_j.max())
    # at most 0.5% of the active slots hold another particle (a cumsum in
    # another order can move a segment bound by one)
    p_j, p_t = np.asarray(js2.particles)[:count], ts2.particles.numpy()[:count]
    moved = np.abs(p_j - p_t).max(axis=1) > 1e-4
    assert moved.mean() <= 0.005, moved.mean()
    np.testing.assert_allclose(ts2.anchor.numpy(), np.asarray(js2.anchor),
                               atol=1e-4)
    if case == "big_injection":
        assert float(jinfo.p_random) > 0.02     # the injection branch ran
    if case == "small_gated":
        assert float(jinfo.p_random) == 0.0     # the gate skipped it
        assert count == n_max


# ---------------------------------------------------------------------------
# the whole slice: the staged runner
# ---------------------------------------------------------------------------

def test_staged_tracks_and_shrinks_like_jax(house_map, torch_map):
    """Twin of tests/test_staged.py::test_staged_tracks_and_shrinks in the
    main path's validity mode ("score", min_injection_prob 0.02) on both
    sides: the port enters and ends in the SMALL program, tracks within
    0.4 m over the last 8 scans and within 0.3 m of the JAX run."""
    from tests.test_filter import _simulate
    from tests.test_staged import _circle

    poses = _circle(48)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    kw = dict(mode="AMHAMCL", num_particles=3000, min_particles=400,
              max_particles=3000, initialized=True, max_range=5.0,
              likelihood_impl="corr", corr_n_theta=90, corr_window_cells=96,
              estimate_mode="cluster", motion_validity="score",
              min_injection_prob=0.02,
              initial_pose=tuple(map(float, poses[0])))

    def errs(est):
        return np.hypot(est[:, 0] - poses[:, 0], est[:, 1] - poses[:, 1])

    jst = j_make_staged(JConfig(**kw), house_map, tracking_capacity=1024)
    jout = j_run_staged(jst, jst.init(jax.random.PRNGKey(3)), scans, angles,
                        deltas, chunk=8)
    e_j = errs(np.asarray(jout.infos.estimate.mean))

    tst = make_staged_model(FilterConfig(**kw), torch_map,
                            tracking_capacity=1024)
    tout = run_staged(tst, tst.init(3), np.asarray(scans), np.asarray(angles),
                      np.asarray(deltas), chunk=8)
    e_t = errs(tout.infos.estimate.mean.numpy())

    assert jout.modes[-1] == 1                  # the JAX run settles too
    assert tout.modes[-1] == 1, tout.modes
    assert tout.switches >= 1
    assert (tout.modes == 1).sum() >= 8, tout.modes
    assert np.mean(e_t[-8:]) < 0.4, e_t[-8:]
    assert abs(np.mean(e_t[-8:]) - np.mean(e_j[-8:])) < 0.3
    assert tout.state.particles.shape[0] == 1024
