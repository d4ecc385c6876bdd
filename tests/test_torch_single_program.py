"""The port's single-program filter (filter/step.py::make_model) against
the JAX package: one scan on shared draws in all six modes with the exact
scorer and motion_validity="reject", and in the windowed corr
configuration with the coarse fallback; and the port's twins of the JAX
package's whole-run tests (all modes track, kidnapped-robot recovery)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter import step as jstep  # noqa: E402
from mcmh_localization_tpu.ops import resampling as jres  # noqa: E402
from mcmh_localization_tpu_torch.config import MODES, FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import (  # noqa: E402
    STATE_FIELDS,
    state_from_numpy,
)
from mcmh_localization_tpu_torch.filter.step import (  # noqa: E402
    Draws,
    make_model,
    state_size,
)
from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map  # noqa: E402
from mcmh_localization_tpu_torch.ops import resampling as tres  # noqa: E402
from tests.test_filter import _simulate, _square_trajectory  # noqa: E402
from tests.test_torch_resamplers import resample_draws, uniform_draws  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def torch_map(house_occupancy, house_map):
    # built from the python resolution, as the JAX map is (bitwise equal
    # free-cell centers, so injected particles agree)
    return build_grid_map(house_occupancy, 0.05, (-4.8, -4.8),
                          distance=np.asarray(house_map.distance),
                          device="cpu")


def scan_draws(key, cfg, free_cells):
    """One JAX step's draws rebuilt from its key splits: step.py:83-88
    (predict; (motion_retries, n, 3) normals under "reject"), :551
    (correct), and the resampler's (:475 and resampling.py:366 for KLD,
    :407-466 for the others)."""
    n_max = state_size(cfg)
    key, sub = jax.random.split(key)
    retries = 0 if cfg.motion_validity == "score" else cfg.motion_retries
    shape = (n_max, 3) if retries == 0 else (retries, n_max, 3)
    d = dict(motion=_t(jax.random.normal(sub, shape, jnp.float32)))
    _, k_mh, k_rs = jax.random.split(key, 3)
    d["mh_u"] = _t(jax.random.uniform(k_mh, (n_max,)))
    if cfg.use_adaptive and cfg.adaptive_resampler == "kld":
        k_kld, k_rand = jax.random.split(k_rs)
        k_idx, k_noise, k_tail = jax.random.split(k_kld, 3)
        w1 = max(jres._KLD_STAGE1,
                 cfg.min_particles + cfg.min_particles // 4)
        one = (w1 >= n_max or cfg.kld_eval_window
               or cfg.min_particles >= n_max)
        d.update(
            kld_r=_t(jax.random.uniform(k_idx, (), minval=0.0, maxval=1.0)),
            kld_noise=_t(jax.random.normal(
                k_noise, (n_max if one else w1, 3), jnp.float32)),
            kld_noise_tail=None if one else _t(jax.random.normal(
                k_tail, (n_max - w1, 3), jnp.float32)),
            **uniform_draws(k_rand, n_max, free_cells))
    else:
        d.update(resample_draws(k_rs, cfg, n_max, free_cells))
    return Draws(**d)


# FilterConfig() as it ships (1500 / 100 / 5000, motion_validity="reject",
# 4 retries) with the exact scorer, in every mode; then the single-program
# flagship (windowed corr, 32 theta bins, coarse fallback ungated, "score")
# at 4096 and its KLD twin with the default build gate of 8
EXACT = dict(initialized=True, initial_pose=(1.0, 1.0, 0.4),
             initial_cov=(0.05, 0.05, 0.1), likelihood_impl="jnp")
FLAGSHIP = dict(mode="AMHAMCL", num_particles=4096, min_particles=4096,
                max_particles=4096, initialized=True,
                initial_pose=(1.0, 1.0, 0.4), initial_cov=(0.3, 0.3, 0.6),
                likelihood_impl="corr", corr_window_cells=128,
                corr_theta_window_bins=32, coarse_gate_escapees=0,
                motion_validity="score", min_injection_prob=0.02)
SCAN_CASES = {
    **{mode: dict(EXACT, mode=mode) for mode in MODES},
    "AMHAMCL_pallas": dict(EXACT, mode="AMHAMCL", likelihood_impl="pallas"),
    "flagship": FLAGSHIP,
    "flagship_kld_gated": dict(FLAGSHIP, min_particles=600, kld_eval_window=0,
                               coarse_gate_escapees=8),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_one_scan_matches_jax_on_shared_draws(house_map, torch_map,
                                              monkeypatch, case):
    """One predict + correct of the JAX step and of the port
    on the same state and draws: count equal; estimate, ESS and the
    bookkeeping scalars to 1e-4; weights to rtol 1e-4 (f32 reductions in
    another order; an ulp of cos/sin can move an exact-scorer endpoint
    across a cell edge); at most 0.5% of the active slots hold another
    particle (a cumsum in another order can move a segment bound by
    one)."""
    monkeypatch.setattr(jres, "_KLD_STAGE1", 1024)
    monkeypatch.setattr(tres, "_KLD_STAGE1", 1024)
    kw = SCAN_CASES[case]
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    poses = np.float32([[1.0, 1.0, 0.4], [1.1, 1.03, 0.5]])
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    jm = jstep.make_model(jcfg, house_map)
    js = jm.init(jax.random.PRNGKey(0))
    js = js.replace(w_slow=jnp.float32(1.0), w_fast=jnp.float32(0.9))
    before = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    js2, jinfo = jm.step(js, scans[1], angles, deltas[1])

    tm = make_model(tcfg, torch_map)
    tm.log_field = torch.from_numpy(np.array(jm.log_field))
    draws = scan_draws(js.key, jcfg, house_map.free_xy.shape[0])
    ts2, tinfo = tm.step(state_from_numpy(before, device="cpu"), _t(scans[1]),
                         _t(angles), _t(deltas[1]), draws)

    count = int(jinfo.count)
    assert int(tinfo.count) == count
    np.testing.assert_allclose(tinfo.estimate.mean.numpy(),
                               np.asarray(jinfo.estimate.mean), atol=1e-4)
    for f in ("ess", "w_slow", "w_fast", "p_random", "anchor_mass",
              "accept_rate"):
        np.testing.assert_allclose(float(getattr(tinfo, f)),
                                   float(getattr(jinfo, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    w_j, w_t = np.asarray(js2.weights), ts2.weights.numpy()
    np.testing.assert_allclose(w_t, w_j, rtol=1e-4, atol=1e-4 * w_j.max())
    p_j, p_t = np.asarray(js2.particles)[:count], ts2.particles.numpy()[:count]
    moved = np.abs(p_j - p_t).max(axis=1) > 1e-4
    assert moved.mean() <= 0.005, moved.mean()
    np.testing.assert_allclose(ts2.anchor.numpy(), np.asarray(js2.anchor),
                               atol=1e-4)
    if not jcfg.use_adaptive:
        # no augmented-MCL bookkeeping outside the adaptive modes
        assert float(tinfo.w_slow) == 1.0
        assert float(tinfo.w_fast) == np.float32(0.9)


# ---------------------------------------------------------------------------
# whole-run twins
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trajectory_data(house_map):
    poses = _square_trajectory()
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    return poses, np.asarray(scans), np.asarray(angles), np.asarray(deltas)


@pytest.mark.parametrize("mode", MODES)
def test_all_modes_track_port(torch_map, trajectory_data, mode):
    """Twin of tests/test_filter.py::test_all_modes_track on the port:
    FilterConfig() semantics (the exact scorer, "reject") at 400 / 64 /
    600 particles; the last 6 scans within 0.25 m; the state invariants."""
    poses, scans, angles, deltas = trajectory_data
    cfg = FilterConfig(
        mode=mode, num_particles=400, min_particles=64, max_particles=600,
        initialized=True, initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
        likelihood_impl="jnp")
    model = make_model(cfg, torch_map)
    state = model.init(0)
    errors = []
    for t in range(len(poses)):
        state, info = model.step(state, _t(scans[t]), _t(angles),
                                 _t(deltas[t]))
        est = info.estimate.mean.numpy()
        errors.append(np.hypot(est[0] - poses[t][0], est[1] - poses[t][1]))
    assert np.mean(errors[-6:]) < 0.25, (mode, errors)
    assert cfg.min_particles <= int(state.count) <= state_size(cfg)
    w = state.weights.numpy()
    assert abs(w.sum() - 1.0) < 1e-4 or not cfg.use_adaptive
    assert (w[~state.active_mask.numpy()] == 0).all()


def _wrap_arr(a):
    return (np.asarray(a) + np.pi) % (2 * np.pi) - np.pi


def test_kidnapped_recovery_windowed_port(house_map, torch_map):
    """Twin of tests/test_corr_field.py::test_kidnapped_recovery_windowed on
    the port: the single-program windowed corr scorer with the coarse
    fallback (default factor 4, 36 bins, build gate 8), AMCL and "reject".
    The JAX test calls the post-kidnap trajectory path-dependent, so the
    twin asserts its four checks on the port's own run: tracking before
    the kidnap, lost at it, injection fired, re-localized.  The near-
    symmetric house makes the kidnap target ambiguous under 5 m scans (the
    JAX test's note): on some seeds the cloud settles in the mirror mode
    about 4-5 m off, so the seed pins a draw stream that re-localizes.
    The stream is the one every graph-capturable config draws (each
    resampling draw at static shape before the gates)."""
    t_a, t_b = 30, 60
    ts_a = np.linspace(0, 1.5 * np.pi, t_a)
    ts_b = np.linspace(0, 3 * np.pi, t_b)
    p_a = np.stack([2.5 + 0.8 * np.cos(ts_a), 2.5 + 0.8 * np.sin(ts_a),
                    _wrap_arr(ts_a + np.pi / 2)], axis=1).astype(np.float32)
    p_b = np.stack([-2.5 + 0.8 * np.cos(ts_b), -2.5 + 0.8 * np.sin(ts_b),
                    _wrap_arr(ts_b + np.pi / 2)], axis=1).astype(np.float32)
    poses = np.concatenate([p_a, p_b])
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    deltas = np.array(deltas)
    deltas[t_a] = deltas[t_a + 1]  # odometry is blind to the teleport
    cfg = FilterConfig(
        mode="AMCL", num_particles=1500, min_particles=200, max_particles=2500,
        initialized=True, initial_pose=tuple(map(float, p_a[0])),
        max_range=5.0, likelihood_impl="corr", corr_n_theta=90,
        corr_window_cells=96, estimate_mode="cluster", alpha_slow=0.05,
        alpha_fast=0.7, ref_compat_kld_newbin_stop=True)
    model = make_model(cfg, torch_map)
    _, infos = model.run(model.init(7), np.asarray(scans), np.asarray(angles),
                         deltas)
    est = infos.estimate.mean.numpy()
    errs = np.hypot(est[:, 0] - poses[:, 0], est[:, 1] - poses[:, 1])
    p_rand = infos.p_random.numpy()
    assert np.mean(errs[t_a - 5:t_a]) < 0.5, errs[t_a - 5:t_a]
    assert errs[t_a] > 3.0, errs[t_a]
    assert p_rand[t_a:t_a + 10].max() > 0.2
    assert np.mean(errs[-8:]) < 0.5, errs[-12:]
