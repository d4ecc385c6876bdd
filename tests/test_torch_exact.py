"""The port's exact likelihood-field scorer (kernel 6, ops/likelihood.py via
models/sensor.py), the motion-validity wrap and the rejection retries of
the motion model against the JAX package on the same inputs and draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.models import motion as jmotion  # noqa: E402
from mcmh_localization_tpu.models import sensor as jsensor  # noqa: E402
from mcmh_localization_tpu.ops.likelihood_pallas import (  # noqa: E402
    likelihood_field_scores_pallas,
)
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.models import motion as tmotion  # noqa: E402
from mcmh_localization_tpu_torch.models import sensor as tsensor  # noqa: E402
from mcmh_localization_tpu_torch.ops import likelihood as tlik  # noqa: E402
from mcmh_localization_tpu_torch.ops.likelihood import endpoint_cells  # noqa: E402
from tests.test_likelihood_pallas import _case  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


def _jax_cells(house_map, particles, ranges, angles, cfg, form):
    """The JAX scorers' endpoint cells: world_to_grid divides by the
    resolution ("jnp"); the Pallas kernel multiplies by f32(1 / res)."""
    if cfg.step > 1:
        ranges, angles = ranges[:: cfg.step], angles[:: cfg.step]
    valid = jnp.isfinite(ranges) & (ranges < cfg.max_range)
    lx, ly = jsensor.scan_endpoints(particles, jnp.where(valid, ranges, 0.0),
                                    angles)
    if form == "jnp":
        return house_map.world_to_grid(lx, ly), valid
    inv = (1.0 / house_map.resolution).astype(jnp.float32)
    return (((lx - house_map.origin[0]) * inv).astype(jnp.int32),
            ((ly - house_map.origin[1]) * inv).astype(jnp.int32)), valid


CASES = {
    # (n, m, seed, config overrides): following tests/test_likelihood_pallas
    "base": (700, 360, 0, {}),
    "step4": (100, 180, 1, dict(step=4)),
    "n513_m90": (513, 90, 2, {}),
    "sum": (700, 360, 3, dict(score_aggregation="sum")),
    # past the 2048 beams the kernel once refused: its beams in two tiles
    "m2160": (200, 2160, 4, {}),
}


_JAX_SCORES = {}


def _check_exact_vs_jax(house_map, torch_map, default_config, case, form):
    n, m, seed, over = CASES[case]
    cfg = default_config.replace(**over)
    particles, ranges, angles = _case(house_map, cfg, n=n, m=m, seed=seed)
    if (case, form) not in _JAX_SCORES:
        if form == "jnp":
            want = jsensor.likelihood_field_scores(particles, ranges, angles,
                                                   house_map, cfg)
        else:
            want = likelihood_field_scores_pallas(particles, ranges, angles,
                                                  house_map, cfg,
                                                  interpret=True)
        _JAX_SCORES[case, form] = np.asarray(want)
    want = _JAX_SCORES[case, form]
    got = tsensor.likelihood_field_scores(
        _t(particles), _t(ranges), _t(angles), torch_map, cfg,
        cell_div=form == "jnp").numpy()

    (mx_j, my_j), valid = _jax_cells(house_map, particles, ranges, angles,
                                     cfg, form)
    # the port scorer's own beam endpoints (models/sensor.py)
    aa = _t(np.asarray(angles)[:: cfg.step])
    safe = torch.where(_t(valid), _t(np.asarray(ranges)[:: cfg.step]), 0.0)
    u, v = safe * torch.cos(aa), safe * torch.sin(aa)
    scale = torch_map.res if form == "jnp" else torch_map.inv_res
    mx_t, my_t = endpoint_cells(_t(particles), u, v, *torch_map.origin_xy,
                                scale, form == "jnp")
    same = (mx_t.numpy() == np.asarray(mx_j)) & (my_t.numpy() == np.asarray(my_j))
    assert same.mean() >= 0.9999, same.mean()

    clean = same.all(axis=1)
    cnt = max(int(np.asarray(valid).sum()), 1)
    lf_step = 14.0 / (cnt if cfg.score_aggregation == "mean" else 1)
    np.testing.assert_allclose(got[clean], want[clean], rtol=1e-5, atol=1e-5)
    moved = (~same).sum(axis=1)
    assert (np.abs(got - want) <= 1e-5 * (1 + np.abs(want))
            + moved * lf_step).all()


@pytest.mark.parametrize("form", ["jnp", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_exact_scores_match_jax(house_map, torch_map, default_config, case,
                                form):
    """Both cell forms vs JAX's "jnp" scorer (form "jnp") or its Pallas
    kernel in interpret mode (form "pallas").  Endpoint cells agree on at
    least 99.99% of (particle, beam) pairs (torch's and XLA's cos/sin differ
    by an ulp on a few percent of headings, which can move an endpoint
    across a cell edge); scores agree to rtol 1e-5 (f32 sums of M log
    values in another order) except on particles with a moved cell, which
    may differ by the field step of those beams over the beam count."""
    _check_exact_vs_jax(house_map, torch_map, default_config, case, form)


LANES = [1, 2, 4, 8, 16, 32]


@pytest.mark.parametrize("form", ["jnp", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("lanes", LANES)
def test_exact_scores_match_jax_at_every_lane_count(
        house_map, torch_map, default_config, monkeypatch, lanes, case, form):
    """test_exact_scores_match_jax's twin with the beam sum in the order of
    G lanes a pose (``lanes_per_particle`` pinned to G): the same
    tolerances hold at every G."""
    monkeypatch.setattr(tlik, "lanes_per_particle", lambda n: lanes)
    _check_exact_vs_jax(house_map, torch_map, default_config, case, form)


def _numpy_lane_scores(parts, u, v, valid, field, origin, scale, div, lanes):
    """The exact scorer's beam sums as a numpy f32 loop in the kernel's
    order: the valid beams compacted in ascending order, lane g of G adding
    beams g, g + G, ... from +0.0 (an off-map beam adds nothing), then the
    xor butterfly.  cos/sin of the heading are torch's (numpy's may differ
    by an ulp)."""
    th = _t(parts[:, 2])
    c, s = torch.cos(th).numpy(), torch.sin(th).numpy()
    x, y = parts[:, 0], parts[:, 1]
    f32 = np.float32
    h, w = field.shape
    acc = np.zeros((parts.shape[0], lanes), np.float32)
    for k, j in enumerate(np.flatnonzero(valid)):
        lx = (x + c * u[j]) - s * v[j]
        ly = (y + s * u[j]) + c * v[j]
        dx, dy = lx - f32(origin[0]), ly - f32(origin[1])
        if div:
            mx, my = (dx / f32(scale)).astype(np.int32), (dy / f32(scale)).astype(np.int32)
        else:
            mx, my = (dx * f32(scale)).astype(np.int32), (dy * f32(scale)).astype(np.int32)
        inside = (mx >= 0) & (mx < w) & (my >= 0) & (my < h)
        val = field[np.clip(my, 0, h - 1), np.clip(mx, 0, w - 1)]
        acc[:, k % lanes] = np.where(inside, acc[:, k % lanes] + val,
                                     acc[:, k % lanes])
    while lanes > 1:
        lanes //= 2
        acc = acc[:, :lanes] + acc[:, lanes:]
    return acc[:, 0]


@pytest.mark.parametrize("form", ["jnp", "pallas"])
@pytest.mark.parametrize("lanes", LANES)
def test_plain_sum_order_matches_numpy_loop(house_map, torch_map,
                                            default_config, lanes, form):
    """The plain version of kernel 6 at G lanes a pose, bitwise equal to a
    numpy f32 loop in the stated order ("sum"), and that sum over the beam
    count ("mean"), on a scan with invalid beams, beams off the map and
    step=4."""
    cfg = default_config.replace(step=4)
    particles, ranges, angles = _case(house_map, cfg, n=301, m=360, seed=7)
    parts = np.asarray(particles)
    rr, aa = np.asarray(ranges)[::4], np.asarray(angles)[::4]
    valid = np.isfinite(rr) & (rr < cfg.max_range)
    safe = _t(np.where(valid, rr, 0.0).astype(np.float32))
    u = (safe * torch.cos(_t(aa))).numpy()
    v = (safe * torch.sin(_t(aa))).numpy()
    div = form == "jnp"
    scale = torch_map.res if div else torch_map.inv_res
    field = tsensor.log_likelihood_field(torch_map, cfg)
    want = _numpy_lane_scores(parts, u, v, valid, field.numpy(),
                              torch_map.origin_xy, scale, div, lanes)
    cnt = int(valid.sum())
    args = (_t(parts), _t(u), _t(v), _t(valid), field, *torch_map.origin_xy,
            scale, div, torch.tensor(cnt, dtype=torch.int32))
    got = tlik.likelihood_scores_plain(*args, "sum", lanes=lanes).numpy()
    np.testing.assert_array_equal(got, want)
    mean = tlik.likelihood_scores_plain(*args, "mean", lanes=lanes).numpy()
    np.testing.assert_array_equal(mean, want / np.float32(cnt))
    # the case holds invalid beams and valid beams that leave the map
    mx, my = endpoint_cells(_t(parts), _t(u[valid]), _t(v[valid]),
                            *torch_map.origin_xy, scale, div)
    h, w = field.shape
    off = (mx < 0) | (mx >= w) | (my < 0) | (my >= h)
    assert (~valid).any() and off.any() and (~off).any()


def test_lanes_per_particle_rule():
    """G is a power of two in [1, 32], nonincreasing in N, and takes the
    values PERF.md records at the exact path's two shapes."""
    prev = 32
    for n in [1, 2, 100, 1500, 3000, 8192, 8193, 65536, 131072, 200_000,
              262_144, 1_000_000, 2_000_000]:
        g = tlik.lanes_per_particle(n)
        assert g in (1, 2, 4, 8, 16, 32) and g <= prev, (n, g)
        prev = g
    assert tlik.lanes_per_particle(2 * 1500) == 32
    assert tlik.lanes_per_particle(2 * 100_000) == 2


def test_scan_endpoints_match_jax(house_map, default_config):
    """World beam endpoints: the same op order on both sides; cos/sin of
    the heading and the angles differ by an ulp on 5% of inputs, which
    over a 6 m beam and the sums' rounding at |l| < 10 m is a few ulps of
    the endpoint: 4e-6 m."""
    particles, ranges, angles = _case(house_map, default_config, n=300,
                                      m=90, seed=5)
    want = jsensor.scan_endpoints(particles, ranges, angles)
    got = tsensor.scan_endpoints(_t(particles), _t(ranges), _t(angles))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=4e-6)


@pytest.mark.parametrize("form", ["jnp", "pallas"])
def test_exact_blind_scan(torch_map, default_config, form):
    """No valid beam: every particle takes the blind penalty."""
    got = tsensor.likelihood_field_scores(
        torch.zeros((4, 3)), torch.full((64,), float("inf")),
        torch.linspace(-np.pi, np.pi, 64), torch_map, default_config,
        cell_div=form == "jnp").numpy()
    np.testing.assert_array_equal(got, np.full(4, -50.0, np.float32))


@pytest.mark.parametrize("form", ["jnp", "pallas"])
@pytest.mark.parametrize("lanes", LANES)
def test_exact_blind_scan_at_every_lane_count(torch_map, default_config,
                                              monkeypatch, lanes, form):
    """No valid beam gives the blind penalty at every G."""
    monkeypatch.setattr(tlik, "lanes_per_particle", lambda n: lanes)
    got = tsensor.likelihood_field_scores(
        torch.zeros((37, 3)), torch.full((64,), float("inf")),
        torch.linspace(-np.pi, np.pi, 64), torch_map, default_config,
        cell_div=form == "jnp").numpy()
    np.testing.assert_array_equal(got, np.full(37, -50.0, np.float32))


@pytest.mark.parametrize("aggregation", ["mean", "sum"])
def test_wrap_score_with_validity_matches_jax(house_map, torch_map,
                                              default_config, aggregation):
    """Non-free poses take INVALID_SCORE (times the valid-beam count under
    "sum"); free poses keep the wrapped scorer's score (the same stub on
    both sides, so the comparison isolates the wrap)."""
    cfg = default_config.replace(score_aggregation=aggregation, step=2)
    particles, ranges, angles = _case(house_map, cfg, n=600, m=90, seed=4)
    stub = np.random.default_rng(4).normal(size=600).astype(np.float32)
    want = np.asarray(jsensor.wrap_score_with_validity(
        lambda p: jnp.asarray(stub), house_map, cfg, ranges)(particles))
    got = tsensor.wrap_score_with_validity(
        lambda p: _t(stub), torch_map, cfg, _t(ranges))(_t(particles)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want <= -100.0).any() and (want > -100.0).any()


def test_sample_motion_with_retries_matches_jax(house_map, torch_map):
    """motion_validity="reject": the first of 4 draws on a free cell, else
    the old pose, on the same normals (retries, N, 3).  Poses straddle the
    walls and the noise is wide, so all three outcomes occur.  cos/sin ulps
    can move a candidate across a cell edge and flip its validity: at most
    0.1% of particles may pick another draw; the rest agree to 2e-6."""
    rng = np.random.default_rng(6)
    n = 6000
    parts = np.stack([rng.uniform(-4.6, 4.6, n), rng.uniform(-4.6, 4.6, n),
                      rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    delta = np.float32([0.3, 0.4, -0.2])
    alpha = (0.2, 0.3, 0.8, 0.2)
    key = jax.random.PRNGKey(8)
    want = np.asarray(jmotion.sample_motion(
        key, jnp.asarray(parts), jnp.asarray(delta), alpha, house_map,
        retries=4, rng_impl="threefry"))
    noise = jax.random.normal(key, (4, n, 3), jnp.float32)
    got = tmotion.sample_motion(_t(parts), _t(delta), alpha, noise=_t(noise),
                                grid_map=torch_map, retries=4).numpy()
    d = np.abs(got - want)
    d[:, 2] = np.minimum(d[:, 2], 2 * np.pi - d[:, 2])
    off = d.max(axis=1) > 2e-6
    assert off.mean() <= 1e-3, off.mean()
    kept = (want == parts).all(axis=1)
    first_ok = np.asarray(house_map.is_free_world(
        jnp.asarray(want[:, 0]), jnp.asarray(want[:, 1])))
    assert kept.any() and (~kept & first_ok).any()
