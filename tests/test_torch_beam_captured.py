"""The beam model's capturable forms on the CPU against the JAX package:
the score field at a window origin held in a device tensor (the corner
clamped on the device, the theta window's first bin read from it) equal,
bitwise, to the field at the same origin given as ints, and to JAX's
``beam_field_scores``; the coarse build's escapee gate (``run_if``) on both
sides against JAX's; one step through each side of the gate on JAX's
draws; and the bin-LUT kernel's and kernel 7's ``_at`` entry's plain
versions.  The CUDA graph itself runs only on the card:
``chip_smoke.py``'s ``[graph]`` rows check it there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter import step as jstep  # noqa: E402
from mcmh_localization_tpu.models import range_table as jrt  # noqa: E402
from mcmh_localization_tpu.ops import resampling as jres  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import (  # noqa: E402
    STATE_FIELDS,
    beam_tables_from_numpy,
    state_from_numpy,
)
from mcmh_localization_tpu_torch.filter.step import make_model  # noqa: E402
from mcmh_localization_tpu_torch.models import range_table as trt  # noqa: E402
from mcmh_localization_tpu_torch.ops import resampling as tres  # noqa: E402
from mcmh_localization_tpu_torch.ops.beam_field import (  # noqa: E402
    lut_field,
    lut_field_at,
    lut_field_at_plain,
)
from mcmh_localization_tpu_torch.ops.bin_lut import (  # noqa: E402
    bin_lut,
    bin_lut_plain,
)
from mcmh_localization_tpu_torch.ops.fused_score import (  # noqa: E402
    window_indices,
)
from tests.test_filter import _simulate  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401
from tests.test_torch_range_table import (  # noqa: E402,F401
    LOG_FLOOR_ABS,
    _scan,
    box_maps,
)
from tests.test_torch_single_program import (  # noqa: E402,F401
    scan_draws,
    torch_map,
)


def _t(x):
    return torch.from_numpy(np.array(x))


# the box map is 64 x 64 cells; the window 32 cells, 6 theta bins of 48
WIN, TW, K = 32, 6, 48
ORIGIN_CASES = {
    # the corner below the map: both coordinates clamp to 0 on the device
    "low_clamp": dict(origin=(-7, -3, 20)),
    # past the far side: both clamp to 64 - 32
    "high_clamp": dict(origin=(50, 40, 20)),
    # the theta window's bins wrap past bin 47
    "theta_wrap": dict(origin=(16, 16, 45)),
    # no theta window: a (2,) origin, every table bin from bin 0
    "no_theta_window": dict(origin=(16, 12), tw=0),
}


@pytest.mark.parametrize("impl", ["lut", "dense"])
@pytest.mark.parametrize("case", list(ORIGIN_CASES))
def test_beam_field_device_origin(box_maps, case, impl):
    """``beam_field_scores`` at an int32 origin tensor equals, bitwise, the
    same call at the origin as ints (the corner clamped on the device in
    both: ``field_origin``), under "score" (the occupancy window gathered at
    the device-held corner); and JAX's dense build at that origin within
    the tolerance of test_torch_range_table.py::
    test_beam_field_scores_match_jax_dense (rtol 1e-5, atol 1e-5 * M *
    13.82 for the fine-scored poses; fills and penalties exact)."""
    spec = ORIGIN_CASES[case]
    jm, tm = box_maps
    tw = spec.get("tw", TW)
    kw = dict(max_range=2.0, sigma_hit=0.1, beam_table_n_theta=K,
              corr_window_cells=WIN, corr_theta_window_bins=tw,
              corr_coarse_factor=0, motion_validity="score")
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    jtab = jrt.make_beam_tables(jm, jcfg)
    ttab = beam_tables_from_numpy(*(None if a is None else np.asarray(a)
                                    for a in jtab), device="cpu")
    m = 60
    ranges, angles = _scan(jm, (0.3, -0.4, 0.7), m, 2.0)
    rng = np.random.default_rng(11)
    n = 600
    parts = np.stack([rng.uniform(-1.7, 1.7, n), rng.uniform(-1.7, 1.7, n),
                      rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    wo = spec["origin"]
    # half the poses in the clamped window's cells and bins
    oy0, ox0 = (min(max(x, 0), 64 - WIN) for x in wo[:2])
    kstart, nbins = (wo[2], tw) if tw else (0, K)
    parts[:300, 0] = -1.6 + (ox0 + rng.uniform(0.5, WIN - 0.5, 300)) * 0.05
    parts[:300, 1] = -1.6 + (oy0 + rng.uniform(0.5, WIN - 0.5, 300)) * 0.05
    parts[:300, 2] = -np.pi + ((kstart + rng.uniform(0.2, nbins - 0.2, 300))
                               % K) * 2 * np.pi / K
    args = (_t(parts), _t(ranges), _t(angles), tm, tcfg, ttab, K)
    got = trt.beam_field_scores(*args, torch.tensor(wo, dtype=torch.int32),
                                impl=impl)
    assert torch.equal(got, trt.beam_field_scores(*args, wo, impl=impl))
    want = np.asarray(jrt.beam_field_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles), jm,
        jcfg, jtab, K, tuple(jnp.int32(x) for x in wo), impl="dense"))
    geo = trt._beam_geometry(tm, K, nbins, WIN, None)
    covered, _, _, in_map = (x.numpy() for x in window_indices(
        _t(parts), geo, torch.tensor([oy0, ox0, kstart], dtype=torch.int32)))
    fine = covered & in_map
    assert fine.sum() >= 250 and (~fine).sum() >= 100
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * m * LOG_FLOOR_ABS)
    np.testing.assert_array_equal(got.numpy()[~fine], want[~fine])
    origin = trt.field_origin(torch.tensor(wo, dtype=torch.int32), 64, 64,
                              WIN, bool(tw), "cpu")
    assert origin.tolist() == [oy0, ox0, kstart]
    if case == "low_clamp":
        assert (oy0, ox0) == (0, 0)
    if case == "high_clamp":
        assert (oy0, ox0) == (64 - WIN, 64 - WIN)


def test_field_origin_is_the_kernels_one_form():
    """``field_origin`` gives each form of origin as the (3,) int32 (oy0,
    ox0, kstart) the kernels read, on the box map (64 x 64 cells, a
    32-cell window): ints clamped into the map as JAX clips them
    (:443-449), kstart kept under a theta window and 0 without one (a
    2-long origin has none); the step's int32 tensor, and a 2-long one,
    give the same numbers, clamped on their device."""
    cases = [  # (origin, theta window, want)
        ((-7, -3, 20), True, [0, 0, 20]),
        ((50, 40, 45), True, [32, 32, 45]),
        ((16, 12, 30), False, [16, 12, 0]),
        ((16, 12), False, [16, 12, 0]),
    ]
    for wo, theta, want in cases:
        got = trt.field_origin(wo, 64, 64, WIN, theta, "cpu")
        assert got.dtype == torch.int32 and got.tolist() == want, wo
        # the step's tensor holds kstart 0 without a theta window
        held = wo if theta or len(wo) == 2 else (*wo[:2], 0)
        t = trt.field_origin(torch.tensor(held, dtype=torch.int32), 64, 64,
                             WIN, theta, "cpu")
        assert t.dtype == torch.int32 and t.tolist() == want, held


def _gate_parts(n_esc: int) -> np.ndarray:
    """600 poses at the window's cells and bins (origin (16, 16, 22) on the
    box map), ``n_esc`` of them moved out of the window but on the map."""
    rng = np.random.default_rng(4)
    n = 600
    parts = np.stack([
        -1.6 + (16 + rng.uniform(1, 31, n)) * 0.05,
        -1.6 + (16 + rng.uniform(1, 31, n)) * 0.05,
        -np.pi + (22 + rng.uniform(0.2, 5.8, n)) * 2 * np.pi / K], 1)
    parts[:n_esc, :2] = rng.uniform(1.0, 1.4, (n_esc, 2))
    return parts.astype(np.float32)


@pytest.mark.parametrize("side", ["below", "above"])
@pytest.mark.parametrize("aggregation", ["mean", "sum"])
def test_beam_coarse_gate_branches_match_jax(box_maps, monkeypatch,
                                             aggregation, side):
    """The coarse build's gate of 8 escapees on both sides, the origin a
    device tensor: 5 escapees skip the build (``run_if``'s untaken branch:
    they take the blind fill, -50 after the "mean" divide), 20 run it; the
    scores match JAX's dense ``beam_field_scores`` with
    ``coarse_gate_escapees=8``: fine-scored poses within rtol 1e-5 and the
    coarse-scored within the int8 bound of JAX's coarse build
    (test_torch_range_table.py::test_beam_field_scores_match_jax_dense)."""
    n_esc = 5 if side == "below" else 20
    jm, tm = box_maps
    kw = dict(max_range=2.0, sigma_hit=0.1, beam_table_n_theta=K,
              corr_window_cells=WIN, corr_theta_window_bins=TW,
              corr_coarse_n_theta=12, score_aggregation=aggregation,
              motion_validity="score", coarse_gate_escapees=8)
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    jtab = jrt.make_beam_tables(jm, jcfg)
    ttab = beam_tables_from_numpy(*(None if a is None else np.asarray(a)
                                    for a in jtab), device="cpu")
    m = 60
    ranges, angles = _scan(jm, (0.3, -0.4, 0.7), m, 2.0)
    parts = _gate_parts(n_esc)
    wo = (16, 16, 22)
    builds = []
    plain = trt._beam_coarse_field
    monkeypatch.setattr(trt, "_beam_coarse_field", lambda *a, **k: (
        builds.append(1), plain(*a, **k))[1])
    got = trt.beam_field_scores(
        _t(parts), _t(ranges), _t(angles), tm, tcfg, ttab, K,
        torch.tensor(wo, dtype=torch.int32)).numpy()
    want = np.asarray(jrt.beam_field_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles), jm,
        jcfg, jtab, K, tuple(jnp.int32(x) for x in wo), impl="dense"))
    assert len(builds) == (0 if side == "below" else 1)
    div = int((np.isfinite(ranges) & (ranges < 2.0)).sum()) \
        if aggregation == "mean" else 1
    esc = np.zeros(len(parts), bool)
    esc[:n_esc] = True
    np.testing.assert_allclose(got[~esc], want[~esc], rtol=1e-5,
                               atol=1e-5 * m * LOG_FLOOR_ABS / div)
    if side == "below":
        # the blind fill reads -50 after the "mean" divide and raw under "sum"
        assert (want[esc] == -50.0).all() and (got[esc] == -50.0).all()
    else:
        bound = K * (-(-m // K) + 1) * LOG_FLOOR_ABS / (127 * 254) / div
        assert np.abs(got[esc] - want[esc]).max() <= bound
        assert (want[esc] != -50.0).all() and (got[esc] != -50.0).all()


# the bench's beam point (tests/test_torch_beam.py's BEAM) at 2048
BEAM = dict(mode="AMHAMCL", num_particles=2048, min_particles=2048,
            max_particles=2048, initialized=True, initial_pose=(1.0, 1.0, 0.4),
            max_range=5.0, sensor_model="beam", beam_impl="field",
            beam_table_n_theta=96, corr_window_cells=64,
            corr_theta_window_bins=24, corr_coarse_n_theta=24,
            motion_validity="score", min_injection_prob=0.02,
            coarse_gate_escapees=8)


@pytest.mark.parametrize("side", ["below", "above"])
def test_beam_gate_step_matches_jax_on_jax_draws(house_map, torch_map,
                                                 monkeypatch, side):
    """One step of the beam point with the build gate of 8 on JAX's draws,
    from a tight cloud (no escapee: the build is skipped) and from a wide
    one (escapees past the gate: it runs), against JAX's step at the
    tolerances of test_torch_beam.py::
    test_one_scan_beam_matches_jax_on_shared_draws: count equal; estimate,
    ESS and the bookkeeping scalars to 1e-4; at most 0.5% of the active
    slots hold another particle."""
    monkeypatch.setattr(jres, "_KLD_STAGE1", 1024)
    monkeypatch.setattr(tres, "_KLD_STAGE1", 1024)
    cov = (0.0004, 0.0004, 0.002) if side == "below" else (0.3, 0.3, 0.6)
    kw = dict(BEAM, initial_cov=cov)
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    poses = np.float32([[1.0, 1.0, 0.4], [1.0, 1.0, 0.4]])
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    jm = jstep.make_model(jcfg, house_map)
    js = jm.init(jax.random.PRNGKey(0))
    before = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    js2, jinfo = jm.step(js, scans[1], angles, deltas[1])

    builds = []
    plain = trt._beam_coarse_field
    monkeypatch.setattr(trt, "_beam_coarse_field", lambda *a, **k: (
        builds.append(1), plain(*a, **k))[1])
    tm = make_model(tcfg, torch_map)
    draws = scan_draws(js.key, jcfg, house_map.free_xy.shape[0])
    ts2, tinfo = tm.step(state_from_numpy(before, device="cpu"), _t(scans[1]),
                         _t(angles), _t(deltas[1]), draws)
    assert len(builds) == (0 if side == "below" else 1)
    count = int(jinfo.count)
    assert int(tinfo.count) == count
    np.testing.assert_allclose(tinfo.estimate.mean.numpy(),
                               np.asarray(jinfo.estimate.mean), atol=1e-4)
    for f in ("ess", "w_slow", "w_fast", "p_random", "anchor_mass",
              "accept_rate"):
        np.testing.assert_allclose(float(getattr(tinfo, f)),
                                   float(getattr(jinfo, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    p_j, p_t = np.asarray(js2.particles)[:count], ts2.particles.numpy()[:count]
    moved = np.abs(p_j - p_t).max(axis=1) > 1e-4
    assert moved.mean() <= 0.005, moved.mean()


@pytest.mark.parametrize("r,m,k,nq", [(24, 360, 96, 51), (1, 360, 96, 51),
                                      (5, 37, 360, 11)],
                         ids=["window_bins", "offset_row", "wide_table"])
def test_bin_lut_plain_vs_loop_and_jax(r, m, k, nq):
    """The bin-LUT kernel's plain version (and the CPU wrapper) bitwise
    equal to a numpy loop over the beams in ascending order with f32 adds,
    empty bins +0.0; JAX's one-hot einsum within f32 sum-order rounding
    (a bin sums at most a few of these |lp| <= 13.82 terms: atol 1e-5)."""
    rng = np.random.default_rng(r + k)
    idx = rng.integers(0, k, (r, m))
    lp = -rng.uniform(0.0, LOG_FLOOR_ABS, (m, nq)).astype(np.float32)
    want = np.zeros((r, k, nq), np.float32)
    for b in range(r):
        for j in range(m):
            want[b, idx[b, j]] = (want[b, idx[b, j]] + lp[j]).astype(np.float32)
    got = bin_lut(_t(idx), _t(lp), k).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bin_lut_plain(_t(idx), _t(lp), k).numpy(),
                                  want)
    jax_s = np.asarray(jrt._bin_lut_matrix(jnp.asarray(idx, jnp.int32),
                                           jnp.asarray(lp), k))
    np.testing.assert_allclose(got, jax_s, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("corner", [(0, 0), (5, 9), (32, 32)])
def test_lut_field_at_plain_vs_window(corner):
    """Kernel 7's ``_at`` entry (its plain version, as the CPU wrapper
    takes it) over a 32-cell window of a (K, 64, 64) table at a device-held
    corner: bitwise ``lut_field`` on the window copied out."""
    rng = np.random.default_rng(sum(corner))
    k, nq, b, win = 24, 51, 6, 32
    qt = _t(rng.integers(0, nq, (k, 64, 64)).astype(np.int8))
    s = _t((rng.normal(size=(b, k, nq)) * 8.0).astype(np.float32))
    oy0, ox0 = corner
    origin = torch.tensor([oy0, ox0, 3], dtype=torch.int32)
    copied = qt[:, oy0:oy0 + win, ox0:ox0 + win].reshape(k, -1).contiguous()
    want = lut_field(copied, s)
    assert torch.equal(lut_field_at(qt, s, origin, win), want)
    assert torch.equal(lut_field_at_plain(qt, s, origin, win), want)
