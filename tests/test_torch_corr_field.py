"""The port's corr scorer (models/corr_field.py) and its fused lookup's
index math against the JAX package on the same inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.models import corr_field as jcf  # noqa: E402
from mcmh_localization_tpu.models.sensor import (  # noqa: E402
    log_likelihood_field as j_log_field,
    raycast as j_raycast,
)
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.models import corr_field as tcf  # noqa: E402
from mcmh_localization_tpu_torch.ops.gather import (  # noqa: E402
    LookupGeometry,
    corr_lookup_indices,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

N_THETA = 48


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


def _scan(house_map, pose, m=90):
    angles = jnp.linspace(-np.pi, np.pi, m).astype(jnp.float32)
    p = jnp.asarray(pose, jnp.float32)
    ranges = j_raycast(p[:2], p[2] + angles, house_map, 5.0, hit_unknown=True)
    ranges = ranges.at[::11].set(jnp.inf)      # a few invalid beams
    return np.array(ranges), np.array(angles)


def _particles(n, seed, center=(1.0, 1.0)):
    """Poses around ``center`` plus some out of the map, headings across
    the wrap."""
    rng = np.random.default_rng(seed)
    p = np.stack([center[0] + rng.normal(0, 0.6, n),
                  center[1] + rng.normal(0, 0.6, n),
                  rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)
    p[:8, :2] = [[-6.0, 0.0], [6.0, 1.0], [0.0, -7.0], [0.5, 9.0],
                 [-4.79, -4.79], [4.79, 4.79], [-4.8, 0.0], [0.0, 4.8]]
    p[8:12, 2] = [-np.pi, np.float32(np.pi) - 1e-7, 0.0, -1e-7]
    return p


def _jax_offsets(house_map, cfg, ranges, angles, n_theta, kstart, nbins):
    """corr_field.py:341-373 as the JAX scorer computes them."""
    valid = jnp.isfinite(ranges) & (ranges < cfg.max_range)
    res = float(jax.device_get(house_map.resolution))
    pad = int(-(-cfg.max_range // res)) + 2
    safe_r = jnp.where(valid, ranges, 0.0)
    u = (safe_r * jnp.cos(angles)).astype(jnp.float32)
    v = (safe_r * jnp.sin(angles)).astype(jnp.float32)
    zrow = house_map.occupancy.shape[0] + 2 * pad
    return jcf._bin_offsets(u, v, valid, 1.0 / house_map.resolution, n_theta,
                            pad, zrow, bin_start=jnp.int32(kstart),
                            nbins=nbins), (u, v, valid, pad, zrow)


def test_bin_offsets_match_jax_up_to_trig_ulps(house_map, torch_map):
    """cos/sin differ by an ulp between XLA and torch, which can move a
    truncated offset by one cell: at most 0.5% of (k, j) offsets may
    differ, and none by more than one cell.  Compared in beam order
    (``_beam_offsets``); ``_bin_offsets`` is the same offsets ordered for
    the field build."""
    cfg = JConfig(max_range=5.0)
    ranges, angles = _scan(house_map, (1.0, 1.0, 0.4), m=360)
    (ox_j, oy_j), (u, v, valid, pad, zrow) = _jax_offsets(
        house_map, cfg, jnp.asarray(ranges), jnp.asarray(angles), 120, 0, 120)
    args = (torch.from_numpy(np.array(u)), torch.from_numpy(np.array(v)),
            torch.from_numpy(np.array(valid)), torch_map.inv_res, 120, pad,
            zrow)
    ox_t, oy_t = tcf._beam_offsets(*args)
    for got, ordered in zip(tcf._order_beams(ox_t, oy_t, pad),
                            tcf._bin_offsets(*args)):
        assert torch.equal(got, ordered)
    for got, want in ((ox_t.numpy(), np.asarray(ox_j)),
                      (oy_t.numpy(), np.asarray(oy_j))):
        diff = np.abs(got.astype(np.int64) - want)
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 0.005


def _jax_lookup_indices(house_map, parts, window):
    """(tbin, myc, mxc, in_map, covered), in_theta, in_window, the port's
    LookupGeometry arguments and the lookup's window origin tensor (None
    for the full map): the JAX scorer's index math
    (corr_field.py:466-490) for the full map or a 64-cell window at
    (oy0, ox0) with 16 theta bins from kstart."""
    h, w = house_map.occupancy.shape
    win = 64
    pt = jnp.asarray(parts).T
    px, py, pth = pt[0], pt[1], pt[2]
    inv_res = 1.0 / house_map.resolution
    mx = ((px - house_map.origin[0]) * inv_res).astype(jnp.int32)
    my = ((py - house_map.origin[1]) * inv_res).astype(jnp.int32)
    tbin = (((pth + jnp.pi) * (N_THETA / (2.0 * jnp.pi))).astype(jnp.int32)
            % N_THETA)
    in_map = house_map.in_bounds(mx, my)
    if window is None:
        nbins, fh, fw = N_THETA, h, w
        in_theta = jnp.ones_like(in_map)
        in_window = jnp.ones_like(in_map)
        mxc, myc = jnp.clip(mx, 0, fw - 1), jnp.clip(my, 0, fh - 1)
        geo_kw, origin = {}, None
    else:
        oy0, ox0, kstart = window
        nbins, fh, fw = 16, win, win
        k_rel = (tbin - kstart) % N_THETA
        in_theta = k_rel < nbins
        tbin = jnp.where(in_theta, k_rel, 0)
        mxw, myw = mx - ox0, my - oy0
        in_window = (mxw >= 0) & (mxw < fw) & (myw >= 0) & (myw < fh)
        mxc, myc = jnp.clip(mxw, 0, fw - 1), jnp.clip(myw, 0, fh - 1)
        geo_kw = dict(theta_window=True, space_window=True)
        origin = torch.tensor([oy0, ox0, kstart], dtype=torch.int32)
    return ((tbin, myc, mxc, in_map, in_window & in_theta), in_theta,
            in_window, (N_THETA, nbins, fh, fw, h, w), geo_kw, origin)


def _geometry(torch_map, geo_args, geo_kw):
    return LookupGeometry(torch_map.origin_xy[0], torch_map.origin_xy[1],
                          torch_map.inv_res, *geo_args, **geo_kw)


@pytest.mark.parametrize("window", [None, (40, 50, 44)],
                         ids=["full_map", "window_wrapping_theta"])
def test_lookup_index_triples_bitwise(house_map, torch_map, window):
    """The fused lookup's (theta bin, row, col) and masks equal the JAX
    scorer's index math (corr_field.py:466-490) bitwise."""
    parts = _particles(4000, 5)
    want, in_theta, in_window, geo_args, geo_kw, origin = (
        _jax_lookup_indices(house_map, parts, window))
    in_map = want[3]
    got = corr_lookup_indices(torch.from_numpy(parts),
                              _geometry(torch_map, geo_args, geo_kw), origin)
    for name, g, wv in zip(("tbin", "myc", "mxc", "in_map", "covered"),
                           got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv), err_msg=name)
    # the set exercises every branch
    assert not np.asarray(in_map).all()
    if window is not None:
        assert not np.asarray(in_theta).all()
        assert not np.asarray(in_window)[np.asarray(in_map)].all()


@pytest.mark.parametrize("count", [57, 0], ids=["beams", "no_beams"])
@pytest.mark.parametrize("aggregation", ["mean", "sum"])
@pytest.mark.parametrize("window", [None, (40, 50, 44)],
                         ids=["full_map", "window_wrapping_theta"])
def test_corr_lookup_on_a_misaligned_view_bitwise_vs_jax(
        house_map, torch_map, window, aggregation, count):
    """corr_lookup (its plain version on the CPU) on a view of the poses
    12 bytes past an aligned base, 4001 of them (no multiple of the poses a
    thread), equals the JAX scorer's lookup (corr_field.py:466-490 and
    :641-665, XLA gather on the CPU) on the same poses and field bitwise."""
    from mcmh_localization_tpu.models.sensor import BLIND_SCORE, INVALID_SCORE
    from mcmh_localization_tpu.ops.gather_pallas import gather_2d as jgather
    from mcmh_localization_tpu_torch.ops.gather import corr_lookup

    full = _particles(4003, 5)
    view = torch.from_numpy(full)[1:-1]
    assert view.storage_offset() == 3 and view.shape[0] == 4001  # 12 bytes
    (tbin, myc, mxc, in_map, covered), _, _, geo_args, geo_kw, origin = (
        _jax_lookup_indices(house_map, full[1:-1], window))
    _, nbins, fh, fw, _, _ = geo_args
    field = np.random.default_rng(3).normal(
        -40.0, 20.0, (nbins, fh, fw)).astype(np.float32)
    # JAX: the theta-minor table, one gather, the fills (:641-665)
    field_t = jnp.asarray(field).transpose(1, 0, 2).reshape(fh * nbins, fw)
    totals = jnp.where(in_map & covered,
                       jgather(field_t, myc * nbins + tbin, mxc), 0.0)
    cnt = jnp.int32(count)
    score = (totals if aggregation == "sum"
             else totals / jnp.maximum(cnt, 1))
    score = jnp.where(in_map & ~covered, BLIND_SCORE, score)
    pen = (INVALID_SCORE * jnp.maximum(cnt, 1).astype(jnp.float32)
           if aggregation == "sum" else jnp.float32(INVALID_SCORE))
    score = jnp.where(in_map, score, pen)
    want = np.asarray(jnp.where(cnt > 0, score, BLIND_SCORE)
                      .astype(jnp.float32))
    got = corr_lookup(torch.from_numpy(field), view,
                      torch.tensor(count, dtype=torch.int32),
                      _geometry(torch_map, geo_args, geo_kw), aggregation,
                      True, origin=origin).numpy()
    np.testing.assert_array_equal(got, want)
    if count:
        assert (want == INVALID_SCORE * (count if aggregation == "sum" else 1)
                ).any()


@pytest.mark.parametrize("aggregation", ["mean", "sum"])
@pytest.mark.parametrize("mode", ["full_map", "windowed"])
def test_correlation_field_scores_match_jax(house_map, torch_map, mode,
                                            aggregation):
    """Both staged programs' scoring modes on the same log field and the
    same bin offsets (the JAX ones): rtol 1e-5 (f32 field sums in another
    order)."""
    kw = dict(max_range=5.0, likelihood_impl="corr", corr_n_theta=N_THETA,
              motion_validity="score", score_aggregation=aggregation,
              corr_coarse_factor=0)
    if mode == "windowed":
        kw.update(corr_window_cells=64, corr_theta_window_bins=16)
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    ranges, angles = _scan(house_map, (1.0, 1.0, 0.4))
    parts = _particles(3000, 9)
    lf = j_log_field(house_map, jcfg)
    wo = (40, 50, 44) if mode == "windowed" else None
    nbins = 16 if mode == "windowed" else N_THETA
    (ox, oy), _ = _jax_offsets(house_map, jcfg, jnp.asarray(ranges),
                               jnp.asarray(angles), N_THETA,
                               wo[2] if wo else 0, nbins)
    want = np.asarray(jcf.correlation_field_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles),
        house_map, jcfg, log_field=lf, n_theta=N_THETA,
        window_origin=None if wo is None else tuple(jnp.int32(x) for x in wo)))
    got = tcf.correlation_field_scores(
        torch.from_numpy(parts), torch.from_numpy(ranges),
        torch.from_numpy(angles), torch_map, tcfg,
        log_field=torch.from_numpy(np.array(lf)), n_theta=N_THETA,
        window_origin=wo,
        offsets=(torch.from_numpy(np.array(ox)),
                 torch.from_numpy(np.array(oy)))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # blind (out of window) and invalid (out of map) fills both occur
    if mode == "windowed":
        assert (want == -50.0).any()
    assert (want <= -100.0).any()


@pytest.mark.parametrize("coarse", [0, 4], ids=["window", "window_coarse"])
def test_int_origin_scores_as_the_clamped_tensor(house_map, torch_map,
                                                 coarse):
    """An origin of ints past the map's edges, which ``field_origin``
    clamps as JAX clips it, scores bitwise as the clamped origin given as
    the step's int32 tensor, with and without the coarse fallback (kernel
    2's and kernel 5's plain versions): one origin form either way."""
    cfg = FilterConfig(max_range=5.0, likelihood_impl="corr",
                       corr_n_theta=N_THETA, motion_validity="score",
                       score_aggregation="mean", corr_window_cells=64,
                       corr_theta_window_bins=16, corr_coarse_factor=coarse)
    ranges, angles = _scan(house_map, (1.0, 1.0, 0.4))
    scan = (torch.from_numpy(ranges), torch.from_numpy(angles), torch_map, cfg)
    # the house map is 192 x 192 cells: a 64-cell corner clamps to [0, 128];
    # each cloud lies about its clamped window
    for wo, clamped, center in (((150, 140, 44), (128, 128, 44), (3.0, 3.0)),
                                ((-20, -5, 5), (0, 0, 5), (-3.5, -3.5))):
        parts = torch.from_numpy(_particles(2000, 13, center))
        got = tcf.correlation_field_scores(parts, *scan, n_theta=N_THETA,
                                           window_origin=wo)
        want = tcf.correlation_field_scores(
            parts, *scan, n_theta=N_THETA,
            window_origin=torch.tensor(clamped, dtype=torch.int32))
        assert torch.equal(got, want)
        assert (want > -50.0).any()     # poses scored in the window


def test_scorer_own_offsets_and_log_field_close_to_jax(house_map, torch_map):
    """With its own log field and bin offsets (ulp-level trig/exp
    differences), the port's per-beam mean scores stay within 0.01 of
    JAX's for 99% of poses."""
    kw = dict(max_range=5.0, likelihood_impl="corr", corr_n_theta=N_THETA,
              motion_validity="score", corr_coarse_factor=0)
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    ranges, angles = _scan(house_map, (1.0, 1.0, 0.4))
    parts = _particles(2000, 11)
    want = np.asarray(jcf.correlation_field_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles),
        house_map, jcfg, n_theta=N_THETA))
    got = tcf.correlation_field_scores(
        torch.from_numpy(parts), torch.from_numpy(ranges),
        torch.from_numpy(angles), torch_map, tcfg, n_theta=N_THETA).numpy()
    assert np.quantile(np.abs(got - want), 0.99) < 0.01


def test_coarse_fallback_with_window_not_ported(house_map, torch_map):
    """Formerly refused, the coarse out-of-window fallback now scores: an
    escapee at the true pose outscores one by the wall, both beat the blind
    penalty, and with the fallback off or under the build gate both take
    the blind penalty (the port's twin of
    tests/test_corr_field.py::test_corr_coarse_fallback_scores_out_of_window)."""
    ranges, angles = _scan(house_map, (1.0, 1.0, 0.4))
    cfg = FilterConfig(max_range=5.0, corr_window_cells=64,
                       corr_coarse_factor=4, coarse_gate_escapees=1)
    res = 0.05
    ox0 = int((-3.0 - (-4.8)) / res) - 32
    parts = torch.tensor([[1.0, 1.0, 0.4], [-4.75, 2.0, 0.4],
                          [-3.0, -3.0, 0.4]])

    def score(c):
        return tcf.correlation_field_scores(
            parts, torch.from_numpy(ranges), torch.from_numpy(angles),
            torch_map, c, n_theta=64, window_origin=(ox0, ox0)).numpy()

    s = score(cfg)
    assert s[0] > -50.0 and s[1] > -50.0
    assert s[0] > s[1], s
    for off in (cfg.replace(corr_coarse_factor=0),
                cfg.replace(coarse_gate_escapees=3)):
        s_off = score(off)
        assert s_off[0] == -50.0 and s_off[1] == -50.0
        assert s_off[2] == s[2]
