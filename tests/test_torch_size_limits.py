"""The port's size limits on the card: the beam LUT field's launch plan
(kernel 7 sums K in chunks of bins that fit a block's shared memory) and
the beam tiles of the exact scorer (kernel 6) and the fused scan scorers
(kernel 2's forms (a) and (b)), whose plain versions are held to the JAX
package past the beam counts the kernels once refused."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.models import range_table as jrt  # noqa: E402
from mcmh_localization_tpu.models.sensor3d import (  # noqa: E402
    lidar3d_scores as j_lidar3d_scores,
)
from mcmh_localization_tpu.ops.beam_field_pallas import (  # noqa: E402
    lut_field as j_lut_field,
)
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.models.sensor3d import lidar3d_scores  # noqa: E402
from mcmh_localization_tpu_torch.ops import likelihood as tlik  # noqa: E402
from mcmh_localization_tpu_torch.ops import scan_scores  # noqa: E402
from mcmh_localization_tpu_torch.ops.beam_field import (  # noqa: E402
    LUT_CHUNK_BLOCKS,
    MAX_SMEM_BYTES,
    SM_SMEM_BYTES,
    lut_chunks,
    lut_field_plain,
    lut_plan,
    lut_smem_bytes,
)
from tests.test_torch_lidar3d import rooms  # noqa: E402,F401
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401
from tests.test_torch_range_table import (  # noqa: E402
    _scan,
    _table_plain,
    box_maps,  # noqa: F401
)

LANES = (1, 2, 4, 8, 16, 32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# F1: kernel 7's launch plan
# ---------------------------------------------------------------------------

# (B, C) of the step's builds: the fine field over a 64- or 128-cell window
# (B = the theta window's 24 or 32 bins, or every bin K when it has none),
# the coarse field over the 384^2 house's 96^2 block centres at 24 or 36
# bins
def _geometries(k):
    return ([(b, win * win) for b in (24, 32, k) for win in (64, 128)]
            + [(b, 96 * 96) for b in (24, 36)])


@pytest.mark.parametrize("k", [96, 360, 720])
def test_lut_plan_fits_and_covers_every_bin_once(k):
    """Every plan ``lut_field`` takes for the step's fine and coarse builds
    at K = 96, 360 and 720 bins and nq = 11..127 levels fits a block's
    shared memory; its chunks cover the bins 0..K-1 once each, in
    ascending order, in equal chunks (the last shorter) small enough for
    LUT_CHUNK_BLOCKS blocks an SM; all K where they fit."""
    chunked = 0
    for b, c in _geometries(k):
        for nq in range(11, 128):
            tile, chunk = lut_plan(b, k, nq, c)
            assert lut_smem_bytes(chunk, nq, tile) <= MAX_SMEM_BYTES
            if lut_smem_bytes(k, nq, tile) <= MAX_SMEM_BYTES:
                assert chunk == k
                continue
            chunked += 1
            ranges = lut_chunks(k, chunk)
            assert [g for g0, g1 in ranges for g in range(g0, g1)] == list(
                range(k))
            assert all(g1 - g0 == chunk for g0, g1 in ranges[:-1])
            # the fewest chunks small enough for LUT_CHUNK_BLOCKS blocks an
            # SM, of a multiple of 4 bins where one lies between the even
            # split and the most bins that fit
            budget = SM_SMEM_BYTES // LUT_CHUNK_BLOCKS - 1024
            fit = max(g for g in range(1, k + 1)
                      if lut_smem_bytes(g, nq, tile) <= budget)
            n = -(-k // fit)
            assert len(ranges) == n
            assert LUT_CHUNK_BLOCKS * (lut_smem_bytes(chunk, nq, tile)
                                       + 1024) <= SM_SMEM_BYTES
            even = -(-k // n)
            assert chunk % 4 == 0 or -(-even // 4) * 4 > fit
    # K = 360 at the default max_range (nq = 51) is chunked, K = 96 never
    assert (chunked > 0) == (k > 96)
    if k == 360:
        plan = lut_plan(360, 360, 51, 128 * 128)
        assert lut_smem_bytes(360, 51, plan.tile) == 385_920
        assert (plan.chunk, LUT_CHUNK_BLOCKS) == (52, 4)


def test_lut_plan_raises_only_where_one_bin_does_not_fit():
    with pytest.raises(ValueError, match="one bin needs"):
        lut_plan(8, 4, 40_000, 4096)
    assert lut_plan(8, 4, 14_000, 4096).chunk >= 1


def test_lut_field_plain_at_the_default_table_bins_vs_jax():
    """The plain version at K = 360 (the default ``beam_table_n_theta``,
    whose LUTs the kernel sums in seven chunks of 52 bins) equals a numpy
    loop of f32 adds over the chunks in ascending g bitwise, and the JAX
    kernel (interpret mode, int8 planes of s) within its quantization bound
    K * amax|s| / (127 * 254), as tests/test_torch_range_table.py holds it
    at K = 96."""
    rng = np.random.default_rng(1)
    b, k, nq, c = 4, 360, 51, 300
    qt = rng.integers(0, nq, (k, c)).astype(np.int8)
    s = (rng.normal(size=(b, k, nq)) * 8.0).astype(np.float32)
    acc = np.zeros((b, c), np.float32)
    for g0, g1 in lut_chunks(k, lut_plan(360, k, nq, 128 * 128).chunk):
        for g in range(g0, g1):
            acc = (acc + s[:, g, :][:, qt[g].astype(np.int64)]).astype(
                np.float32)
    got = lut_field_plain(_t(qt), _t(s)).numpy()
    np.testing.assert_array_equal(got, acc)
    tpu = np.asarray(j_lut_field(jnp.asarray(qt), jnp.asarray(s), nq,
                                 precision="int8", interpret=True))
    assert np.abs(tpu - got).max() <= k * np.abs(s).max() / (127 * 254)


# ---------------------------------------------------------------------------
# F2: the beam tiles of kernels 6 and 2
# ---------------------------------------------------------------------------

def _tiled_lane_sum(contrib, live, tile, lanes):
    """The kernels' tiled beam sum, in numpy f32: raw beams in tiles of
    ``tile``, each tile's live beams compacted; lane g adds the live beams
    whose rank among all live beams is g mod G, in ascending order, the
    ranks before a tile carried as a running base; then the xor
    butterfly."""
    n, m = contrib.shape
    acc = np.zeros((n, lanes), np.float32)
    base = 0
    for t0 in range(0, m, tile):
        cols = np.flatnonzero(live[t0:t0 + tile]) + t0
        for j in range(len(cols)):
            g = (base + j) % lanes
            acc[:, g] = (acc[:, g] + contrib[:, cols[j]]).astype(np.float32)
        base += len(cols)
    while lanes > 1:
        lanes //= 2
        acc = (acc[:, :lanes] + acc[:, lanes:]).astype(np.float32)
    return acc[:, 0]


@pytest.mark.parametrize("m", [2160, 4096, 32768])
def test_beam_tiles_keep_the_lane_sum_order(m):
    """Every beam tile is a multiple of every G the dispatch picks, and the
    kernels' tiled sum (``_tiled_lane_sum``) equals ``lane_sum`` over the
    compacted valid beams bitwise at every G: a scan of any length takes
    the sums of one tile, so the plain versions stay as they are."""
    tiles = (tlik.BEAM_TILE, scan_scores.TABLE_TILE, scan_scores.VOXEL_TILE)
    for g in LANES:
        assert all(t % g == 0 for t in tiles)
    assert {tlik.lanes_per_particle(n) for n in (1, 3000, 200_000, 2_000_000)
            } | {scan_scores.voxel_lanes(n) for n in (1, 40_000, 200_000)} \
        <= set(LANES)
    rng = np.random.default_rng(m)
    contrib = (rng.normal(size=(6, m)) * 3.0).astype(np.float32)
    live = rng.random(m) < 0.7
    live[:40] = True
    for g in LANES:
        want = tlik.lane_sum(_t(contrib[:, live]), g).numpy()
        for tile in tiles:
            np.testing.assert_array_equal(
                _tiled_lane_sum(contrib, live, tile, g), want)


@pytest.mark.parametrize("lanes", [1, 2, 32])
@pytest.mark.parametrize("form", ["jnp", "pallas"])
@pytest.mark.parametrize("aggregation", ["mean", "sum"])
def test_exact_scores_at_4096_beams_match_jax(house_map, default_config,
                                              aggregation, form, lanes,
                                              monkeypatch):
    """Kernel 6's plain version on a 4096-beam scan (the kernel stages it
    in two tiles of 2048) in G lanes' order against JAX's "jnp" scorer or
    its Pallas kernel in interpret mode, as
    tests/test_torch_exact.py::test_exact_scores_match_jax holds them at
    360 beams: cells equal on 99.99% of pairs; rows whose cells all agree
    within rtol 1e-5, or the recursive sum's bound of M valid terms in two
    f32 orders (about M * 2^-24 of the total) where that is larger; a row
    with a moved cell within the field step of its moved beams."""
    from mcmh_localization_tpu.models import sensor as jsensor
    from mcmh_localization_tpu.ops.likelihood_pallas import (
        likelihood_field_scores_pallas,
    )
    from mcmh_localization_tpu_torch.convert import grid_map_from_numpy
    from mcmh_localization_tpu_torch.models import sensor as tsensor
    from tests.test_likelihood_pallas import _case
    from tests.test_torch_exact import _jax_cells

    monkeypatch.setattr(tlik, "lanes_per_particle", lambda n: lanes)
    cfg = default_config.replace(score_aggregation=aggregation)
    particles, ranges, angles = _case(house_map, cfg, n=120, m=4096, seed=9)
    if form == "jnp":
        want = jsensor.likelihood_field_scores(particles, ranges, angles,
                                               house_map, cfg)
    else:
        want = likelihood_field_scores_pallas(particles, ranges, angles,
                                              house_map, cfg, interpret=True)
    want = np.asarray(want)
    tm = grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")
    got = tsensor.likelihood_field_scores(
        _t(particles), _t(ranges), _t(angles), tm, cfg,
        cell_div=form == "jnp").numpy()
    (mx_j, my_j), valid = _jax_cells(house_map, particles, ranges, angles,
                                     cfg, form)
    aa = _t(np.asarray(angles))
    safe = torch.where(_t(valid), _t(np.asarray(ranges)), 0.0)
    u, v = safe * torch.cos(aa), safe * torch.sin(aa)
    scale = tm.res if form == "jnp" else tm.inv_res
    mx_t, my_t = tlik.endpoint_cells(_t(particles), u, v, *tm.origin_xy,
                                     scale, form == "jnp")
    same = ((mx_t.numpy() == np.asarray(mx_j))
            & (my_t.numpy() == np.asarray(my_j)))
    assert same.mean() >= 0.9999, same.mean()
    cnt = int(np.asarray(valid).sum())
    rtol = max(1e-5, cnt * 2.0 ** -24)
    clean = same.all(axis=1)
    np.testing.assert_allclose(got[clean], want[clean], rtol=rtol, atol=1e-5)
    lf_step = 14.0 / (cnt if aggregation == "mean" else 1)
    moved = (~same).sum(axis=1)
    assert (np.abs(got - want) <= rtol * (1 + np.abs(want))
            + moved * lf_step).all()


@pytest.mark.parametrize("m", [2160, 4096])
@pytest.mark.parametrize("aggregation", ["mean", "sum"])
def test_table_scores_plain_past_the_old_cap_matches_jax(box_maps, m,
                                                         aggregation):
    """Form (a)'s plain version on a scan of 2160 or 4096 beams (the kernel
    refused more than 2048) against JAX's ``raycast_table_scores``, at
    test_table_scores_plain_matches_jax's tolerance (rtol 1e-5, atol 1e-5 *
    13.82: exp and log an ulp apart, the beam sum in another order).  A
    "sum" of M valid terms in two f32 orders differs within the recursive
    sum's bound, about M * 2^-24 of the total (at 60 beams below 1e-5), so
    its rtol is that."""
    jm, tm = box_maps
    cfg = dict(max_range=2.0, sigma_hit=0.1, beam_table_n_theta=36,
               score_aggregation=aggregation)
    table_cm = np.asarray(jrt.table_cell_major(jrt.build_range_table(jm, 36,
                                                                     2.0)))
    ranges, angles = _scan(jm, (0.3, -0.4, 0.7), m, 2.0)
    rng = np.random.default_rng(m)
    parts = np.stack([rng.uniform(-1.4, 1.4, 64), rng.uniform(-1.4, 1.4, 64),
                      rng.uniform(-np.pi, np.pi, 64)], 1).astype(np.float32)
    want = np.asarray(jrt.raycast_table_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles), jm,
        JConfig(**cfg), jnp.asarray(table_cm), 36))
    valid = int((np.isfinite(ranges) & (ranges < 2.0)).sum())
    rtol = max(1e-5, valid * 2.0 ** -24) if aggregation == "sum" else 1e-5
    for lanes in (1, 32):
        got = _table_plain(tm, FilterConfig(**cfg), table_cm, parts, ranges,
                           angles, lanes=lanes).numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * 13.82)


@pytest.mark.parametrize("m", [4096, 32768])
def test_lidar3d_scores_past_the_old_cap_match_jax(rooms, m):  # noqa: F811
    """Form (b) through ``lidar3d_scores`` on a scan of 4096 or 32 768 beams
    (32 rings x 1024; the kernel refused more than 14 336) against JAX's
    scorer on the CPU, at test_lidar3d_scores_match_numpy_loop's tolerance
    (2e-5: cos, sin, exp and log an ulp apart, the sum in another order)."""
    jroom, troom = rooms
    rng = np.random.default_rng(m)
    parts = np.stack([rng.uniform(-3, 3, 8), rng.uniform(-3, 3, 8),
                      rng.uniform(-np.pi, np.pi, 8)], 1).astype(np.float32)
    dirs = np.stack([rng.uniform(-np.pi, np.pi, m),
                     rng.uniform(-0.3, 0.3, m)], 1).astype(np.float32)
    ranges = rng.uniform(0.5, 4.5, m).astype(np.float32)
    ranges[::7] = np.inf
    kw = dict(max_range=5.0, sigma_hit=0.2, step=1, score_aggregation="mean")
    want = np.asarray(j_lidar3d_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(dirs), jroom,
        JConfig(**kw), sensor_z=1.0))
    got = lidar3d_scores(_t(parts), _t(ranges), _t(dirs), troom,
                         FilterConfig(**kw), sensor_z=1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
