"""The port's range table, per-scan LUT matrices, LUT field (kernel 7's
plain version), beam score field and beam scorers (the range-table
scorer's fused form of kernel 2 among them) against the JAX package on the
same inputs (models/range_table.py, ops/beam_field.py,
ops/scan_scores.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.maps.grid_map import (  # noqa: E402
    build_grid_map as j_build_grid_map,
)
from mcmh_localization_tpu.models import range_table as jrt  # noqa: E402
from mcmh_localization_tpu.models import sensor as jsensor  # noqa: E402
from mcmh_localization_tpu.ops.beam_field_pallas import (  # noqa: E402
    lut_field as j_lut_field,
)
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import (  # noqa: E402
    beam_tables_from_numpy,
    grid_map_from_numpy,
)
from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map  # noqa: E402
from mcmh_localization_tpu_torch.models import range_table as trt  # noqa: E402
from mcmh_localization_tpu_torch.models import sensor as tsensor  # noqa: E402
from mcmh_localization_tpu_torch.ops.beam_field import (  # noqa: E402
    lut_field,
    lut_field_plain,
)
from mcmh_localization_tpu_torch.ops.fused_score import window_indices  # noqa: E402
from mcmh_localization_tpu_torch.filter.step import (  # noqa: E402
    _sensor_table,
    make_model,
)
from mcmh_localization_tpu_torch.ops.scan_scores import (  # noqa: E402
    MAX_TABLE_LEVELS,
    TABLE_LEVEL_MIN_POSES,
    TableGeometry,
    TableLevels,
    table_levels,
    table_scores_plain,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

LOG_FLOOR_ABS = 13.82  # |log(1e-6)|: no per-beam term is larger


def _t(x):
    return torch.from_numpy(np.array(x))


def _box_occupancy():
    """tests/test_range_table.py's 64x64 box: a wall ring at index 2/61 and
    a centre pillar."""
    occ = np.full((64, 64), 0, dtype=np.int8)
    occ[2, 2:62] = 100
    occ[61, 2:62] = 100
    occ[2:62, 2] = 100
    occ[2:62, 61] = 100
    occ[30:34, 30:34] = 100
    return occ


@pytest.fixture(scope="module")
def box_maps():
    occ = _box_occupancy()
    return (j_build_grid_map(occ, resolution=0.05, origin=(-1.6, -1.6),
                             edt_impl="scipy"),
            build_grid_map(occ, 0.05, (-1.6, -1.6), device="cpu"))


@pytest.fixture(scope="module")
def torch_house(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


def _angles(m):
    """Beam angles off the bin edges of every table size used here, so
    both packages' bin formulas place each beam in the same bin."""
    return (np.linspace(-np.pi, np.pi, m, endpoint=False) + 0.01).astype(
        np.float32)


@pytest.mark.parametrize("k_bins,where,hit_unknown", [
    (16, "box", False), (36, "box", False), (36, "house", True)])
def test_range_table_bitwise(box_maps, house_map, torch_house, k_bins, where,
                             hit_unknown):
    """build_range_table, quantize_table, table_cell_major and
    make_beam_tables (the coarse block centres) bitwise equal to JAX: the
    offsets are the same float64 numbers and the march selects exact
    values."""
    jm, tm = box_maps if where == "box" else (house_map, torch_house)
    max_range = 2.0 if where == "box" else 5.0
    want = np.asarray(jrt.build_range_table(jm, k_bins, max_range,
                                            hit_unknown=hit_unknown))
    got = trt.build_range_table(tm, k_bins, max_range,
                                hit_unknown=hit_unknown)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < max_range).any() and (want == np.float32(max_range)).any()
    qt_j, dv_j = jrt.quantize_table(jnp.asarray(want), max_range)
    qt_t, dv_t = trt.quantize_table(got, max_range)
    assert qt_t.dtype == torch.int8
    np.testing.assert_array_equal(qt_t.numpy(), np.asarray(qt_j))
    np.testing.assert_array_equal(dv_t.numpy(), np.asarray(dv_j))
    np.testing.assert_array_equal(dv_t.numpy()[qt_t.numpy().astype(int)], want)
    np.testing.assert_array_equal(trt.table_cell_major(got).numpy(),
                                  np.asarray(jrt.table_cell_major(want)))
    cfg = dict(max_range=max_range, beam_table_n_theta=k_bins)
    if not hit_unknown:
        jt = jrt.make_beam_tables(jm, JConfig(**cfg))
        tt = trt.make_beam_tables(tm, FilterConfig(**cfg))
        for a, b in zip(tt, jt):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tt.qtc.shape == (k_bins, 16, 16)


def _scan(jm, pose, m, max_range):
    angles = _angles(m)
    ranges = np.array(jsensor.raycast(
        jnp.asarray(pose[:2], jnp.float32), pose[2] + jnp.asarray(angles), jm,
        max_range, hit_unknown=True))
    ranges[::7] = np.inf                       # a few invalid beams
    return ranges, angles


def _lut_inputs(box_maps, k_bins, m=60):
    jm, _ = box_maps
    ranges, angles = _scan(jm, (0.3, -0.4, 0.7), m, 2.0)
    cfg = dict(max_range=2.0, sigma_hit=0.1, beam_table_n_theta=k_bins)
    valid = np.isfinite(ranges) & (ranges < 2.0)
    safe_r = np.where(valid, ranges, 0.0).astype(np.float32)
    _, dvals = jrt.quantize_table(jnp.zeros((1, 1, 1)), 2.0)
    lp_j = jrt._beam_lut(jnp.asarray(safe_r), jnp.asarray(valid), dvals,
                         JConfig(**cfg))
    lp_t = trt._beam_lut(_t(safe_r), _t(valid), _t(dvals), FilterConfig(**cfg))
    return np.asarray(lp_j), lp_t, angles


def test_beam_lut_matches_jax(box_maps):
    """The (M, nq) per-beam log mixture within f32 rounding of JAX's
    (exp and log may round an ulp apart); invalid beams exactly 0."""
    lp_j, lp_t, _ = _lut_inputs(box_maps, 48)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-6, atol=1e-6)
    assert (lp_j[::7] == 0).all() and (lp_t.numpy()[::7] == 0).all()


# (k_bins, starts, use_half): the theta window's rolled rows; coarse bins at
# an even (r = 4) and an odd (r = 3) width ratio; and the general matrix
@pytest.mark.parametrize("case", ["theta_window", "coarse_even", "coarse_odd",
                                  "bin_matrix"])
def test_lut_matrices_match_jax(box_maps, case):
    """S matrices within f32 sum-order rounding of JAX's einsums (a bin
    sums at most a few beams of |lp| <= 13.82: atol 1e-5); in the port, the
    rolled form equals the general matrix bitwise where both place every
    beam in the same bin."""
    k_bins = {"theta_window": 48, "coarse_even": 48, "coarse_odd": 36,
              "bin_matrix": 90}[case]
    lp_j, lp_t, angles = _lut_inputs(box_maps, k_bins)
    a_j, a_t = jnp.asarray(angles), _t(angles)
    pi32 = np.float32(np.pi)
    if case == "theta_window":
        kstart, nbins = 45, 6                  # wraps past bin 47
        starts = [kstart + b for b in range(nbins)]
        use_half = True
        centers = ((kstart + np.arange(nbins)).astype(np.float32) + 0.5) * \
            np.float32(2 * np.pi / k_bins) - pi32
    elif case == "bin_matrix":
        nbins = 36
        centers = (np.arange(nbins, dtype=np.float32) + 0.5) * \
            np.float32(2 * np.pi / nbins) - pi32
    else:
        kc = 12
        r = k_bins // kc
        starts = [r * i + (r // 2 if r % 2 == 0 else (r - 1) // 2)
                  for i in range(kc)]
        use_half = r % 2 == 1
        centers = (np.arange(kc, dtype=np.float32) + 0.5) * \
            np.float32(2 * np.pi / kc) - pi32
    g = np.floor((centers[:, None] + angles[None, :] + pi32)
                 / np.float32(2 * np.pi / k_bins)).astype(np.int32) % k_bins
    s_bin = trt._bin_lut_matrix(_t(g), lp_t, k_bins).numpy()
    if case == "bin_matrix":
        want = np.asarray(jrt._bin_lut_matrix(jnp.asarray(g), jnp.asarray(lp_j),
                                              k_bins))
        got = s_bin
    else:
        want = np.asarray(jrt._rolled_bin_lut_matrix(
            jnp.asarray(lp_j), a_j, k_bins, starts, use_half))
        got = trt._rolled_bin_lut_matrix(lp_t, a_t, k_bins,
                                         torch.tensor(starts), use_half).numpy()
        np.testing.assert_array_equal(got, s_bin)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # every valid beam's terms land somewhere in each row
    np.testing.assert_allclose(got.sum(axis=1), np.broadcast_to(
        lp_j.sum(axis=0), (got.shape[0], lp_j.shape[1])), rtol=1e-5, atol=1e-4)


def test_bin_lut_matrix_adds_beams_in_ascending_order():
    """The S matrices' bin sums: bitwise equal to a numpy loop over the
    beams in ascending order with f32 adds (the order on every device),
    with several beams in one bin and empty bins."""
    rng = np.random.default_rng(2)
    r, m, k, nq = 3, 50, 7, 5
    idx = rng.integers(0, k, (r, m))
    idx[1] = 3                                   # every beam in one bin
    lp = (rng.normal(size=(m, nq)) * 9.0).astype(np.float32)
    want = np.zeros((r, k, nq), np.float32)
    for b in range(r):
        for j in range(m):
            want[b, idx[b, j]] = (want[b, idx[b, j]] + lp[j]).astype(np.float32)
    got = trt._bin_lut_matrix(_t(idx), _t(lp), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,k,nq,c", [
    (6, 36, 21, 300),     # a C that is no multiple of 16 (ragged tiles)
    (6, 24, 51, 16 ** 2),  # fine-like: the beam path's nq, a square window
    (4, 24, 51, 24 ** 2),  # coarse-like: block centres of a wider grid
], ids=["ragged", "fine_like", "coarse_like"])
def test_lut_field_plain_bitwise_and_vs_jax_int8(b, k, nq, c):
    """lut_field_plain (and the CPU wrapper) bitwise equal to a numpy loop
    of f32 adds over g in ascending order from 0; the JAX kernel (interpret
    mode, int8 hi/lo planes of s, exact int32 accumulation) within its
    quantization bound K * amax|s| / (127 * 254)."""
    rng = np.random.default_rng(0)
    qt = rng.integers(0, nq, (k, c)).astype(np.int8)
    s = (rng.normal(size=(b, k, nq)) * 8.0).astype(np.float32)
    want = np.zeros((b, c), np.float32)
    for g in range(k):
        want = (want + s[:, g, :][:, qt[g].astype(np.int64)]).astype(np.float32)
    got = lut_field(_t(qt), _t(s)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lut_field_plain(_t(qt), _t(s)).numpy(), want)
    tpu = np.asarray(j_lut_field(jnp.asarray(qt), jnp.asarray(s), nq,
                                 precision="int8", interpret=True))
    bound = k * np.abs(s).max() / (127 * 254)
    assert np.abs(tpu - got).max() <= bound, (np.abs(tpu - got).max(), bound)


def test_lut_tiles_rule():
    """lut_tiles: four b a block over 256 cells where the grid keeps 1.5
    blocks an SM, else two b over 128 cells: the beam path's coarse build
    takes the first, its fine build the second.  The b a block never grows
    as B or C falls; every layout fits the card's shared memory at the beam
    path's K and nq and tiles whole 16-byte rows of qt."""
    from mcmh_localization_tpu_torch.ops import _cuda
    from mcmh_localization_tpu_torch.ops.beam_field import (
        MAX_SMEM_BYTES,
        LutTile,
        lut_smem_bytes,
        lut_tiles,
    )

    assert lut_tiles(24, 64 ** 2) == LutTile(threads=128, bpar=2)
    assert lut_tiles(24, 96 ** 2) == LutTile(threads=256, bpar=4)
    for b in (1, 2, 24, 96):
        prev = None
        for c in (96 ** 2 * 4, 96 ** 2, 64 ** 2, 300, 1):
            tile = lut_tiles(b, c)
            assert tile.threads % 16 == 0
            assert prev is None or tile.bpar <= prev, (b, c, tile)
            if tile.bpar == 4:
                blocks = -(-c // 256) * -(-b // 4)
                assert 2 * blocks >= 3 * _cuda.SM_COUNT
            assert lut_smem_bytes(96, 51, tile) <= MAX_SMEM_BYTES
            prev = tile.bpar
    # a slot rounds K * nq floats up to 16 bytes; a byte of qt a cell and bin
    assert lut_smem_bytes(96, 51, LutTile(128, 2)) == 2 * 96 * 51 * 4 + 96 * 128
    assert lut_smem_bytes(3, 5, LutTile(32, 1)) == 16 * 4 + 3 * 32


# beam-score cases: the coarse fallback off, on and ungated, on with the
# build gate firing, on with the gate skipping the build
COARSE = {"coarse_off": dict(corr_coarse_factor=0),
          "ungated": dict(coarse_gate_escapees=0),
          "gate_fires": dict(coarse_gate_escapees=1),
          "gate_skips": dict(coarse_gate_escapees=10 ** 6)}


@pytest.mark.parametrize("coarse", list(COARSE))
@pytest.mark.parametrize("aggregation,validity", [("mean", "score"),
                                                  ("sum", "reject")])
@pytest.mark.parametrize("k_bins,kc", [(48, 12), (90, 36)],
                         ids=["K48_kc12", "K90_kc36"])
def test_beam_field_scores_match_jax_dense(box_maps, coarse, aggregation,
                                           validity, k_bins, kc):
    """The port's beam field (the LUT build, as the card runs it) vs JAX
    beam_field_scores(impl="dense") on the same tables: fine-scored poses
    within f32 sum-order rounding (rtol 1e-5, atol 1e-5 * M * 13.82 before
    the "mean" divide); coarse-scored poses within the int8 bound of JAX's
    coarse build, which always runs lut_field's int8 planes
    (range_table.py:353): K * amax|S| / (127 * 254), amax|S| <= the most
    beams in one bin times 13.82; fills and penalties exact."""
    jm, tm = box_maps
    kw = dict(max_range=2.0, sigma_hit=0.1, beam_table_n_theta=k_bins,
              corr_window_cells=32, corr_theta_window_bins=6,
              corr_coarse_n_theta=kc, score_aggregation=aggregation,
              motion_validity=validity, **COARSE[coarse])
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    jtab = jrt.make_beam_tables(jm, jcfg)
    ttab = beam_tables_from_numpy(*(None if a is None else np.asarray(a)
                                    for a in jtab), device="cpu")
    m = 60
    ranges, angles = _scan(jm, (0.3, -0.4, 0.7), m, 2.0)
    rng = np.random.default_rng(k_bins)
    n = 400
    parts = np.stack([rng.uniform(-1.7, 1.7, n), rng.uniform(-1.7, 1.7, n),
                      rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    kstart = 22 if k_bins == 48 else 42
    parts[:150, :2] = rng.uniform(-0.8, 0.0, (150, 2))   # the window's cells
    parts[:150, 2] = -np.pi + (kstart + rng.uniform(0, 6, 150)) * 2 * np.pi / k_bins
    wo = (16, 16, kstart)
    want = np.asarray(jrt.beam_field_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles), jm, jcfg,
        jtab, k_bins, tuple(jnp.int32(x) for x in wo), impl="dense"))
    got = trt.beam_field_scores(_t(parts), _t(ranges), _t(angles), tm, tcfg,
                                ttab, k_bins, wo).numpy()
    geo = trt._beam_geometry(tm, k_bins, 6, 32, None)
    origin = torch.tensor([16, 16, kstart], dtype=torch.int32)
    covered, _, _, in_map = (x.numpy() for x in window_indices(_t(parts), geo,
                                                               origin))
    cnt = int((np.isfinite(ranges) & (ranges < 2.0)).sum())
    div = cnt if aggregation == "mean" else 1
    fine = covered & in_map
    escaped = ~covered & in_map
    assert fine.sum() >= 100 and escaped.sum() >= 100 and (~in_map).sum() >= 10
    np.testing.assert_allclose(got[fine], want[fine], rtol=1e-5,
                               atol=1e-5 * m * 13.82 / div)
    np.testing.assert_array_equal(got[~in_map], want[~in_map])
    if coarse in ("coarse_off", "gate_skips"):
        # the blind penalty (or fill) on both sides
        assert (want[escaped] == -50.0).all()
        np.testing.assert_allclose(got[escaped], want[escaped], rtol=1e-6)
    else:
        per_bin = -(-m // k_bins) + 1
        bound = k_bins * per_bin * LOG_FLOOR_ABS / (127 * 254) / div
        err = np.abs(got[escaped] - want[escaped]).max()
        assert err <= bound, (err, bound)
        assert (want[escaped] > -50.0).any()


def test_beam_field_lut_matches_dense_in_port(box_maps):
    """The port's own "dense" form (the JAX CPU form, each beam's mixture
    on the table window) agrees with its LUT build: the same terms summed
    in another order."""
    jm, tm = box_maps
    kw = dict(max_range=2.0, sigma_hit=0.1, beam_table_n_theta=48,
              corr_window_cells=32, corr_theta_window_bins=6,
              corr_coarse_factor=0, score_aggregation="sum")
    tcfg = FilterConfig(**kw)
    tab = trt.make_beam_tables(tm, tcfg)
    ranges, angles = _scan(jm, (0.3, -0.4, 0.7), 60, 2.0)
    rng = np.random.default_rng(7)
    parts = np.stack([rng.uniform(-0.8, 0.0, 200), rng.uniform(-0.8, 0.0, 200),
                      -np.pi + (22 + rng.uniform(0, 6, 200)) * 2 * np.pi / 48],
                     1).astype(np.float32)
    args = (_t(parts), _t(ranges), _t(angles), tm, tcfg, tab, 48, (16, 16, 22))
    lut = trt.beam_field_scores(*args, impl="lut").numpy()
    dense = trt.beam_field_scores(*args, impl="dense").numpy()
    np.testing.assert_allclose(lut, dense, rtol=1e-5, atol=1e-5 * 60 * 13.82)
    assert (lut != -50.0).all()             # every pose read the field


def test_raycast_table_scores_match_jax(box_maps):
    """One table read per (particle, beam) on the same cell-major table:
    the bin and cell indices are the same f32 arithmetic in both packages;
    exp and log round an ulp apart and the beam sum runs in another order
    (rtol 1e-5, atol 1e-5 * 13.82)."""
    jm, tm = box_maps
    k_bins = 36
    cfg = dict(max_range=2.0, sigma_hit=0.1, beam_table_n_theta=k_bins)
    table = jrt.build_range_table(jm, k_bins, 2.0)
    table_cm = np.asarray(jrt.table_cell_major(table))
    ranges, angles = _scan(jm, (0.3, -0.4, 0.7), 60, 2.0)
    rng = np.random.default_rng(3)
    parts = np.stack([rng.uniform(-1.8, 1.8, 300), rng.uniform(-1.8, 1.8, 300),
                      rng.uniform(-np.pi, np.pi, 300)], 1).astype(np.float32)
    for agg in ("mean", "sum"):
        want = np.asarray(jrt.raycast_table_scores(
            jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles), jm,
            JConfig(score_aggregation=agg, **cfg), jnp.asarray(table_cm),
            k_bins))
        got = trt.raycast_table_scores(
            _t(parts), _t(ranges), _t(angles), tm,
            FilterConfig(score_aggregation=agg, **cfg), _t(table_cm),
            k_bins).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 13.82)
    blind = trt.raycast_table_scores(
        _t(parts), _t(np.full(60, np.inf, np.float32)), _t(angles), tm,
        FilterConfig(**cfg), _t(table_cm), k_bins).numpy()
    assert (blind == -50.0).all()


@pytest.fixture(scope="module")
def table_case(box_maps):
    """The box map's 36-bin cell-major table, a 60-beam scan with invalid
    beams and 300 poses, some of them off the map (the map spans +-1.6 m)."""
    jm, _ = box_maps
    table_cm = np.asarray(jrt.table_cell_major(jrt.build_range_table(jm, 36,
                                                                     2.0)))
    ranges, angles = _scan(jm, (0.3, -0.4, 0.7), 60, 2.0)
    rng = np.random.default_rng(5)
    parts = np.stack([rng.uniform(-2.0, 2.0, 300), rng.uniform(-2.0, 2.0, 300),
                      rng.uniform(-np.pi, np.pi, 300)], 1).astype(np.float32)
    return table_cm, ranges, angles, parts


def _table_plain(tm, cfg, table_cm, parts, ranges, angles, lanes=None,
                 chunk=None):
    """Form (a)'s plain version on the beams ``raycast_table_scores``
    passes it (``config.step`` subsampled, valid = finite and in range),
    the table in its level form (``table_levels``) unless given as a
    ``TableLevels``."""
    r, a = _t(ranges[::cfg.step]), _t(angles[::cfg.step])
    valid = torch.isfinite(r) & (r < cfg.max_range)
    geo = TableGeometry(tm.origin_xy[0], tm.origin_xy[1], tm.res, tm.height,
                        tm.width, cfg.beam_table_n_theta)
    table = (table_cm if isinstance(table_cm, tuple)
             else table_levels(_t(table_cm)))
    return table_scores_plain(_t(parts), r, a, valid, table, geo,
                              trt.beam_mixture(cfg), valid.sum(),
                              cfg.score_aggregation, lanes=lanes, chunk=chunk)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("aggregation,step", [
    ("mean", 1), ("sum", 1), ("mean", 4), ("sum", 4)])
def test_table_scores_plain_matches_jax(box_maps, table_case, aggregation,
                                        step, lanes):
    """Kernel 2's fused form (a), the range-table scorer's plain version, at
    every G against JAX's ``raycast_table_scores``: the same f32 cell and
    bin arithmetic; exp and log round an ulp apart and the beam sum runs in
    another order (rtol 1e-5, atol 1e-5 * 13.82).  Off-map poses score 0
    and a blind scan the penalty in both."""
    jm, tm = box_maps
    table_cm, ranges, angles, parts = table_case
    cfg = dict(max_range=2.0, sigma_hit=0.1, beam_table_n_theta=36,
               score_aggregation=aggregation, step=step)
    want = np.asarray(jrt.raycast_table_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles), jm,
        JConfig(**cfg), jnp.asarray(table_cm), 36))
    got = _table_plain(tm, FilterConfig(**cfg), table_cm, parts, ranges,
                       angles, lanes=lanes).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 13.82)
    mx = ((parts[:, 0] + np.float32(1.6)) / np.float32(0.05)).astype(np.int32)
    my = ((parts[:, 1] + np.float32(1.6)) / np.float32(0.05)).astype(np.int32)
    off = (mx < 0) | (mx >= 64) | (my < 0) | (my >= 64)
    assert 10 < off.sum() < 290
    assert (got[off] == 0.0).all() and (want[off] == 0.0).all()
    blind = _table_plain(tm, FilterConfig(**cfg), table_cm, parts,
                         np.full(60, np.inf, np.float32), angles,
                         lanes=lanes).numpy()
    assert (blind == -50.0).all()


@pytest.mark.parametrize("chunk", [1, 7, 300])
def test_table_scores_chunked_equals_unchunked(box_maps, table_case, chunk):
    """The plain version takes a chunk of poses at a time (no whole (N, M)
    array); any chunk gives the unchunked scores bitwise, and the public
    scorer is the plain version on the CPU."""
    jm, tm = box_maps
    table_cm, ranges, angles, parts = table_case
    cfg = FilterConfig(max_range=2.0, sigma_hit=0.1, beam_table_n_theta=36,
                       score_aggregation="sum")
    whole = _table_plain(tm, cfg, table_cm, parts, ranges, angles,
                         chunk=len(parts))
    np.testing.assert_array_equal(
        _table_plain(tm, cfg, table_cm, parts, ranges, angles,
                     chunk=chunk).numpy(), whole.numpy())
    np.testing.assert_array_equal(
        trt.raycast_table_scores(_t(parts), _t(ranges), _t(angles), tm, cfg,
                                 _t(table_cm), 36).numpy(), whole.numpy())


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("where", ["box", "house"])
@pytest.mark.parametrize("k_bins", [96, 360])
def test_table_levels_round_trip_bitwise(box_maps, torch_house, where,
                                         k_bins):
    """Form (a)'s level form of the cell-major range table gives the table
    back bit for bit (``levels[index]``), as uint8 indices into the ray
    march's quantized ranges (at most max_range / RAY_STEP + 1 levels)."""
    tm = box_maps[1] if where == "box" else torch_house
    max_range = 2.0 if where == "box" else 5.0
    table_cm = trt.table_cell_major(trt.build_range_table(tm, k_bins,
                                                          max_range))
    lv = table_levels(table_cm)
    assert lv.table is None and lv.index.dtype == torch.uint8
    assert lv.index.shape == table_cm.shape
    assert 2 <= lv.levels.numel() <= round(max_range / 0.1) + 1
    np.testing.assert_array_equal(
        _bits(lv.levels[lv.index.to(torch.int64)]), _bits(table_cm))


def test_table_levels_keep_signed_zeros_apart():
    """Levels are distinct bit patterns: -0.0 and +0.0 stay two levels, so
    the round trip is bitwise for any table."""
    table = torch.tensor([[0.0, -0.0, 1.5], [1.5, -0.0, 2.0]])
    lv = table_levels(table)
    assert lv.levels.numel() == 4
    np.testing.assert_array_equal(
        _bits(lv.levels[lv.index.to(torch.int64)]), _bits(table))


def _open_hall(cells=256, res=0.1):
    """A 25.6 m hall at 0.1 m with a wall ring and one block: its range
    table at a 30 m max_range holds more than 256 of the multiples of
    0.1 m up to 30."""
    occ = np.zeros((cells, cells), np.int8)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = 100
    occ[80:88, 140:180] = 100
    half = cells * res / 2
    return (j_build_grid_map(occ, resolution=res, origin=(-half, -half),
                             edt_impl="scipy"),
            build_grid_map(occ, res, (-half, -half), device="cpu"))


def _hall_case():
    jm, tm = _open_hall()
    k_bins = 8
    table_cm = trt.table_cell_major(trt.build_range_table(tm, k_bins, 30.0))
    rng = np.random.default_rng(9)
    angles = _angles(40)
    ranges = rng.uniform(0.5, 35.0, 40).astype(np.float32)
    ranges[::9] = np.inf
    parts = np.stack([rng.uniform(-14, 14, 200), rng.uniform(-14, 14, 200),
                      rng.uniform(-np.pi, np.pi, 200)], 1).astype(np.float32)
    return jm, tm, k_bins, table_cm, ranges, angles, parts


@pytest.mark.parametrize("form", ["int16 levels", "f32 per pair"])
@pytest.mark.parametrize("aggregation", ["mean", "sum"])
def test_table_forms_past_the_uint8_cap_match_jax(form, aggregation):
    """A 30 m max_range gives more than 256 levels (the int16 level form;
    the JAX package's int8 ``quantize_table`` refuses it, its table scorer
    does not), and a table of arbitrary f32 values more than
    ``MAX_TABLE_LEVELS`` (the per-pair form): the dispatch picks each from
    the table, none raises, and the scores match JAX's
    ``raycast_table_scores`` (rtol 1e-5, atol 1e-5 * 13.82)."""
    jm, tm, k_bins, table_cm, ranges, angles, parts = _hall_case()
    if form == "f32 per pair":
        noise = np.random.default_rng(2).uniform(0, 0.05, table_cm.shape)
        table_cm = table_cm + torch.from_numpy(noise.astype(np.float32))
    lv = table_levels(table_cm)
    if form == "int16 levels":
        assert 256 < lv.levels.numel() <= MAX_TABLE_LEVELS
        assert lv.index.dtype == torch.int16 and lv.table is None
    else:
        assert lv.index is None and lv.levels is None
        assert lv.table is not None
    cfg = dict(max_range=30.0, sigma_hit=0.2, beam_table_n_theta=k_bins,
               score_aggregation=aggregation)
    want = np.asarray(jrt.raycast_table_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles), jm,
        JConfig(**cfg), jnp.asarray(table_cm.numpy()), k_bins))
    for table in (lv, table_cm):   # the level form, or the f32 table as given
        got = trt.raycast_table_scores(
            _t(parts), _t(ranges), _t(angles), tm, FilterConfig(**cfg),
            table, k_bins).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 13.82)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("aggregation,step", [
    ("mean", 1), ("sum", 1), ("mean", 4), ("sum", 4)])
def test_table_scores_plain_per_pair_form_matches_jax(box_maps, table_case,
                                                      aggregation, step,
                                                      lanes):
    """Form (a)'s per-pair form (the f32 table as it is: what a table past
    ``MAX_TABLE_LEVELS`` takes) at every G against JAX's
    ``raycast_table_scores``, as the level form is held in
    ``test_table_scores_plain_matches_jax``; and equal to the level form
    within the same tolerance (the CPU's exp and log round by position)."""
    jm, tm = box_maps
    table_cm, ranges, angles, parts = table_case
    cfg = dict(max_range=2.0, sigma_hit=0.1, beam_table_n_theta=36,
               score_aggregation=aggregation, step=step)
    want = np.asarray(jrt.raycast_table_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles), jm,
        JConfig(**cfg), jnp.asarray(table_cm), 36))
    per_pair = TableLevels(None, None, _t(table_cm))
    got = _table_plain(tm, FilterConfig(**cfg), per_pair, parts, ranges,
                       angles, lanes=lanes).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 13.82)
    levels = _table_plain(tm, FilterConfig(**cfg), table_cm, parts, ranges,
                          angles, lanes=lanes).numpy()
    np.testing.assert_allclose(got, levels, rtol=1e-5, atol=1e-5 * 13.82)


@pytest.mark.parametrize("chunk", [1, 7, 300])
def test_table_scores_per_pair_chunked_equals_unchunked(box_maps, table_case,
                                                        chunk):
    """The per-pair form's plain version pads its beam columns to whole
    vectors (``_padded_columns``: PyTorch's CPU exp and log round
    differently in a vector body and a scalar tail), so any chunk of poses
    gives the unchunked scores bitwise."""
    _, tm = box_maps
    table_cm, ranges, angles, parts = table_case
    cfg = FilterConfig(max_range=2.0, sigma_hit=0.1, beam_table_n_theta=36,
                       score_aggregation="sum")
    per_pair = TableLevels(None, None, _t(table_cm))
    whole = _table_plain(tm, cfg, per_pair, parts, ranges, angles,
                         chunk=len(parts))
    np.testing.assert_array_equal(
        _table_plain(tm, cfg, per_pair, parts, ranges, angles,
                     chunk=chunk).numpy(), whole.numpy())


def test_table_sensor_table_is_the_level_form():
    """The "table" scorer's sensor table is built once per (map, config) in
    its level form where a scan scores at least TABLE_LEVEL_MIN_POSES poses
    (the proposed and previous sets under MH): uint8 at the default 5 m,
    int16 at 30 m (no refusal); below that count, in the per-pair f32
    form; a filter step runs on each."""
    _, tm = _open_hall()
    big = TABLE_LEVEL_MIN_POSES // 2
    for max_range, n, dtype in ((5.0, big, torch.uint8),
                                (30.0, big, torch.int16),
                                (5.0, big - 1, None), (5.0, 64, None)):
        cfg = FilterConfig(sensor_model="beam", beam_impl="table",
                           beam_table_n_theta=8, max_range=max_range,
                           num_particles=n, min_particles=n,
                           max_particles=n, initialized=True,
                           initial_pose=(0.0, 0.0, 0.0))
        assert cfg.use_mh
        table = _sensor_table(tm, cfg)
        assert isinstance(table, TableLevels)
        if dtype is None:
            assert table.index is None and table.levels is None
            assert table.table.dtype == torch.float32
        else:
            assert table.index.dtype == dtype and table.table is None
        model = make_model(cfg, tm)
        angles = _t(_angles(24))
        ranges = torch.full((24,), 4.0)
        state, info = model.step(model.init(0), ranges, angles,
                                 torch.tensor([0.0, 0.0, 0.0]))
        assert torch.isfinite(info.estimate.mean).all()


def test_raycast_beam_scores_match_jax(house_map, torch_house):
    """The ray-march scorer: each (particle, beam) march is the same f32
    arithmetic but for cos/sin, which round an ulp apart between XLA and
    torch and can move a sample across a cell edge (one 0.1 m step on at
    most 2% of rays, tests/test_torch_models.py::test_raycast_matches_jax).
    So 90% of the scores agree to rtol 1e-5 and every one within the
    change of 2% of its beams by at most 13.82 each."""
    m = 90
    ranges, angles = _scan(house_map, (1.0, 1.0, 0.4), m, 5.0)
    rng = np.random.default_rng(4)
    parts = np.stack([1.0 + rng.normal(0, 0.3, 130), 1.0 + rng.normal(0, 0.3, 130),
                      0.4 + rng.normal(0, 0.2, 130)], 1).astype(np.float32)
    kw = dict(sigma_hit=0.2, z_hit=0.75, z_rand=0.25, max_range=5.0)
    want = np.asarray(jsensor.raycast_beam_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles),
        house_map, **kw))
    got = tsensor.raycast_beam_scores(_t(parts), _t(ranges), _t(angles),
                                      torch_house, **kw).numpy()
    close = np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5
    assert close.mean() >= 0.9, close.mean()
    cnt = int((np.isfinite(ranges) & (ranges < 5.0)).sum())
    assert np.abs(got - want).max() <= np.ceil(0.02 * m) * 13.82 / cnt
    # the batched march equals the one-pose march it generalizes
    one = tsensor.raycast(_t(parts[0, :2]), parts[0, 2] + _t(angles),
                          torch_house, 5.0)
    many = tsensor.raycast(_t(parts[:3, :2]), _t(parts[:3, 2:3]) + _t(angles)[None],
                           torch_house, 5.0)
    np.testing.assert_array_equal(many[0].numpy(), one.numpy())


def test_window_indices_at_the_beam_bench_geometry():
    """Kernel 5's index math in the beam op forms (the plain version, which
    the card holds bitwise) at the bench's beam geometry on a 384^2 map: a
    64-cell window, 24 of 96 theta bins, the coarse table at factor 4 and
    24 bins; bitwise equal to the numpy spec of the TPU kernel."""
    from tests.test_fused_lookup import _spec_rows_lanes

    gm = build_grid_map(np.zeros((384, 384), np.int8), 0.05, (-9.6, -9.6),
                        device="cpu")
    geo = trt._beam_geometry(gm, 96, 24, 64, (4, 24, 96, 96))
    origin = torch.tensor([140, 150, 90], dtype=torch.int32)
    rng = np.random.default_rng(1)
    n = 20000
    parts = np.stack([
        np.concatenate([rng.uniform(-2.3, -1.5, n // 2), rng.uniform(-10, 10, n // 2)]),
        np.concatenate([rng.uniform(-2.8, -2.0, n // 2), rng.uniform(-10, 10, n // 2)]),
        rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    rows, lanes, in_map = _spec_rows_lanes(
        parts[:, 0], parts[:, 1], parts[:, 2], orx=-9.6, ory=-9.6,
        fine_scale=np.float32(0.05), fine_div=True,
        theta_scale=np.float32(2 * np.pi / 96), theta_div=True, n_theta=96,
        nbins=24, kstart=90, h=384, w=384, fh=64, fw=64, ox0=150, oy0=140,
        kc=24, hc=96, wc=96, res_c=0.2, clip_before_window=True,
        coarse_base=64 * 24)
    covered, row, lane, in_map_t = (x.numpy() for x in
                                    window_indices(_t(parts), geo, origin))
    np.testing.assert_array_equal(np.where(covered, row, 64 * 24 + row), rows)
    np.testing.assert_array_equal(lane, lanes)
    np.testing.assert_array_equal(in_map_t, in_map)
    assert covered.mean() > 0.05 and (~covered & in_map).mean() > 0.3
