"""The port's windowed lookup with the coarse fallback (kernel 5,
ops/fused_score.py) and the coarse field (models/corr_field.py) against the
JAX package on the same inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.models import corr_field as jcf  # noqa: E402
from mcmh_localization_tpu.models.sensor import (  # noqa: E402
    log_likelihood_field as j_log_field,
)
from mcmh_localization_tpu.ops.fused_score_pallas import (  # noqa: E402
    fused_window_score_gather,
)
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.models import corr_field as tcf  # noqa: E402
from mcmh_localization_tpu_torch.ops.fused_score import (  # noqa: E402
    WindowGeometry,
    poses_per_thread,
    window_escapees,
    window_indices,
    window_score,
)
from tests.test_fused_lookup import _spec_rows_lanes  # noqa: E402
from tests.test_torch_corr_field import _jax_offsets, _particles, _scan  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

N_THETA = 48


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


def _fused_case(flags):
    """The inputs of tests/test_fused_lookup.py::test_fused_matches_spec_
    bitwise: an in-window cluster, escapees anywhere in the map, and poses
    mostly off the map; the window origin (oy0, ox0, kstart) as the int32
    tensor the lookups take."""
    fine_div, theta_div, clip_before = flags
    rng = np.random.default_rng(0)
    n_theta, nbins, fh, fw = 120, 24, 64, 64
    kc, hc, wc = 30, 96, 96
    res, res_c = 0.05, 0.2
    field_t = (rng.normal(size=(fh * nbins, fw)) * 800).astype(np.float32)
    cfield_t = (rng.normal(size=(hc * kc, wc)) * 800).astype(np.float32)
    n = 4096
    px = np.concatenate([rng.uniform(-2.3, -1.5, n // 2),
                         rng.uniform(-9.5, 9.0, n // 4),
                         rng.uniform(-30.0, 30.0, n - n // 2 - n // 4)])
    py = np.concatenate([rng.uniform(-2.8, -2.0, n // 2),
                         rng.uniform(-9.5, 9.0, n // 4),
                         rng.uniform(-30.0, 30.0, n - n // 2 - n // 4)])
    pth = rng.uniform(-np.pi, np.pi, n)
    parts = np.stack([px, py, pth], 1).astype(np.float32)
    fine_scale = np.float32(res) if fine_div else np.float32(1.0 / res)
    theta_scale = (np.float32(2.0 * np.pi / n_theta) if theta_div
                   else np.float32(n_theta / (2.0 * np.pi)))
    spec = dict(orx=-9.6, ory=-9.6, fine_scale=fine_scale, fine_div=fine_div,
                theta_scale=theta_scale, theta_div=theta_div,
                n_theta=n_theta, nbins=nbins, kstart=97, h=384, w=384,
                fh=fh, fw=fw, ox0=150, oy0=140, kc=kc, hc=hc, wc=wc,
                res_c=res_c, clip_before_window=clip_before,
                coarse_base=fh * nbins)
    geo = WindowGeometry(
        origin_x=float(np.float32(-9.6)), origin_y=float(np.float32(-9.6)),
        fine_scale=float(fine_scale), theta_scale=float(theta_scale),
        n_theta=n_theta, nbins=nbins, fh=fh, fw=fw, h=384, w=384, kc=kc,
        hc=hc, wc=wc, res_c=float(np.float32(res_c)),
        kc_scale=float(np.float32(kc / (2.0 * np.pi))), fine_div=fine_div,
        theta_div=theta_div, clip_before_window=clip_before)
    origin = torch.tensor([140, 150, 97], dtype=torch.int32)
    return field_t, cfield_t, parts, spec, geo, origin


FLAG_SETS = [(False, False, False), (True, True, True)]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=["corr_forms", "beam_forms"])
def test_window_score_bitwise_vs_index_spec(flags):
    """Index triples bitwise equal to the numpy spec of the TPU kernel's
    semantics, values bitwise equal to the table read, divided and
    filled."""
    field_t, cfield_t, parts, spec, geo, origin = _fused_case(flags)
    rows, lanes, in_map = _spec_rows_lanes(parts[:, 0], parts[:, 1],
                                           parts[:, 2], **spec)
    covered, row, lane, in_map_t = window_indices(torch.from_numpy(parts), geo,
                                                  origin)
    covered, row = covered.numpy(), row.numpy()
    np.testing.assert_array_equal(
        np.where(covered, row, spec["coarse_base"] + row), rows)
    np.testing.assert_array_equal(lane.numpy(), lanes)
    np.testing.assert_array_equal(in_map_t.numpy(), in_map)
    assert covered.any() and (~covered & in_map).any() and (~in_map).any()

    denom, fill = np.float32(37.0), np.float32(-123.0)
    got = window_score(torch.from_numpy(field_t), torch.from_numpy(cfield_t),
                       torch.from_numpy(parts), geo, float(denom),
                       float(fill), origin=origin).numpy()
    cb = spec["coarse_base"]
    read = np.where(covered,
                    field_t[np.where(covered, rows, 0), np.where(covered, lanes, 0)],
                    cfield_t[np.where(covered, 0, rows - cb),
                             np.where(covered, 0, lanes)])
    want = np.where(in_map, read / denom, fill)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    # a count of 0 valid beams gives the blind score everywhere
    blind = window_score(torch.from_numpy(field_t), torch.from_numpy(cfield_t),
                         torch.from_numpy(parts), geo, float(denom),
                         float(fill), count=torch.tensor(0),
                         origin=origin).numpy()
    assert (blind == -50.0).all()
    # the gate's count is the in-map escapees
    assert int(window_escapees(torch.from_numpy(parts), geo, origin)) == int(
        (~covered & in_map).sum())


@pytest.mark.parametrize("flags", FLAG_SETS, ids=["corr_forms", "beam_forms"])
def test_window_score_ragged_view_vs_index_spec(flags):
    """A view of the poses that starts one pose in (its base 12 bytes past
    the array's) with N mod 4 = 1, the case the kernel's 4-byte loads and
    ragged last thread take: values and the escapee count bitwise equal to
    the index spec on those poses, and to the whole array's scores at
    their positions."""
    field_t, cfield_t, parts, spec, geo, origin = _fused_case(flags)
    full = torch.from_numpy(parts)
    view = full[1:-2]
    assert view.shape[0] % 4 == 1 and view.storage_offset() == 3
    rows, lanes, in_map = _spec_rows_lanes(parts[1:-2, 0], parts[1:-2, 1],
                                           parts[1:-2, 2], **spec)
    cb = spec["coarse_base"]
    covered = rows < cb
    read = np.where(covered,
                    field_t[np.where(covered, rows, 0), np.where(covered, lanes, 0)],
                    cfield_t[np.where(covered, 0, rows - cb),
                             np.where(covered, 0, lanes)])
    denom, fill = np.float32(37.0), np.float32(-123.0)
    want = np.where(in_map, read / denom, fill).astype(np.float32)
    tables = torch.from_numpy(field_t), torch.from_numpy(cfield_t)
    got = window_score(*tables, view, geo, float(denom), float(fill),
                       origin=origin).numpy()
    np.testing.assert_array_equal(got, want)
    whole = window_score(*tables, full, geo, float(denom), float(fill),
                         origin=origin).numpy()
    np.testing.assert_array_equal(got, whole[1:-2])
    assert int(window_escapees(view, geo, origin)) == int(
        (~covered & in_map).sum())


def test_poses_per_thread_rule():
    """P is 1, 2 or 4, nondecreasing in N, and takes the values PERF.md
    records at the single-program (2x1M) and beam (2x100k) shapes."""
    prev = 1
    for n in [1, 3, 4096, 200_003, 262_144, 524_287, 524_288, 1_048_575,
              1_048_576, 2_000_000, 8_000_000]:
        p = poses_per_thread(n)
        assert p in (1, 2, 4) and p >= prev, (n, p)
        prev = p
    assert poses_per_thread(2 * 1_000_000) == 4
    assert poses_per_thread(2 * 100_000) == 1


@pytest.mark.parametrize("flags", FLAG_SETS, ids=["corr_forms", "beam_forms"])
def test_window_score_vs_tpu_kernel_interpret(flags):
    """The TPU kernel reads through split bf16 hi/lo planes, a TPU
    approximation of about |v| * 2^-16 (hi keeps 8 bits, lo the next 8):
    the port's exact read agrees within |v| * 2^-15."""
    field_t, cfield_t, parts, spec, geo, origin = _fused_case(flags)
    denom, fill = np.float32(37.0), np.float32(-123.0)
    got = window_score(torch.from_numpy(field_t), torch.from_numpy(cfield_t),
                       torch.from_numpy(parts), geo, float(denom),
                       float(fill), origin=origin).numpy()
    want = np.asarray(fused_window_score_gather(
        jnp.asarray(field_t), jnp.asarray(cfield_t),
        jnp.asarray(parts[:, 0]), jnp.asarray(parts[:, 1]),
        jnp.asarray(parts[:, 2]), jnp.float32(spec["orx"]),
        jnp.float32(spec["ory"]), jnp.float32(spec["fine_scale"]),
        jnp.int32(spec["ox0"]), jnp.int32(spec["oy0"]),
        jnp.int32(spec["kstart"]), jnp.float32(denom), jnp.float32(fill),
        n_theta=spec["n_theta"], nbins=spec["nbins"], fh=spec["fh"],
        fw=spec["fw"], h=spec["h"], w=spec["w"], kc=spec["kc"],
        hc=spec["hc"], wc=spec["wc"], res_c=spec["res_c"],
        theta_scale=float(spec["theta_scale"]), fine_div=flags[0],
        theta_div=flags[1], clip_before_window=flags[2], interpret=True))
    assert (np.abs(got - want) <= np.abs(got) * 2.0 ** -15 + 1e-30).all()


def _coarse_offsets(cfg, u, v, valid, h, res):
    """The coarse field's bin offsets as JAX _coarse_field computes them
    (corr_field.py:152-167)."""
    f = cfg.corr_coarse_factor
    hc = -(-h // f)
    res_c = f * res
    pad_c = int(-(-cfg.max_range // res_c)) + 2
    return jcf._bin_offsets(u, v, valid, 1.0 / res_c, cfg.corr_coarse_n_theta,
                            pad_c, hc + 2 * pad_c)


@pytest.mark.parametrize("validity", ["score", "reject"])
def test_coarse_field_matches_jax(house_map, torch_map, validity):
    """Port _coarse_field vs JAX _coarse_field (its XLA build on the CPU) on
    the same bin offsets: the field-build tolerance (f32 sums of M log
    values in another order: rtol 1e-5, atol 1e-5 * M * max|L|).  The
    port's own offsets differ from JAX's only where an ulp of cos/sin moves
    a truncated offset: at most 0.5% of them, by one cell."""
    kw = dict(max_range=5.0, corr_window_cells=64, motion_validity=validity)
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    ranges, angles = _scan(house_map, (1.0, 1.0, 0.4), m=120)
    res = float(jax.device_get(house_map.resolution))
    lf = j_log_field(house_map, jcfg)
    valid = jnp.isfinite(ranges) & (ranges < jcfg.max_range)
    safe_r = jnp.where(valid, ranges, 0.0)
    u = (safe_r * jnp.cos(angles)).astype(jnp.float32)
    v = (safe_r * jnp.sin(angles)).astype(jnp.float32)
    want = np.asarray(jcf._coarse_field(u, v, valid, lf, house_map, jcfg, res))
    ox, oy = _coarse_offsets(jcfg, u, v, valid, lf.shape[0], res)
    t = [torch.from_numpy(np.array(a)) for a in (u, v, valid, lf)]
    got = tcf._coarse_field(*t, torch_map, tcfg,
                            offsets=(torch.from_numpy(np.array(ox)),
                                     torch.from_numpy(np.array(oy)))).numpy()
    assert got.shape == want.shape == (36, 48, 48)
    atol = 1e-5 * 120 * float(np.abs(np.asarray(lf)).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    if validity == "score":
        assert (want < -100.0).any()      # blocks without a free cell
    f = tcfg.corr_coarse_factor
    pad_c = int(-(-5.0 // (f * res))) + 2
    # in beam order, as JAX computes them (the build's order is tested in
    # tests/test_torch_corr_order.py)
    ox_t, oy_t = tcf._beam_offsets(t[0], t[1], t[2], 1.0 / (f * res), 36,
                                   pad_c, 48 + 2 * pad_c)
    for g_, w_ in ((ox_t.numpy(), np.asarray(ox)), (oy_t.numpy(), np.asarray(oy))):
        diff = np.abs(g_.astype(np.int64) - w_)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005


@pytest.mark.parametrize("gate", [0, 1, 100000], ids=["ungated", "gate_fires",
                                                      "gate_blind"])
@pytest.mark.parametrize("aggregation,validity", [("mean", "score"),
                                                  ("sum", "score"),
                                                  ("mean", "reject")])
def test_windowed_coarse_scores_match_jax(house_map, torch_map, gate,
                                          aggregation, validity):
    """The single-program windowed scorer with the coarse fallback vs JAX
    correlation_field_scores on the CPU (its gather_2d_select path) on the
    same fine and coarse bin offsets: the field-build tolerance, rtol 1e-5
    (atol 1e-5 * M * max|L| under "sum").  Below the build gate every
    escapee takes the blind fill on both sides."""
    kw = dict(max_range=5.0, likelihood_impl="corr", corr_n_theta=N_THETA,
              corr_window_cells=64, corr_theta_window_bins=16,
              motion_validity=validity, score_aggregation=aggregation,
              coarse_gate_escapees=gate)
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    ranges, angles = _scan(house_map, (1.0, 1.0, 0.4))
    parts = _particles(3000, 9)
    lf = j_log_field(house_map, jcfg)
    wo = (40, 50, 44)
    (ox, oy), (u, v, valid, _, _) = _jax_offsets(
        house_map, jcfg, jnp.asarray(ranges), jnp.asarray(angles), N_THETA,
        wo[2], 16)
    res = float(jax.device_get(house_map.resolution))
    cox, coy = _coarse_offsets(jcfg, u, v, valid, lf.shape[0], res)
    want = np.asarray(jcf.correlation_field_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles),
        house_map, jcfg, log_field=lf, n_theta=N_THETA,
        window_origin=tuple(jnp.int32(x) for x in wo)))
    got = tcf.correlation_field_scores(
        torch.from_numpy(parts), torch.from_numpy(ranges),
        torch.from_numpy(angles), torch_map, tcfg,
        log_field=torch.from_numpy(np.array(lf)), n_theta=N_THETA,
        window_origin=wo,
        offsets=(torch.from_numpy(np.array(ox)), torch.from_numpy(np.array(oy))),
        coarse_offsets=(torch.from_numpy(np.array(cox)),
                        torch.from_numpy(np.array(coy)))).numpy()
    atol = 1e-5 if aggregation == "mean" else 1e-5 * 90 * 14.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    # the blind fill reads -50 after the "mean" divide and raw under "sum"
    n_blind = int((want == -50.0).sum())
    if gate == 100000:
        assert n_blind > 100               # every escapee took the fill
    else:
        assert n_blind == 0                # the coarse field scored them


# ---------------------------------------------------------------------------
# kernel 5 with the window in device memory
# ---------------------------------------------------------------------------

ORIGIN_CASES = {
    # the window's corner clamped to the map's low and high edges, and the
    # theta window starting at the last bin (its bins wrap past 0)
    "low_clamp": (0, 0, 97),
    "high_clamp": (384 - 64, 384 - 64, 97),
    "theta_wrap": (140, 150, 119),
}


def _origin_case(flags, case):
    """``_fused_case`` with a cluster of 1024 poses in the window at the
    case's (oy0, ox0) with headings across its theta window (its 24 bins
    from kstart on, past the wrap), so each origin covers poses."""
    field_t, cfield_t, parts, spec, geo, _ = _fused_case(flags)
    oy0, ox0, kstart = ORIGIN_CASES[case]
    rng = np.random.default_rng(7)
    n = 1024
    res = 0.05
    k = (kstart + rng.uniform(0.1, 23.9, n)) % spec["n_theta"]
    cluster = np.stack([
        -9.6 + (ox0 + rng.uniform(0, 64, n)) * res,
        -9.6 + (oy0 + rng.uniform(0, 64, n)) * res,
        -np.pi + k * (2 * np.pi / spec["n_theta"])], 1).astype(np.float32)
    parts = np.concatenate([parts, cluster])
    spec = dict(spec, ox0=ox0, oy0=oy0, kstart=kstart)
    return field_t, cfield_t, parts, spec, geo, (oy0, ox0, kstart)


def _spec_scores(field_t, cfield_t, parts, spec, denom, fill):
    """(scores, covered, in_map) of the numpy index spec: the table read at
    the spec's (row, lane), divided by ``denom`` in the map, ``fill`` off
    it."""
    rows, lanes, in_map = _spec_rows_lanes(parts[:, 0], parts[:, 1],
                                           parts[:, 2], **spec)
    cb = spec["coarse_base"]
    covered = rows < cb
    read = np.where(covered,
                    field_t[np.where(covered, rows, 0), np.where(covered, lanes, 0)],
                    cfield_t[np.where(covered, 0, rows - cb),
                             np.where(covered, 0, lanes)])
    return (np.where(in_map, read / np.float32(denom), np.float32(fill))
            .astype(np.float32), covered, in_map)


def _jax_escapees(parts, spec):
    """JAX's coarse-gate count ``jnp.sum(in_map & ~covered)`` with the JAX
    scorer's index math (models/corr_field.py:467-488, the corr op
    forms)."""
    px, py, pth = (jnp.asarray(parts[:, i]) for i in range(3))
    n_theta = spec["n_theta"]
    mx = ((px - jnp.float32(spec["orx"])) * spec["fine_scale"]).astype(
        jnp.int32)
    my = ((py - jnp.float32(spec["ory"])) * spec["fine_scale"]).astype(
        jnp.int32)
    tbin = ((pth + jnp.pi) * (n_theta / (2.0 * jnp.pi))).astype(
        jnp.int32) % n_theta
    in_theta = (tbin - spec["kstart"]) % n_theta < spec["nbins"]
    in_map = (mx >= 0) & (mx < spec["w"]) & (my >= 0) & (my < spec["h"])
    mxw, myw = mx - spec["ox0"], my - spec["oy0"]
    covered = ((mxw >= 0) & (mxw < spec["fw"]) & (myw >= 0)
               & (myw < spec["fh"]) & in_theta)
    return int(jnp.sum(in_map & ~covered))


@pytest.mark.parametrize("case", list(ORIGIN_CASES))
@pytest.mark.parametrize("flags", FLAG_SETS, ids=["corr_forms", "beam_forms"])
def test_window_score_device_origin(flags, case):
    """The window-score and escapee plain versions with the window read
    from the origin tensor (the ``_at`` kernels' form) at the window's
    clamps and at the theta wrap: bitwise equal to the numpy index spec of
    the TPU kernel's semantics at that window, also with kstart 0 (the
    origin of a window without a theta window); and within the TPU
    kernel's bf16 hi/lo read (|v| * 2^-15) of JAX's
    ``fused_window_score_gather`` in interpret mode.  The escapee count
    equals the spec's and JAX's ``jnp.sum(in_map & ~covered)`` (corr
    forms)."""
    field_t, cfield_t, parts, spec, geo, origin = _origin_case(flags, case)
    oy0, ox0, kstart = origin
    tables = torch.from_numpy(field_t), torch.from_numpy(cfield_t)
    tp = torch.from_numpy(parts)
    denom, fill, count = 37.0, -123.0, torch.tensor(90)
    for k0 in (kstart, 0):
        at = torch.tensor((oy0, ox0, k0), dtype=torch.int32)
        want, covered, in_map = _spec_scores(field_t, cfield_t, parts,
                                             dict(spec, kstart=k0), denom,
                                             fill)
        got = window_score(*tables, tp, geo, denom, fill, count=count,
                           origin=at)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(window_escapees(tp, geo, at)) == int(
            (~covered & in_map).sum())
    at = torch.tensor(origin, dtype=torch.int32)
    got = window_score(*tables, tp, geo, denom, fill, count=count, origin=at)
    covered, _, _, in_map = window_indices(tp, geo, at)
    assert covered.sum() >= 500 and (~covered & in_map).any()
    if case == "theta_wrap":   # covered headings on both sides of +-pi
        th = tp[covered, 2]
        assert (th > 3.0).any() and (th < -3.0).any()
    n_esc = int(window_escapees(tp, geo, origin=at))
    assert n_esc == int((~covered & in_map).sum())
    if flags == FLAG_SETS[0]:
        assert n_esc == _jax_escapees(parts, spec)
    jax_scores = np.asarray(fused_window_score_gather(
        jnp.asarray(field_t), jnp.asarray(cfield_t),
        jnp.asarray(parts[:, 0]), jnp.asarray(parts[:, 1]),
        jnp.asarray(parts[:, 2]), jnp.float32(spec["orx"]),
        jnp.float32(spec["ory"]), jnp.float32(spec["fine_scale"]),
        jnp.int32(ox0), jnp.int32(oy0), jnp.int32(kstart),
        jnp.float32(denom), jnp.float32(fill),
        n_theta=spec["n_theta"], nbins=spec["nbins"], fh=spec["fh"],
        fw=spec["fw"], h=spec["h"], w=spec["w"], kc=spec["kc"],
        hc=spec["hc"], wc=spec["wc"], res_c=spec["res_c"],
        theta_scale=float(spec["theta_scale"]), fine_div=flags[0],
        theta_div=flags[1], clip_before_window=flags[2], interpret=True))
    g = got.numpy()
    assert (np.abs(g - jax_scores) <= np.abs(g) * 2.0 ** -15 + 1e-30).all()


def _gate_particles(n_escapees: int) -> np.ndarray:
    """3000 poses inside the window at (oy0, ox0, kstart) = (40, 50, 44)
    of 64 cells and 16 of 48 bins (cells 2-61 on each side, headings in
    bins 0-5, k_rel 4-9), then ``n_escapees`` of them moved onto the map
    outside the window."""
    rng = np.random.default_rng(13)
    n = 3000
    bin_w = 2 * np.pi / N_THETA
    parts = np.stack([
        -4.8 + (50 + rng.uniform(2, 62, n)) * 0.05,
        -4.8 + (40 + rng.uniform(2, 62, n)) * 0.05,
        -np.pi + rng.uniform(0.2, 5.8, n) * bin_w], 1).astype(np.float32)
    parts[:n_escapees, :2] = np.stack([
        rng.uniform(2.0, 4.0, n_escapees),
        rng.uniform(2.0, 4.0, n_escapees)], 1)
    return parts


@pytest.mark.parametrize("side", ["below", "above"])
@pytest.mark.parametrize("aggregation", ["mean", "sum"])
def test_coarse_gate_branches_match_jax(house_map, torch_map, aggregation,
                                        side):
    """The gate of 8 escapees on both sides, the window origin a device
    tensor: 5 escapees skip the coarse build (``run_if``'s untaken branch:
    they take the blind fill), 20 build it; the scores match JAX's
    ``correlation_field_scores`` with ``coarse_gate_escapees=8`` at the
    tolerance of ``test_windowed_coarse_scores_match_jax`` (rtol 1e-5,
    atol 1e-5 * M * max|L| under "sum")."""
    n_esc = 5 if side == "below" else 20
    kw = dict(max_range=5.0, likelihood_impl="corr", corr_n_theta=N_THETA,
              corr_window_cells=64, corr_theta_window_bins=16,
              motion_validity="score", score_aggregation=aggregation,
              coarse_gate_escapees=8)
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    ranges, angles = _scan(house_map, (1.0, 1.0, 0.4))
    parts = _gate_particles(n_esc)
    lf = j_log_field(house_map, jcfg)
    wo = (40, 50, 44)
    (ox, oy), (u, v, valid, _, _) = _jax_offsets(
        house_map, jcfg, jnp.asarray(ranges), jnp.asarray(angles), N_THETA,
        wo[2], 16)
    res = float(jax.device_get(house_map.resolution))
    cox, coy = _coarse_offsets(jcfg, u, v, valid, lf.shape[0], res)
    want = np.asarray(jcf.correlation_field_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles),
        house_map, jcfg, log_field=lf, n_theta=N_THETA,
        window_origin=tuple(jnp.int32(x) for x in wo)))
    got = tcf.correlation_field_scores(
        torch.from_numpy(parts), torch.from_numpy(ranges),
        torch.from_numpy(angles), torch_map, tcfg,
        log_field=torch.from_numpy(np.array(lf)), n_theta=N_THETA,
        window_origin=torch.tensor(wo, dtype=torch.int32),
        offsets=(torch.from_numpy(np.array(ox)), torch.from_numpy(np.array(oy))),
        coarse_offsets=(torch.from_numpy(np.array(cox)),
                        torch.from_numpy(np.array(coy)))).numpy()
    atol = 1e-5 if aggregation == "mean" else 1e-5 * 90 * 14.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    # the blind fill reads -50 after the "mean" divide and raw under "sum"
    n_blind = int((want == -50.0).sum())
    assert n_blind == (n_esc if side == "below" else 0)
    assert int((got == -50.0).sum()) == n_blind


def test_build_correlation_field_matches_jax(house_map, torch_map):
    """``build_correlation_field`` (JAX's API-compatibility function for the
    full (n_theta, H, W) field) against JAX's on the same scan: the
    field-build tolerance, rtol 1e-5 and atol 1e-5 * M * max|L| (f32 sums
    of M log values in another order; the port's bin offsets may move an
    ulp-edge beam by one cell, as tests/test_torch_corr_field.py allows)."""
    from mcmh_localization_tpu.models.corr_field import (
        build_correlation_field as j_build,
    )

    cfg = JConfig(max_range=5.0)
    ranges, angles = _scan(house_map, (1.0, 1.0, 0.4), m=90)
    lf = j_log_field(house_map, cfg)
    valid = np.isfinite(ranges) & (ranges < cfg.max_range)
    safe = np.where(valid, ranges, 0.0).astype(np.float32)
    u = (safe * np.cos(angles)).astype(np.float32)
    v = (safe * np.sin(angles)).astype(np.float32)
    res = float(jax.device_get(house_map.resolution))
    pad = int(-(-cfg.max_range // res)) + 2
    want = np.asarray(j_build(lf, jnp.asarray(u), jnp.asarray(v),
                              jnp.asarray(valid), 1.0 / res, 24, pad))
    got = tcf.build_correlation_field(
        torch.from_numpy(np.array(lf)), torch.from_numpy(u),
        torch.from_numpy(v), torch.from_numpy(valid), torch_map.inv_res, 24,
        pad).numpy()
    assert got.shape == want.shape == (24,) + lf.shape
    atol = 1e-5 * 90 * float(np.abs(np.asarray(lf)).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
