"""The compiled trajectory run's forms on the CPU: the staged main path's
step reads nothing on the host outside ``ops/graph.py::run_if``'s plain
version, the new forms (the device-held window origin, the injection by a
device shift, the gates through ``run_if``) against the JAX package on
JAX's draws, and ``kld_resample`` past its stage-1 prefix at 262 144
samples.  The CUDA graph itself (capture, replay, conditional nodes) runs
only on the card: ``chip_smoke.py``'s ``[graph]`` phase checks it there.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter import step as jstep  # noqa: E402
from mcmh_localization_tpu.models import corr_field as jcf  # noqa: E402
from mcmh_localization_tpu.models.sensor import (  # noqa: E402
    log_likelihood_field as j_log_field,
)
from mcmh_localization_tpu.ops import resampling as jres  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import (  # noqa: E402
    STATE_FIELDS,
    grid_map_from_numpy,
    state_from_numpy,
)
from mcmh_localization_tpu_torch.filter import step as tstep  # noqa: E402
from mcmh_localization_tpu_torch.filter.staged import make_staged_model  # noqa: E402
from mcmh_localization_tpu_torch.models import corr_field as tcf  # noqa: E402
from mcmh_localization_tpu_torch.models import range_table as trt  # noqa: E402
from mcmh_localization_tpu_torch.ops import graph as tgraph  # noqa: E402
from mcmh_localization_tpu_torch.ops import resampling as tres  # noqa: E402
from mcmh_localization_tpu_torch.ops.corr_field_build import (  # noqa: E402
    corr_field_build,
)
from mcmh_localization_tpu_torch.ops.gather import (  # noqa: E402
    LookupGeometry,
    corr_lookup,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401
from tests.torch_guard import HostRead, no_host_reads  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _replays_on_card(config) -> bool:
    """``FilterModel.replays_graph`` of ``config`` on a CUDA device: a
    stand-in model whose map reports the card, made without one."""
    model = object.__new__(tstep.FilterModel)
    model.config = config
    model.grid_map = SimpleNamespace(device=torch.device("cuda"))
    return model.replays_graph


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


# ---------------------------------------------------------------------------
# the host-read guard
# ---------------------------------------------------------------------------

def _main_path_kw(**kw):
    """The staged main path (bench.py's cfg_kld) at a CPU size."""
    base = dict(mode="AMHAMCL", num_particles=8192, min_particles=2000,
                max_particles=8192, initialized=True,
                initial_pose=(1.0, 1.0, 0.4), initial_cov=(0.02, 0.02, 0.05),
                max_range=5.0, likelihood_impl="corr", corr_n_theta=48,
                corr_window_cells=64, corr_theta_window_bins=16,
                motion_validity="score", min_injection_prob=0.02,
                kld_eval_window=0, coarse_gate_escapees=0,
                estimate_mode="cluster")
    base.update(kw)
    return base


def _scan_inputs(house_map):
    from tests.test_filter import _simulate

    poses = np.float32([[1.0, 1.0, 0.4], [1.1, 1.03, 0.5]])
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    return _t(scans[1]), _t(angles), _t(deltas[1])


@pytest.mark.parametrize("program", ["big", "small"])
def test_main_path_step_reads_nothing_on_the_host(house_map, torch_map,
                                                  monkeypatch, program):
    """One step of each staged program (BIG at 8192 slots, with the KLD
    escalation reachable and injecting; SMALL at 4096, ESS-gated) under
    the guard: no host read escapes outside the gates' plain version.
    Both programs replay a captured step on a CUDA device."""
    monkeypatch.setattr(tres, "_KLD_STAGE1", 1024)
    staged = make_staged_model(FilterConfig(**_main_path_kw()), torch_map,
                               tracking_capacity=4096,
                               tracking_ess_threshold=0.9)
    model = staged.big if program == "big" else staged.small
    assert _replays_on_card(model.config)
    state = model.init(0)
    # an injecting scan: the augmented-MCL averages apart
    state = state.replace(w_slow=torch.tensor(1.0), w_fast=torch.tensor(0.5))
    ranges, angles, delta = _scan_inputs(house_map)
    with no_host_reads(monkeypatch):
        new, info = model.step(state, ranges, angles, delta)
    assert float(info.p_random) > 0.02          # the injection ran
    assert int(new.count) >= model.config.min_particles


def test_eager_config_trips_the_guard(house_map, torch_map, monkeypatch):
    """The guard catches a step that reads on the host: the beam score
    field with its window origin read back as host ints before the field
    build (the form the beam model had before its origin stayed on the
    device) raises ``HostRead``; the same step as shipped passes."""
    cfg = FilterConfig(**_beam_kw(coarse_gate_escapees=8))
    assert _replays_on_card(cfg)
    model = tstep.make_model(cfg, torch_map)
    ranges, angles, delta = _scan_inputs(house_map)
    with no_host_reads(monkeypatch):
        model.step(model.init(0), ranges, angles, delta)
    plain = trt.field_origin

    def host_origin(window_origin, *args):
        return plain(tuple(window_origin.tolist()), *args)

    monkeypatch.setattr(trt, "field_origin", host_origin)
    with no_host_reads(monkeypatch), pytest.raises(HostRead):
        model.step(model.init(0), ranges, angles, delta)


def test_graph_capturable_by_config():
    """Every config replays a captured step on a CUDA device: both staged
    programs of the main path, the window with the coarse fallback (gated or not), the
    exact scorer ("jnp", "pallas", and "auto" resolving to it) under both
    motion validities, the 3-D lidar, and the beam model in every impl
    ("field", "table", "dense", "auto"); never on the CPU."""
    capturable = [
        FilterConfig(**_main_path_kw(corr_window_cells=0,
                                     corr_theta_window_bins=0)),
        FilterConfig(**_main_path_kw(corr_coarse_factor=0)),
        FilterConfig(**_main_path_kw(corr_coarse_factor=4)),
        FilterConfig(**_main_path_kw(corr_coarse_factor=4,
                                     coarse_gate_escapees=8)),
        FilterConfig(),
        FilterConfig(likelihood_impl="jnp", motion_validity="score"),
        FilterConfig(likelihood_impl="pallas"),
        FilterConfig(sensor_model="lidar3d"),
    ]
    for impl in ("field", "table", "dense", "auto"):
        capturable.append(FilterConfig(
            sensor_model="beam", beam_impl=impl, corr_window_cells=128))
    for cfg in capturable:
        assert _replays_on_card(cfg), cfg
    assert tstep._resolved_impl(FilterConfig(), "cuda") == "jnp"
    model = tstep.make_model(
        FilterConfig(sensor_model="beam", beam_impl="dense",
                     beam_table_n_theta=12, corr_window_cells=16),
        grid_map_from_numpy(np.zeros((24, 24), np.int8), 0.1, (0.0, 0.0),
                            device="cpu"))
    assert not model.replays_graph


# ---------------------------------------------------------------------------
# the newly capturable configs under the host-read guard
# ---------------------------------------------------------------------------

def _exact_kw(impl, validity):
    return dict(mode="AMHAMCL", num_particles=2048, min_particles=500,
                max_particles=2048, initialized=True,
                initial_pose=(1.0, 1.0, 0.4), max_range=5.0,
                likelihood_impl=impl, motion_validity=validity)


# entry 1's grid: each mode with the resamplers it can run (the adaptive
# modes "simple" and "lvr", the others the systematic draw) on the corr
# window without the coarse fallback
GRID = [(mode, res) for mode in ("AMCL", "MHAMCL", "AMHAMCL")
        for res in ("simple", "lvr")] + [
            (mode, "systematic") for mode in ("MCL", "MHMCL", "AMHMCL")]

# the beam model's grid: the score field gated (both sides of the gate) and
# ungated, its ESS-gated twin, the range table, the ray march, the field
# without a theta window ((F)'s form: every table bin from bin 0), and the
# staged beam programs (BIG: the range table at "sum" with the refill;
# SMALL: the field without the coarse fallback, ESS-gated)
BEAM_GUARD = {
    "beam_field_gate8_below": dict(coarse_gate_escapees=8, side="below"),
    "beam_field_gate8_above": dict(coarse_gate_escapees=8, side="above"),
    "beam_field_ungated": dict(coarse_gate_escapees=0),
    "beam_field_essgate": dict(resample_ess_threshold=0.9),
    "beam_table": dict(beam_impl="table", corr_window_cells=0,
                       corr_theta_window_bins=0, motion_validity="reject"),
    "beam_dense": dict(beam_impl="dense"),
    "beam_field_no_theta_window": dict(corr_theta_window_bins=0),
    "beam_staged_big": dict(staged="big"),
    "beam_staged_small": dict(staged="small"),
}

GUARD_CASES = {
    **{f"coarse_gate{g}_{side}": dict(kind="coarse", gate=g, side=side)
       for g in (0, 8) for side in ("below", "above")},
    **{case: dict(kind="beam", **kw) for case, kw in BEAM_GUARD.items()},
    **{f"{impl}_{v}": dict(kind="exact", impl=impl, validity=v)
       for impl in ("jnp", "pallas") for v in ("reject", "score")},
    "lidar3d": dict(kind="lidar3d"),
    **{f"{mode}_{res}_{v}": dict(kind="grid", mode=mode, resampler=res,
                                 validity=v)
       for mode, res in GRID for v in ("score", "reject")},
}


def _beam_kw(**kw):
    """The bench's beam point (tests/test_torch_beam.py's BEAM) at a CPU
    size: 48 table bins, a 64-cell window with 12 theta bins, the coarse
    fallback at 12 bins."""
    base = dict(mode="AMHAMCL", num_particles=1024, min_particles=256,
                max_particles=1024, initialized=True,
                initial_pose=(1.0, 1.0, 0.4), initial_cov=(0.02, 0.02, 0.05),
                max_range=5.0, sensor_model="beam", beam_impl="field",
                beam_table_n_theta=48, corr_window_cells=64,
                corr_theta_window_bins=12, corr_coarse_n_theta=12,
                sigma_hit=0.2, motion_validity="score",
                min_injection_prob=0.02)
    base.update(kw)
    return base


def _beam_case(spec, torch_map):
    """(model, state) of a BEAM_GUARD case."""
    kw = {k: v for k, v in spec.items() if k not in ("kind", "side",
                                                     "staged")}
    if "staged" in spec:
        staged = make_staged_model(
            FilterConfig(**_beam_kw(num_particles=2048, max_particles=2048,
                                    kld_eval_window=0)),
            torch_map, tracking_capacity=1024, tracking_ess_threshold=0.9)
        model = staged.big if spec["staged"] == "big" else staged.small
    else:
        model = tstep.make_model(FilterConfig(**_beam_kw(**kw)), torch_map)
    return model, model.init(0)


def _lidar3d_case():
    """A small 3-D lidar model (tests/test_torch_lidar3d.py's room) with
    one scan of 3 rings x 32 azimuths from its start pose."""
    from mcmh_localization_tpu_torch.maps import voxel_map as tvm
    from mcmh_localization_tpu_torch.models.sensor3d import simulate_scan3d
    from tests.test_torch_lidar3d import ORIGIN, _room_occupancy

    room = tvm.build_voxel_map(_room_occupancy(), 0.1, ORIGIN, device="cpu")
    nav = tvm.nav_slice(room, z=0.1)
    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=1024, min_particles=256,
        max_particles=1024, initialized=True, initial_pose=(0.0, -3.0, 0.0),
        max_range=6.0, sensor_model="lidar3d", lidar3d_sensor_z=1.0,
        sigma_hit=0.2, motion_validity="score")
    az = torch.linspace(-np.pi, np.pi, 33)[:-1]
    el = torch.tensor([-0.2, 0.0, 0.2])
    dirs = torch.stack([az.repeat(3), el.repeat_interleave(32)], 1)
    ranges = simulate_scan3d(None, (0.0, -3.0, 0.0), dirs, room, 6.0,
                             sensor_z=1.0)
    model = tstep.make_model(cfg, nav, voxel_map=room)
    return model, model.init(0), ranges, dirs, torch.tensor([0.0, 0.05, 0.0])


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_capturable_step_reads_nothing_on_the_host(house_map, torch_map,
                                                   monkeypatch, case):
    """One step of each graph-capturable config family under the guard:
    the single-program flagship's form (window + coarse fallback, ungated
    and gated at 8, from a cloud inside the window and one spread over the
    map: the gate takes each branch, and only the gate's plain version
    reads the host), the beam model's grid (``BEAM_GUARD``, its score
    field's gate on both sides too), the exact scorer in both cell forms
    under both motion validities, the 3-D lidar, and each mode with the
    "simple", "lvr" or systematic resampler under both validities."""
    spec = GUARD_CASES[case]
    ranges, angles, delta = _scan_inputs(house_map)
    if spec["kind"] == "lidar3d":
        model, state, ranges, angles, delta = _lidar3d_case()
    elif spec["kind"] == "beam":
        model, state = _beam_case(spec, torch_map)
    else:
        if spec["kind"] == "coarse":
            cfg = FilterConfig(**_main_path_kw(
                corr_coarse_factor=4, coarse_gate_escapees=spec["gate"],
                num_particles=2048, max_particles=2048, min_particles=500))
        elif spec["kind"] == "exact":
            cfg = FilterConfig(**_exact_kw(spec["impl"], spec["validity"]))
        else:
            cfg = FilterConfig(**_main_path_kw(
                mode=spec["mode"], num_particles=2048, max_particles=2048,
                min_particles=500, corr_coarse_factor=0,
                adaptive_resampler=("kld" if spec["resampler"] == "systematic"
                                    else spec["resampler"]),
                motion_validity=spec["validity"]))
        model = tstep.make_model(cfg, torch_map)
        state = model.init(0)
    assert _replays_on_card(model.config)
    builds = []
    if spec.get("side"):
        if spec["side"] == "above":
            # a cloud over the whole map: escapees far past the gate
            from mcmh_localization_tpu_torch.filter.init import init_uniform

            spread = init_uniform(state.n_max, torch_map,
                                  generator=torch.Generator().manual_seed(1))
            state = state.replace(particles=spread, prev_particles=spread)
        module, name = ((trt, "_beam_coarse_field") if spec["kind"] == "beam"
                        else (tcf, "_coarse_field"))
        plain = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: (
            builds.append(1), plain(*a, **k))[1])
    if spec["kind"] == "beam" or (spec["kind"] == "grid" and spec["mode"] in (
            "AMCL", "MHAMCL", "AMHAMCL")):
        # the augmented-MCL averages apart: the candidates replace slots
        state = state.replace(w_slow=torch.tensor(1.0),
                              w_fast=torch.tensor(0.5))
    with no_host_reads(monkeypatch):
        new, info = model.step(state, ranges, angles, delta)
    assert np.isfinite(info.estimate.mean.numpy()).all()
    assert 0 < int(new.count) <= state.n_max
    if spec.get("side"):
        gated_off = spec.get("gate", 8) and spec["side"] == "below"
        assert len(builds) == (0 if gated_off else 1)


def test_run_if_plain_version():
    """Off a capture ``run_if`` is a host if: the body's results where the
    predicate holds, the carry (the same tensors) where it does not."""
    carry = [torch.zeros(3), torch.tensor(7)]

    def body():
        return [torch.ones(3), torch.tensor(9)]

    taken = tgraph.run_if(torch.tensor(True), body, carry)
    assert torch.equal(taken[0], torch.ones(3)) and int(taken[1]) == 9
    skipped = tgraph.run_if(torch.tensor(False), body, carry)
    assert skipped[0] is carry[0] and skipped[1] is carry[1]


# ---------------------------------------------------------------------------
# one scan of each gate's branches against JAX's step on JAX's draws
# ---------------------------------------------------------------------------

SCAN_CASES = {
    # the BIG program: full map, all bins, "sum", refill
    "inject": dict(program="big", w=(1.0, 0.5)),
    "no_inject": dict(program="big", w=None),
    # the SMALL program, ESS-gated at 0.9: skipped on fresh weights,
    # resampled where augmented MCL wants to inject
    "ess_skipped": dict(program="small", w=None),
    "ess_resampled": dict(program="small", w=(1.0, 0.5)),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_gate_branches_match_jax_on_jax_draws(house_map, torch_map,
                                              monkeypatch, case):
    """One AMHAMCL scan on JAX's draws (tests/test_torch_filter.py::
    _scan_draws) through each gate's taken and untaken branch.  The count
    is equal; estimate, ESS and bookkeeping within rtol 1e-4 (f32
    reductions in another order); at most 0.5% of the active slots hold
    another particle (a cumsum in another order can move a segment bound
    by one)."""
    from tests.test_torch_filter import _scan_draws

    monkeypatch.setattr(jres, "_KLD_STAGE1", 1024)
    monkeypatch.setattr(tres, "_KLD_STAGE1", 1024)
    spec = SCAN_CASES[case]
    n_max = 4096
    kw = _main_path_kw(num_particles=n_max, max_particles=n_max,
                       min_particles=600, corr_coarse_factor=0)
    if spec["program"] == "big":
        kw.update(corr_window_cells=0, corr_theta_window_bins=0,
                  score_aggregation="sum", injection_refill=True)
    else:
        kw.update(resample_ess_threshold=0.9)
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    assert _replays_on_card(tcfg)
    ranges, angles, delta = _scan_inputs(house_map)
    jm = jstep.make_model(jcfg, house_map)
    js = jm.init(jax.random.PRNGKey(0))
    if spec["w"] is not None:
        js = js.replace(w_slow=jnp.float32(spec["w"][0]),
                        w_fast=jnp.float32(spec["w"][1]))
    before = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    js2, jinfo = jm.step(js, jnp.asarray(ranges.numpy()),
                         jnp.asarray(angles.numpy()),
                         jnp.asarray(delta.numpy()))

    tm = tstep.make_model(tcfg, torch_map)
    tm.log_field = _t(jm.log_field)
    w1 = max(1024, 600 + 600 // 4)
    draws = _scan_draws(js.key, n_max, w1, house_map.free_xy.shape[0])
    ts = state_from_numpy(before, device="cpu")
    ts2, tinfo = tm.step(ts, ranges, angles, delta, draws)

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
    p_random = float(jinfo.p_random)
    if case in ("inject", "ess_resampled"):
        assert p_random > 0.02                  # the branch ran
    else:
        assert p_random == 0.0
    if case == "ess_skipped":
        assert count == n_max                   # the gate kept the set


# ---------------------------------------------------------------------------
# the window origin on the device
# ---------------------------------------------------------------------------

WIN, TW, N_THETA = 64, 16, 48
ORIGIN_CASES = {
    # anchor near the map's low corner: both coordinates clamp to 0
    "low_clamp": dict(anchor=(-4.7, -4.7, 0.3)),
    # near the high corner: both clamp to h - win
    "high_clamp": dict(anchor=(4.7, 4.7, 0.3)),
    # heading just past -pi + 7 bins: kstart wraps to n_theta - 1
    "theta_wrap": dict(anchor=(1.0, 1.0, -np.pi + 7.5 * 2 * np.pi / N_THETA)),
    # the cloud mean (window_center="mean") near the high corner
    "mean_center": dict(anchor=(4.6, 4.6, 0.3), window_center="mean"),
}


@pytest.mark.parametrize("case", list(ORIGIN_CASES))
def test_window_origin_matches_jax(house_map, torch_map, case):
    """``_window_origin`` is a (3,) int32 tensor equal to JAX's origin
    clipped as JAX's scorer clips it; the corr scores at it match JAX's
    (rtol 1e-5, f32 field sums in another order); and the field build at
    the device-held origin equals, bitwise, the region sliced out on the
    host, and the lookup there the lookup at the origin JAX's ints give."""
    spec = ORIGIN_CASES[case]
    kw = _main_path_kw(num_particles=512, max_particles=512, min_particles=64,
                       corr_window_cells=WIN, corr_theta_window_bins=TW,
                       corr_coarse_factor=0,
                       window_center=spec.get("window_center", "anchor"))
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    jm = jstep.make_model(jcfg, house_map)
    rng = np.random.default_rng(3)
    anchor = np.float32(spec["anchor"])
    parts = (anchor + rng.normal(0, [0.1, 0.1, 0.05], (512, 3))).astype(
        np.float32)
    js = jm.init(jax.random.PRNGKey(0)).replace(
        particles=jnp.asarray(parts), prev_particles=jnp.asarray(parts),
        anchor=jnp.asarray(anchor))
    state = state_from_numpy({f: np.asarray(getattr(js, f))
                              for f in STATE_FIELDS}, device="cpu")
    h, w = house_map.occupancy.shape
    j_oy, j_ox, j_k = (int(x) for x in jstep._window_origin(js, house_map,
                                                             jcfg))
    want = [min(max(j_oy, 0), h - WIN), min(max(j_ox, 0), w - WIN), j_k]
    origin = tstep._window_origin(state, torch_map, tcfg)
    assert origin.dtype == torch.int32 and origin.shape == (3,)
    assert origin.tolist() == want
    if case == "low_clamp":
        assert want[:2] == [0, 0]
    if case in ("high_clamp", "mean_center"):
        assert want[:2] == [h - WIN, w - WIN]
    if case == "theta_wrap":
        assert want[2] == N_THETA - 1

    # the scores at that origin against JAX's, on JAX's log field
    ranges, angles, _ = _scan_inputs(house_map)
    lf = j_log_field(house_map, jcfg)
    j_scores = np.asarray(jcf.correlation_field_scores(
        jnp.asarray(parts), jnp.asarray(ranges.numpy()),
        jnp.asarray(angles.numpy()), house_map, jcfg, log_field=lf,
        n_theta=N_THETA, window_origin=tuple(jnp.int32(x) for x in
                                             (j_oy, j_ox, j_k))))
    t_scores = tcf.correlation_field_scores(
        _t(parts), ranges, angles, torch_map, tcfg, log_field=_t(lf),
        n_theta=N_THETA, window_origin=origin).numpy()
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5, atol=1e-5)

    # kernel 1's and kernel 2's plain versions at the device-held origin,
    # bitwise: the build against the host-sliced region, the lookup against
    # the one at JAX's origin
    log_field = _t(lf)
    pad = tcf.pad_cells_for(tcfg, torch_map)
    padded0 = torch.nn.functional.pad(log_field, (pad, pad, pad, pad))
    zero_row = padded0.shape[0]
    valid = torch.isfinite(ranges) & (ranges < tcfg.max_range)
    safe = torch.where(valid, ranges, 0.0)
    u, v = safe * torch.cos(angles), safe * torch.sin(angles)
    ox, oy = tcf._bin_offsets(u, v, valid, torch_map.inv_res, N_THETA, pad,
                              zero_row, bin_start=origin[2], nbins=TW)
    ox_h, oy_h = tcf._bin_offsets(u, v, valid, torch_map.inv_res, N_THETA,
                                  pad, zero_row, bin_start=want[2], nbins=TW)
    assert torch.equal(ox, ox_h) and torch.equal(oy, oy_h)
    field = corr_field_build(padded0, ox, oy, WIN, WIN, origin=origin,
                             zero_row=zero_row)
    oy0, ox0 = want[:2]
    side = WIN + 2 * pad
    region = torch.cat([padded0[oy0:oy0 + side, ox0:ox0 + side],
                        torch.zeros((WIN, side))])
    host = corr_field_build(region, ox, torch.where(oy >= zero_row, side, oy),
                            WIN, WIN)
    assert torch.equal(field, host)
    n_valid = valid.sum().to(torch.int32)
    common = (torch_map.origin_xy[0], torch_map.origin_xy[1],
              torch_map.inv_res, N_THETA, TW, WIN, WIN, h, w)
    geo = LookupGeometry(*common, theta_window=True, space_window=True)
    spec_origin = torch.tensor(want, dtype=torch.int32)
    for agg in ("mean", "sum"):
        assert torch.equal(
            corr_lookup(field, _t(parts), n_valid, geo, agg, True,
                        origin=origin),
            corr_lookup(field, _t(parts), n_valid, geo, agg, True,
                        origin=spec_origin))


# ---------------------------------------------------------------------------
# kld_resample past its stage-1 prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["stage1_stop", "escalated"])
def test_kld_resample_262144_matches_jax(monkeypatch, case):
    """At max_samples = 262 144 the stage-1 prefix (w1 = 131 072) is the
    real one, not a test-sized stand-in: a converged cloud stops inside
    it, a diffuse one escalates through ``run_if``.  n_kept is equal; on
    JAX's segment bounds the kept samples agree within an ulp of their
    magnitude (rtol 1e-6, atol 1e-7: XLA may fuse the jitter's multiply-add
    into one rounding), with at most 0.5% of the kept rows holding another
    particle (the JAX escalation recomputes its bounds with another fusion
    of ceil(c * count - r))."""
    from tests.test_torch_resampling import _cloud, _integer_weights, _kld_draws

    rng = np.random.default_rng(5)
    n_max, min_p = 262_144, 20_000
    kw = dict(bin_size_xy=0.2, bin_size_theta=0.1745, epsilon=0.03, z=2.0)
    parts = _cloud(n_max, rng, 3.0 if case == "escalated" else 0.15)
    w = _integer_weights(n_max, rng, "spread")
    count = 250_000
    key = jax.random.PRNGKey(23)
    k_idx = jax.random.split(key, 3)[0]

    def jax_bounds(weights, num_out, count=None, r=None):
        c = None if count is None else jnp.asarray(np.asarray(count))
        return torch.from_numpy(np.array(jres._segment_bounds(
            k_idx, jnp.asarray(weights.numpy()), num_out, c)))

    monkeypatch.setattr(tres, "_segment_bounds", jax_bounds)
    s_j, k_j = jres.kld_resample(
        key, jnp.asarray(parts), jnp.asarray(w), n_max, min_p,
        count=jnp.int32(count), **kw)
    w1, tail = tres.kld_noise_rows(n_max, min_p)
    assert (w1, tail) == (131_072, n_max - 131_072)
    s_t, k_t = tres.kld_resample(
        _t(parts), _t(w), n_max, min_p,
        count=torch.tensor(count, dtype=torch.int32),
        **_kld_draws(key, n_max, w1), **kw)
    n_kept = int(k_j)
    assert int(k_t) == n_kept
    if case == "escalated":
        assert n_kept > w1
    else:
        assert min_p <= n_kept < w1
    keep = min(n_kept, count)
    a, b = s_t.numpy()[:keep], np.asarray(s_j)[:keep]
    moved = np.abs(a - b).max(axis=1) > 1e-5
    assert moved.mean() <= 0.005
    np.testing.assert_allclose(a[~moved], b[~moved], rtol=1e-6, atol=1e-7)


def test_resample_draws_are_static(house_map, torch_map):
    """A capturable config's scan makes every resampling draw whichever
    branches run: the generator ends a scan that injects and escalates
    where it ends one that does neither."""
    cfg = FilterConfig(**_main_path_kw(num_particles=4096, max_particles=4096,
                                       min_particles=600,
                                       corr_window_cells=0,
                                       corr_theta_window_bins=0))
    model = tstep.make_model(cfg, torch_map)
    ranges, angles, delta = _scan_inputs(house_map)
    keys, p_random = [], []
    for w in ((0.5, 1.0), (1.0, 0.5)):
        st = model.init(0)
        st = st.replace(w_slow=torch.tensor(w[0]), w_fast=torch.tensor(w[1]))
        _, info = model.step(st, ranges, angles, delta)
        keys.append(st.key.get_state())
        p_random.append(float(info.p_random))
    assert p_random[0] == 0.0 and p_random[1] > 0.02
    assert torch.equal(keys[0], keys[1])
