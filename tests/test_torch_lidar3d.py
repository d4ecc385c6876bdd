"""The port's 3-D lidar (maps/voxel_map.py, models/sensor3d.py and the fused
3-D scorer's plain version, ops/scan_scores.py::voxel_scores_plain) against
the JAX package on the same voxel map: twins of tests/test_lidar3d.py, the
scorer's lane order, one scan on shared draws, the staged runner and the
online facade with a voxel map."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter.step import make_model as j_make_model  # noqa: E402
from mcmh_localization_tpu.maps import voxel_map as jvm  # noqa: E402
from mcmh_localization_tpu.models.sensor3d import (  # noqa: E402
    lidar3d_scores as j_lidar3d_scores,
)
from mcmh_localization_tpu.ops import resampling as jres  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import (  # noqa: E402
    STATE_FIELDS,
    state_from_numpy,
    voxel_map_from_numpy,
)
from mcmh_localization_tpu_torch.filter.online import OnlineLocalizer  # noqa: E402
from mcmh_localization_tpu_torch.filter.staged import (  # noqa: E402
    make_staged_model,
    run_staged,
)
from mcmh_localization_tpu_torch.filter.step import make_model  # noqa: E402
from mcmh_localization_tpu_torch.maps import voxel_map as tvm  # noqa: E402
from mcmh_localization_tpu_torch.models.sensor3d import (  # noqa: E402
    lidar3d_log_volume,
    lidar3d_scores,
    scan_beams,
    simulate_scan3d,
    voxel_geometry,
)
from mcmh_localization_tpu_torch.ops import resampling as tres  # noqa: E402
from mcmh_localization_tpu_torch.filter.step import _sensor_table  # noqa: E402
from mcmh_localization_tpu_torch.ops.scan_scores import (  # noqa: E402
    MAX_VOXEL_LEVELS,
    VoxelLevels,
    tile_planes,
    tiled_offsets,
    voxel_lanes,
    voxel_levels,
    voxel_scores_plain,
)
from mcmh_localization_tpu_torch.sim.simulator import odometry_deltas  # noqa: E402
from tests.test_torch_filter import _scan_draws  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

ORIGIN = (-5.0, -5.0, 0.0)
LANES = (1, 2, 4, 8, 16, 32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _room_occupancy():
    """tests/test_lidar3d.py's room3d: 10 x 10 x 3 m at 0.1 m voxels, walls,
    a floor, a 1 m table block and a hanging shelf at 2.0-2.5 m."""
    d, h, w = 30, 100, 100
    occ = np.zeros((d, h, w), dtype=np.int8)
    occ[:, 0, :] = occ[:, -1, :] = 100
    occ[:, :, 0] = occ[:, :, -1] = 100
    occ[0, :, :] = 100
    occ[0:10, 40:60, 60:80] = 100
    occ[20:25, 20:40, 20:40] = 100
    return occ


@pytest.fixture(scope="module")
def rooms():
    occ = _room_occupancy()
    return (jvm.build_voxel_map(occ, 0.1, ORIGIN),
            tvm.build_voxel_map(occ, 0.1, ORIGIN, device="cpu"))


def _scorer_inputs(n=24, m=40, seed=0):
    rng = np.random.default_rng(seed)
    particles = np.stack([
        rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
        rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    el = rng.uniform(-0.3, 0.3, m).astype(np.float32)
    ranges = rng.uniform(0.5, 4.5, m).astype(np.float32)
    ranges[::7] = np.inf  # invalid beams
    return particles, ranges, np.stack([az, el], 1)


# ---------------------------------------------------------------------------
# twins of tests/test_lidar3d.py
# ---------------------------------------------------------------------------

def test_voxel_edt_and_transforms(rooms):
    """The EDT is scipy's on both sides (bitwise); world_to_voxel copies
    JAX's multiply form, so the voxels of the same f32 points are the same;
    the JAX test's centre distance and free checks hold."""
    jroom, troom = rooms
    np.testing.assert_array_equal(troom.distance.numpy(),
                                  np.asarray(jroom.distance))
    np.testing.assert_array_equal(troom.occupancy.numpy(),
                                  np.asarray(jroom.occupancy))
    assert (troom.depth, troom.height, troom.width) == (30, 100, 100)
    assert troom.resolution == jroom.resolution
    assert troom.origin == jroom.origin
    rng = np.random.default_rng(1)
    # points near voxel edges too: multiples of the resolution plus an ulp
    pts = np.concatenate([
        rng.uniform([-6, -6, -0.5], [6, 6, 3.5], (2000, 3)),
        np.round(rng.uniform([-5, -5, 0], [5, 5, 3], (2000, 3)), 1),
    ]).astype(np.float32)
    got = troom.world_to_voxel(*_t(pts).unbind(1))
    want = jroom.world_to_voxel(*jnp.asarray(pts).T)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        troom.in_bounds(*got).numpy(), np.asarray(jroom.in_bounds(*want)))
    np.testing.assert_array_equal(
        troom.is_free_world(*_t(pts).unbind(1)).numpy(),
        np.asarray(jroom.is_free_world(*jnp.asarray(pts).T)))
    vx, vy, vz = troom.world_to_voxel(torch.tensor(0.0), torch.tensor(-3.0),
                                      torch.tensor(1.5))
    assert bool(troom.in_bounds(vx, vy, vz))
    assert float(troom.distance[vz, vy, vx]) > 0.5
    assert bool(troom.is_free_world(torch.tensor(0.0), torch.tensor(-3.0),
                                    torch.tensor(1.5)))
    assert not bool(troom.is_free_world(torch.tensor(2.0), torch.tensor(0.0),
                                        torch.tensor(0.5)))  # the table


def test_raycast3d_wall_distance(rooms):
    """The JAX test's three rays, then 2000 random rays against JAX's march:
    cos and sin round an ulp apart between XLA and torch, which can move a
    sample across a voxel edge, so at most 2% of rays may differ, each by
    one 0.1 m step."""
    jroom, troom = rooms
    r = tvm.raycast3d(torch.tensor([0.0, 0.0, 1.5]), torch.tensor([0.0]),
                      torch.tensor([0.0]), troom, 8.0)
    assert abs(float(r[0]) - 4.9) < 0.15
    r_up = tvm.raycast3d(torch.tensor([0.0, 0.0, 1.5]), torch.tensor([0.0]),
                         torch.tensor([1.2]), troom, 8.0)
    assert float(r_up[0]) == 8.0
    az = np.arctan2(-2.0, -2.0)
    r_shelf = tvm.raycast3d(torch.tensor([0.0, 0.0, 1.0]),
                            torch.tensor([az, az], dtype=torch.float32),
                            torch.tensor([0.45, 0.0]), troom, 8.0)
    assert float(r_shelf[0]) < float(r_shelf[1]) - 0.5

    rng = np.random.default_rng(2)
    azs = rng.uniform(-np.pi, np.pi, 2000).astype(np.float32)
    els = rng.uniform(-0.6, 0.6, 2000).astype(np.float32)
    origin = np.float32([0.3, -1.2, 1.1])
    got = tvm.raycast3d(_t(origin), _t(azs), _t(els), troom, 8.0).numpy()
    want = np.asarray(jvm.raycast3d(jnp.asarray(origin), jnp.asarray(azs),
                                    jnp.asarray(els), jroom, 8.0))
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= 0.02
    assert diff.max() <= 0.1 + 1e-5


@pytest.mark.parametrize("aggregation", ["mean", "sum"])
def test_lidar3d_scores_match_numpy_loop(rooms, aggregation):
    """The port's scorer against JAX's ``lidar3d_scores`` on the CPU (its
    exact XLA gather) within 2e-5 (cos, sin, exp and log round an ulp apart
    between XLA and torch; the beam sum runs in another order), and against
    the JAX test's numpy loop (its 2e-4)."""
    jroom, troom = rooms
    particles, ranges, dirs = _scorer_inputs()
    kw = dict(max_range=5.0, sigma_hit=0.2, step=1,
              score_aggregation=aggregation)
    want = np.asarray(j_lidar3d_scores(
        jnp.asarray(particles), jnp.asarray(ranges), jnp.asarray(dirs), jroom,
        JConfig(**kw), sensor_z=1.0))
    got = lidar3d_scores(_t(particles), _t(ranges), _t(dirs), troom,
                         FilterConfig(**kw), sensor_z=1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    dist = troom.distance.numpy()
    res, org = 0.1, ORIGIN
    ref = np.zeros(len(particles))
    for i, (x, y, th) in enumerate(particles):
        acc, cnt = 0.0, 0
        for j, r in enumerate(ranges):
            if not (np.isfinite(r) and r < 5.0):
                continue
            cnt += 1
            az, el = dirs[j]
            ex = x + r * np.cos(el) * np.cos(th + az)
            ey = y + r * np.cos(el) * np.sin(th + az)
            ez = 1.0 + r * np.sin(el)
            vx = int(np.floor((ex - org[0]) / res))
            vy = int(np.floor((ey - org[1]) / res))
            vz = int(np.floor((ez - org[2]) / res))
            if not (0 <= vx < 100 and 0 <= vy < 100 and 0 <= vz < 30):
                continue
            d = dist[vz, vy, vx]
            ph = np.exp(-0.5 * (d / 0.2) ** 2) / np.sqrt(2 * np.pi * 0.2**2)
            acc += np.log(max(0.75 * ph + 0.25 / 5.0, 1e-6))
        ref[i] = (acc if aggregation == "sum" else acc / max(cnt, 1)) \
            if cnt else -50.0
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    # a blind scan scores the penalty
    blind = lidar3d_scores(_t(particles), _t(np.full(40, np.inf, np.float32)),
                           _t(dirs), troom, FilterConfig(**kw), sensor_z=1.0)
    assert (blind == -50.0).all()


def _directions():
    azimuths = np.linspace(-np.pi, np.pi, 32, endpoint=False)
    rings = np.asarray([-0.15, 0.0, 0.2])
    return np.stack([np.repeat(azimuths, 3), np.tile(rings, 32)],
                    1).astype(np.float32)


def _square_poses(t_steps=40):
    poses = [np.array([0.0, -3.0, 0.0])]
    for _ in range(t_steps):
        p = poses[-1].copy()
        p[2] += 0.08
        p[0] += 0.08 * np.cos(p[2])
        p[1] += 0.08 * np.sin(p[2])
        poses.append(p)
    return np.asarray(poses, dtype=np.float32)


def _scans(troom, poses, dirs, sensor_z, max_range, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([
        simulate_scan3d(gen, p, _t(dirs), troom, max_range,
                        sensor_z=sensor_z, noise=0.01) for p in poses])


def test_lidar3d_filter_tracks(rooms):
    """The JAX test's filter with the 3-D sensor on the port: a 32-azimuth
    x 3-ring scanner, MCL at 400 particles, initialized tracking, ends
    within JAX's 0.3 m."""
    _, troom = rooms
    nav = tvm.nav_slice(troom, z=0.1)
    dirs = _directions()
    cfg = FilterConfig(
        mode="MCL", num_particles=400, initialized=True,
        initial_pose=(0.0, -3.0, 0.0), max_range=6.0,
        sensor_model="lidar3d", lidar3d_sensor_z=1.0, sigma_hit=0.2,
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
    )
    model = make_model(cfg, nav, voxel_map=troom)
    poses = _square_poses()
    scans = _scans(troom, poses, dirs, 1.0, cfg.max_range)
    deltas = odometry_deltas(poses)
    _, infos = model.run(model.init(0), scans, dirs, deltas)
    est = infos.estimate.mean.numpy()
    err = np.hypot(est[-1, 0] - poses[-1, 0], est[-1, 1] - poses[-1, 1])
    assert err < 0.3, err


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_voxel_map_roundtrip(rooms, tmp_path, writer):
    """The npz keys are JAX's: a file written by either package loads in
    both, with the same occupancy, EDT and metadata."""
    jroom, troom = rooms
    path = str(tmp_path / "room.npz")
    if writer == "port":
        tvm.save_voxel_map(path, troom)
    else:
        jvm.save_voxel_map(path, jroom)
    tback = tvm.load_voxel_map(path, device="cpu")
    jback = jvm.load_voxel_map(path)
    for back in (tback, jback):
        np.testing.assert_array_equal(np.asarray(back.occupancy),
                                      troom.occupancy.numpy())
        np.testing.assert_array_equal(np.asarray(back.distance),
                                      troom.distance.numpy())
        assert back.resolution == troom.resolution
        assert back.origin == troom.origin
        assert back.max_distance is None
    capped = tvm.build_voxel_map(_room_occupancy(), 0.1, ORIGIN,
                                 max_distance=0.5, device="cpu")
    tvm.save_voxel_map(path, capped)
    jcap = jvm.load_voxel_map(path)
    assert jcap.max_distance == 0.5
    np.testing.assert_array_equal(np.asarray(jcap.distance),
                                  capped.distance.numpy())


# ---------------------------------------------------------------------------
# the fused 3-D scorer's plain version, its lane order
# ---------------------------------------------------------------------------

def _numpy_lane_scores(particles, u, v, zrow, live, volume, geo, count,
                       aggregation, lanes):
    """A numpy f32 loop in the kernel's order: lane g of a pose adds the
    live beams g, g + lanes, ... from +0.0, then an xor butterfly; c and s
    are torch's, as the plain version takes them."""
    f32 = np.float32
    c = torch.cos(_t(particles[:, 2])).numpy()
    s = torch.sin(_t(particles[:, 2])).numpy()
    ul, vl, zl = u[live], v[live], zrow[live]
    flat = volume.reshape(-1)
    out = np.zeros(len(particles), np.float32)
    for i, (x, y, _) in enumerate(particles):
        acc = np.zeros(lanes, np.float32)
        for j in range(len(ul)):
            lx = f32(f32(x + f32(c[i] * ul[j])) - f32(s[i] * vl[j]))
            ly = f32(f32(y + f32(s[i] * ul[j])) + f32(c[i] * vl[j]))
            vx = int(np.floor(f32(f32(lx - f32(geo.origin_x)) * f32(geo.inv))))
            vy = int(np.floor(f32(f32(ly - f32(geo.origin_y)) * f32(geo.inv))))
            if 0 <= vx < geo.w and 0 <= vy < geo.h:
                g = j % lanes
                acc[g] = f32(acc[g] + flat[(zl[j] + vy) * geo.w + vx])
        k = lanes
        while k > 1:
            k //= 2
            acc = (acc[:k] + acc[k:2 * k]).astype(np.float32)
        total = acc[0]
        score = total if aggregation == "sum" else f32(total / f32(max(count, 1)))
        out[i] = score if count > 0 else -50.0
    return out


@pytest.mark.parametrize("lanes", LANES)
def test_voxel_scores_plain_lane_order_bitwise(rooms, lanes):
    """The plain version sums each pose's beams in the kernel's lane order:
    bitwise equal to a numpy f32 loop in that order, at every G, whole and
    in chunks of 5 poses."""
    _, troom = rooms
    particles, ranges, dirs = _scorer_inputs(n=30, m=70, seed=3)
    particles[:3, :2] = [[-9.0, 0.0], [0.0, 7.5], [4.99, -4.99]]  # off map
    cfg = FilterConfig(max_range=5.0, sigma_hit=0.2)
    vol = lidar3d_log_volume(troom, cfg)
    u, v, zrow, live, count = scan_beams(_t(ranges), _t(dirs), troom, cfg, 1.0)
    geo = voxel_geometry(troom)
    args = (_t(particles), u, v, zrow, live, voxel_levels(vol), geo, count,
            "mean")
    got = voxel_scores_plain(*args, lanes=lanes).numpy()
    want = _numpy_lane_scores(particles, u.numpy(), v.numpy(), zrow.numpy(),
                              live.numpy(), vol.numpy(), geo, int(count),
                              "mean", lanes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        voxel_scores_plain(*args, lanes=lanes, chunk=5).numpy(), got)
    assert int(live.sum()) < int(count) <= 70   # some beams leave the volume


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def _small_building():
    """A 4 x 4 x 1 m building at 0.05 m (80 x 80 x 20 voxels): a floor,
    walls with a door, a table and a hanging shelf."""
    occ = np.zeros((20, 80, 80), dtype=np.int8)
    occ[0] = 100
    occ[:, :2, :] = occ[:, -2:, :] = occ[:, :, :2] = occ[:, :, -2:] = 100
    occ[:, 40, 2:50] = 100
    occ[:, 40, 20:30] = 0
    occ[:8, 55:65, 50:70] = 100
    occ[14:17, 10:20, 60:75] = 100
    return tvm.build_voxel_map(occ, 0.05, (-2.0, -2.0, 0.0), device="cpu")


def _voxel_index(vm):
    d, h, w = vm.depth, vm.height, vm.width
    z, y, x = torch.meshgrid(torch.arange(d), torch.arange(h), torch.arange(w),
                             indexing="ij")
    return tiled_offsets(z, y, x, h, w)


@pytest.mark.parametrize("where", ["room3d", "small building"])
def test_voxel_levels_round_trip_bitwise(rooms, where):
    """Form (b)'s level form of the log-mixture volume gives every voxel
    back bit for bit through the bricked 16-bit index (``levels[index]``):
    beyond about 6.5 sigma from a surface every voxel holds one value, so
    the levels stay few."""
    vm = rooms[1] if where == "room3d" else _small_building()
    vol = lidar3d_log_volume(vm, FilterConfig(max_range=6.0))
    lv = voxel_levels(vol)
    assert lv.volume is None and lv.index.dtype == torch.int16
    assert lv.levels.numel() <= MAX_VOXEL_LEVELS
    got = lv.levels[lv.index[_voxel_index(vm)].to(torch.int64)]
    np.testing.assert_array_equal(_bits(got), _bits(vol))


@pytest.mark.parametrize("shape", [(3, 13, 21), (2, 8, 8), (1, 17, 9)])
def test_tile_planes_round_trip(shape):
    """The brick layout: each plane padded to whole 4 x 4 bricks, a voxel
    found again at ``tiled_offsets``, each brick's 16 values in one
    32-byte sector, the bricks of a plane row-major."""
    d, h, w = shape
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -2**15, 2**15, shape).astype(np.int16))
    t = tile_planes(x)
    hp, wp = -(-h // 4) * 4, -(-w // 4) * 4
    assert t.shape == (d * hp * wp,)
    z, y, xx = torch.meshgrid(torch.arange(d), torch.arange(h),
                              torch.arange(w), indexing="ij")
    off = tiled_offsets(z, y, xx, h, w)
    np.testing.assert_array_equal(t[off].numpy(), x.numpy())
    assert off.unique().numel() == off.numel()
    sector = off // 16
    assert (sector == (z * (hp // 4) + y // 4) * (wp // 4) + xx // 4).all()
    assert (off % 16 == (y % 4) * 4 + xx % 4).all()


def _hall3d():
    """A 20 x 20 x 2 m hall at 0.1 m holding two single occupied voxels:
    the distances are the square roots of thousands of sums of squares,
    and under a sigma of 3 m the log volume keeps nearly each one a level
    of its own, more than MAX_VOXEL_LEVELS."""
    occ = np.zeros((20, 200, 200), dtype=np.int8)
    occ[0, 100, 100] = 100
    occ[10, 50, 150] = 100
    return (jvm.build_voxel_map(occ, 0.1, (-10.0, -10.0, 0.0)),
            tvm.build_voxel_map(occ, 0.1, (-10.0, -10.0, 0.0), device="cpu"))


@pytest.mark.parametrize("aggregation", ["mean", "sum"])
def test_voxel_levels_past_the_cap_keep_the_f32_form(aggregation):
    """A sigma large against the resolution gives more levels than the
    kernel stages: the dispatch keeps the f32 volume (no refusal), and the
    port's scorer still matches JAX's ``lidar3d_scores`` within 2e-5."""
    jhall, thall = _hall3d()
    kw = dict(max_range=9.0, sigma_hit=3.0, step=1,
              score_aggregation=aggregation)
    lv = voxel_levels(lidar3d_log_volume(thall, FilterConfig(**kw)))
    assert lv.index is None and lv.levels is None and lv.volume is not None
    particles, ranges, dirs = _scorer_inputs(n=40, m=50, seed=5)
    particles[:, :2] *= 2.0
    ranges *= 1.8
    want = np.asarray(j_lidar3d_scores(
        jnp.asarray(particles), jnp.asarray(ranges), jnp.asarray(dirs),
        jhall, JConfig(**kw), sensor_z=1.0))
    got = lidar3d_scores(_t(particles), _t(ranges), _t(dirs), thall,
                         FilterConfig(**kw), sensor_z=1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("lanes", LANES)
def test_voxel_scores_plain_f32_form_lane_order_bitwise(rooms, lanes):
    """The f32 form (a volume past MAX_VOXEL_LEVELS takes it) sums in the
    kernel's lane order too, and equals the level form bitwise."""
    _, troom = rooms
    particles, ranges, dirs = _scorer_inputs(n=30, m=70, seed=4)
    cfg = FilterConfig(max_range=5.0, sigma_hit=0.2)
    vol = lidar3d_log_volume(troom, cfg)
    u, v, zrow, live, count = scan_beams(_t(ranges), _t(dirs), troom, cfg, 1.0)
    geo = voxel_geometry(troom)
    f32 = voxel_scores_plain(_t(particles), u, v, zrow, live,
                             VoxelLevels(None, None, vol), geo, count, "sum",
                             lanes=lanes).numpy()
    want = _numpy_lane_scores(particles, u.numpy(), v.numpy(), zrow.numpy(),
                              live.numpy(), vol.numpy(), geo, int(count),
                              "sum", lanes)
    np.testing.assert_array_equal(f32, want)
    np.testing.assert_array_equal(
        voxel_scores_plain(_t(particles), u, v, zrow, live, voxel_levels(vol),
                           geo, count, "sum", lanes=lanes).numpy(), f32)


def test_voxel_lanes_rule():
    """Form (b)'s G: one lane a pose from a quarter of FILL_THREADS poses
    up (the [lidar3d] shape, 2 x 100k, takes G = 1), more lanes below;
    nonincreasing in N."""
    assert voxel_lanes(200_000) == 1 and voxel_lanes(1 << 16) == 1
    assert voxel_lanes((1 << 16) - 1) == 2 and voxel_lanes(800) == 32
    gs = [voxel_lanes(n) for n in (1, 100, 3000, 20_000, 65_536, 10**6)]
    assert gs == sorted(gs, reverse=True)


def test_lidar3d_sensor_table_is_the_level_form(rooms):
    """The 3-D lidar's sensor table carries the log volume and its level
    form, built once per (map, config); the scorer reads the level form."""
    _, troom = rooms
    cfg = FilterConfig(sensor_model="lidar3d", max_range=6.0, sigma_hit=0.2)
    table = _sensor_table(tvm.nav_slice(troom, z=0.1), cfg, troom)
    assert table.voxel_map is troom
    assert table.levels.index.dtype == torch.int16
    np.testing.assert_array_equal(
        _bits(table.log_volume), _bits(lidar3d_log_volume(troom, cfg)))
    particles, ranges, dirs = _scorer_inputs(seed=6)
    args = (_t(particles), _t(ranges), _t(dirs), troom, cfg)
    np.testing.assert_array_equal(
        lidar3d_scores(*args, sensor_z=1.0, log_volume=table.levels).numpy(),
        lidar3d_scores(*args, sensor_z=1.0,
                       log_volume=table.log_volume).numpy())


# ---------------------------------------------------------------------------
# the filter with a voxel map
# ---------------------------------------------------------------------------

def test_nav_slice_matches_jax(rooms):
    jroom, troom = rooms
    for z in (0.1, 0.5, 2.2, -1.0, 9.0):
        jn, tn = jvm.nav_slice(jroom, z=z), tvm.nav_slice(troom, z=z)
        np.testing.assert_array_equal(tn.occupancy.numpy(),
                                      np.asarray(jn.occupancy))
        np.testing.assert_array_equal(tn.distance.numpy(),
                                      np.asarray(jn.distance))
        np.testing.assert_array_equal(tn.free_xy.numpy(),
                                      np.asarray(jn.free_xy))
        assert tn.origin_xy == tuple(np.asarray(jn.origin).tolist())
        assert tn.res == float(jn.resolution)


def test_one_scan_matches_jax_on_shared_draws(rooms, monkeypatch):
    """One AMHAMCL scan with the 3-D sensor ("score" validity, KLD with
    injection) on the JAX draws, from the same state: the same count,
    weights, estimate and particles within the tolerances of
    tests/test_torch_filter.py's 2-D twin."""
    jroom, troom = rooms
    monkeypatch.setattr(jres, "_KLD_STAGE1", 1024)
    monkeypatch.setattr(tres, "_KLD_STAGE1", 1024)
    n_max = 4096
    kw = dict(mode="AMHAMCL", num_particles=n_max, min_particles=600,
              max_particles=n_max, initialized=True,
              initial_pose=(0.0, -3.0, 0.0), initial_cov=(0.02, 0.02, 0.05),
              max_range=6.0, sensor_model="lidar3d", lidar3d_sensor_z=1.0,
              sigma_hit=0.2, motion_validity="score",
              min_injection_prob=0.02, estimate_mode="cluster",
              score_aggregation="sum", injection_refill=True)
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    jnav = jvm.nav_slice(jroom, z=0.1)
    tnav = tvm.nav_slice(voxel_map_from_numpy(
        np.asarray(jroom.occupancy), np.asarray(jroom.distance),
        jroom.resolution, jroom.origin, device="cpu"), z=0.1)
    dirs = _directions()
    poses = _square_poses(2)
    scan = _scans(troom, poses[1:2], dirs, 1.0, 6.0)[0].numpy()
    delta = odometry_deltas(poses[:2])[1]

    jm = j_make_model(jcfg, jnav, voxel_map=jroom)
    js = jm.init(jax.random.PRNGKey(0))
    js = js.replace(w_slow=jnp.float32(1.0), w_fast=jnp.float32(0.5))
    before = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    js2, jinfo = jm.step(js, jnp.asarray(scan), jnp.asarray(dirs),
                         jnp.asarray(delta))

    tm = make_model(tcfg, tnav, voxel_map=troom)
    draws = _scan_draws(js.key, n_max, max(1024, 600 + 600 // 4),
                        jnav.free_xy.shape[0])
    ts2, tinfo = tm.step(state_from_numpy(before, device="cpu"), _t(scan),
                         _t(dirs), _t(delta), draws)

    count = int(jinfo.count)
    assert int(tinfo.count) == count
    assert float(jinfo.p_random) > 0.02     # the injection branch ran
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


def test_staged_and_online_take_a_voxel_map(rooms):
    """``make_staged_model`` and ``OnlineLocalizer`` take the voxel map at
    JAX's position and run the 3-D sensor in both programs: the staged
    run starts in BIG and tracks, and the staged facade tracks scan by
    scan."""
    _, troom = rooms
    nav = tvm.nav_slice(troom, z=0.1)
    dirs = _directions()
    poses = _square_poses(24)
    scans = _scans(troom, poses, dirs, 1.0, 6.0, seed=4)
    deltas = odometry_deltas(poses)
    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=2000, min_particles=300,
        max_particles=2000, initialized=True, initial_pose=(0.0, -3.0, 0.0),
        max_range=6.0, sensor_model="lidar3d", lidar3d_sensor_z=1.0,
        sigma_hit=0.2, estimate_mode="cluster", motion_validity="score")
    staged = make_staged_model(cfg, nav, 1024, troom)
    assert staged.big.voxel_map is troom and staged.small.voxel_map is troom
    out = run_staged(staged, staged.init(2), scans, dirs, deltas, chunk=8)
    est = out.infos.estimate.mean.numpy()
    errs = np.hypot(est[:, 0] - poses[:, 0], est[:, 1] - poses[:, 1])
    assert out.modes[0] == 0
    assert np.mean(errs[-6:]) < 0.3, errs[-6:]

    loc = OnlineLocalizer(cfg, nav, seed=2, voxel_map=troom, staged=True,
                          tracking_capacity=1024)
    for p, scan in zip(poses, scans):
        loc.on_odom(float(p[0]), float(p[1]), float(p[2]))
        est = loc.on_scan(scan, angles=dirs)
    x, y, _ = est["pose3"]
    assert np.hypot(x - poses[-1, 0], y - poses[-1, 1]) < 0.3
