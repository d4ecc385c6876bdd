"""The port's ROS1 and ROS2 bag readers and writers against the JAX
package's (tests/test_rosbag.py, tests/test_rosbag2.py), on the CPU: twins
of those tests (the filter runs through the port), a bag written by the
JAX writers read the same by the port's readers, and both packages'
writers giving the same bytes for the same ``Bag``."""

import bz2
import sqlite3
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu.io import rosbag as jrb  # noqa: E402
from mcmh_localization_tpu.io import rosbag2 as jrb2  # noqa: E402
from mcmh_localization_tpu.sim.simulator import Bag as JBag  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.filter.step import make_model  # noqa: E402
from mcmh_localization_tpu_torch.io import rosbag as rb  # noqa: E402
from mcmh_localization_tpu_torch.io import rosbag2 as rb2  # noqa: E402
from mcmh_localization_tpu_torch.sim.simulator import (  # noqa: E402
    Bag,
    odometry_deltas,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

FORMATS = {"rosbag": (rb, jrb, "write_rosbag", "read_rosbag", "run.bag"),
           "rosbag2": (rb2, jrb2, "write_rosbag2", "read_rosbag2", "run.db3")}


@pytest.fixture()
def small_bag():
    rng = np.random.default_rng(0)
    t_steps, m = 12, 36
    times = 100.0 + np.arange(t_steps) * 0.25
    angles = np.linspace(-np.pi, np.pi, m, endpoint=False).astype(np.float32)
    ranges = rng.uniform(0.2, 4.5, size=(t_steps, m)).astype(np.float32)
    odom = np.cumsum(
        rng.normal(0, 0.05, size=(t_steps, 3)).astype(np.float32), axis=0
    )
    return Bag(ranges=ranges, angles=angles, odom=odom, gt=odom.copy(),
               times=times, max_range=5.0, meta={})


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


def _assert_read_back(out, small_bag):
    """The tolerances of the JAX round-trip tests: ranges to an f32 rtol,
    angles through (angle_min, increment), yaw through a quaternion."""
    np.testing.assert_allclose(out.ranges, small_bag.ranges, rtol=1e-6)
    np.testing.assert_allclose(out.angles, small_bag.angles, atol=2e-4)
    np.testing.assert_allclose(out.odom[:, :2], small_bag.odom[:, :2],
                               atol=1e-6)
    np.testing.assert_allclose(out.odom[:, 2], small_bag.odom[:, 2],
                               atol=1e-6)
    np.testing.assert_allclose(out.times, small_bag.times, atol=1e-6)
    assert out.max_range == small_bag.max_range
    assert out.meta["gt_from"] == "odom"


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_roundtrip(tmp_path, small_bag, fmt):
    """Twins of test_rosbag.py::test_roundtrip and
    test_rosbag2.py::test_roundtrip."""
    mod, _, write, read, name = FORMATS[fmt]
    path = str(tmp_path / name)
    getattr(mod, write)(path, small_bag)
    out = getattr(mod, read)(path)
    assert isinstance(out, Bag)
    _assert_read_back(out, small_bag)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_jax_written_bag_reads_the_same(tmp_path, small_bag, fmt):
    """A bag the JAX writer wrote reads in the port as in the JAX reader,
    bitwise, field for field."""
    mod, jmod, write, read, name = FORMATS[fmt]
    path = str(tmp_path / name)
    getattr(jmod, write)(path, JBag(*small_bag))
    want = getattr(jmod, read)(path)
    got = getattr(mod, read)(path)
    for f in ("ranges", "angles", "odom", "gt", "times"):
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.max_range == want.max_range and got.meta == want.meta
    _assert_read_back(got, small_bag)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_writers_give_the_same_bytes(tmp_path, small_bag, fmt):
    mod, jmod, write, _, name = FORMATS[fmt]
    getattr(mod, write)(str(tmp_path / f"port_{name}"), small_bag)
    getattr(jmod, write)(str(tmp_path / f"jax_{name}"), JBag(*small_bag))
    assert ((tmp_path / f"port_{name}").read_bytes()
            == (tmp_path / f"jax_{name}").read_bytes())


def test_reader_handles_bz2_chunks(tmp_path, small_bag):
    """Re-pack the writer's chunk with bz2 (the rosbag default option)."""
    path = str(tmp_path / "run.bag")
    rb.write_rosbag(path, small_bag)
    blob = open(path, "rb").read()
    off = len(rb.MAGIC)
    out = bytearray(rb.MAGIC)
    for header, data in rb._iter_records(blob, off):
        if header["op"][0] == rb._OP_CHUNK:
            comp = bz2.compress(data)
            h = rb._encode_header(
                {"op": bytes([rb._OP_CHUNK]), "compression": b"bz2",
                 "size": header["size"]}
            )
            out += struct.pack("<I", len(h)) + h
            out += struct.pack("<I", len(comp)) + comp
        else:
            h = rb._encode_header(header)
            out += struct.pack("<I", len(h)) + h
            out += struct.pack("<I", len(data)) + data
    p2 = str(tmp_path / "run_bz2.bag")
    open(p2, "wb").write(bytes(out))
    res = rb.read_rosbag(p2)
    np.testing.assert_allclose(res.ranges, small_bag.ranges, rtol=1e-6)


def test_messages_stream_order_and_types(tmp_path, small_bag):
    path = str(tmp_path / "run.bag")
    rb.write_rosbag(path, small_bag)
    msgs = list(rb.read_messages(path))
    topics = {t for t, _, _, _ in msgs}
    assert topics == {"/scan", "/odom"}
    types = {ty for _, ty, _, _ in msgs}
    assert types == {rb.LASERSCAN_TYPE, rb.ODOMETRY_TYPE}
    assert len(msgs) == 2 * len(small_bag.times)


def test_directory_input(tmp_path, small_bag):
    bag_dir = tmp_path / "rosbag2_2026_08_17"
    bag_dir.mkdir()
    rb2.write_rosbag2(str(bag_dir / "rosbag2_0.db3"), small_bag)
    (bag_dir / "metadata.yaml").write_text("rosbag2_bagfile_information: {}")
    out = rb2.read_rosbag2(str(bag_dir))
    np.testing.assert_allclose(out.ranges, small_bag.ranges, rtol=1e-6)


def test_cdr_alignment_odd_strings(tmp_path, small_bag):
    path = str(tmp_path / "run.db3")
    rb2.write_rosbag2(path, small_bag)
    con = sqlite3.connect(path)
    try:
        rows = list(con.execute(
            "SELECT id, timestamp FROM messages WHERE topic_id = 2 "
            "ORDER BY timestamp"
        ))
        for i, (mid, _ts) in enumerate(rows):
            blob = rb2.ser_odometry2(
                float(small_bag.times[i]), small_bag.odom[i],
                frame="o", child="base_link_f",
            )
            con.execute("UPDATE messages SET data = ? WHERE id = ?",
                        (blob, mid))
        con.commit()
    finally:
        con.close()
    out = rb2.read_rosbag2(path)
    np.testing.assert_allclose(out.odom[:, :2], small_bag.odom[:, :2],
                               atol=1e-6)
    np.testing.assert_allclose(out.odom[:, 2], small_bag.odom[:, 2],
                               atol=1e-6)


def test_mismatched_beam_count_skipped(tmp_path, small_bag):
    path = str(tmp_path / "run.db3")
    rb2.write_rosbag2(path, small_bag)
    con = sqlite3.connect(path)
    try:
        mid, = con.execute(
            "SELECT id FROM messages WHERE topic_id = 1 "
            "ORDER BY timestamp DESC LIMIT 1"
        ).fetchone()
        m = len(small_bag.angles)
        inc = float(small_bag.angles[1] - small_bag.angles[0])
        blob = rb2.ser_laserscan2(
            float(small_bag.times[-1]), float(small_bag.angles[0]), inc,
            small_bag.ranges[-1][: m // 2], small_bag.max_range,
        )
        con.execute("UPDATE messages SET data = ? WHERE id = ?", (blob, mid))
        con.commit()
    finally:
        con.close()
    with pytest.warns(UserWarning, match="beam count"):
        out = rb2.read_rosbag2(path)
    assert out.ranges.shape[0] == len(small_bag.times) - 1


def test_missing_db3_raises(tmp_path):
    empty = tmp_path / "empty_dir"
    empty.mkdir()
    with pytest.raises(ValueError, match="no .db3"):
        rb2.read_rosbag2(str(empty))


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_filter_runs_from_bag_file(tmp_path, house_map, torch_map, fmt):
    """Twins of test_filter_runs_from_rosbag and
    test_filter_runs_from_rosbag2: a simulated run written to a bag file,
    read back by the port and fed to the port's filter (MCL, 300
    particles), ends within 0.3 m."""
    from tests.test_filter import _simulate, _square_trajectory, _wrap

    mod, _, write, read, name = FORMATS[fmt]
    poses = _square_trajectory(12)
    scans, angles, _ = _simulate(house_map, poses, max_range=5.0)
    odom = np.asarray([_wrap(p) for p in poses], dtype=np.float32)
    bag = Bag(ranges=np.asarray(scans), angles=np.asarray(angles),
              odom=odom, gt=odom.copy(),
              times=np.arange(len(poses)) * 0.25, max_range=5.0, meta={})
    path = str(tmp_path / name)
    getattr(mod, write)(path, bag)
    loaded = getattr(mod, read)(path)
    cfg = FilterConfig(
        mode="MCL", num_particles=300, initialized=True,
        initial_pose=tuple(float(v) for v in loaded.odom[0]),
        max_range=loaded.max_range,
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
    )
    model = make_model(cfg, torch_map)
    state = model.init(0)
    state, infos = model.run(state, loaded.ranges, loaded.angles,
                             odometry_deltas(loaded.odom))
    est = infos.estimate.mean.numpy()
    true = _wrap(poses[-1])
    assert np.hypot(est[-1, 0] - true[0], est[-1, 1] - true[1]) < 0.3
