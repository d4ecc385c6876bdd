"""The traffic generator: a seed gives the same stream twice and another
seed another one; the lap closes; a kidnap switches placement on its
schedule while the odometry stays continuous."""

import numpy as np
import pytest

from benchmark import world
from benchmark.tests.conftest import SMALL_MAP
from benchmark.traffic import generate

OCC = world.occupancy(SMALL_MAP)
DIST = world.distance(OCC, SMALL_MAP["resolution"])


def _make(name, seed, scans=60, **kw):
    p = {**world.load("traffic", name), "settle_scans": 8, **kw}
    if name == "kidnap":
        p.update(kidnap_every=6, kidnap_min_dist_m=2.0)
    return generate.make(p, OCC, DIST, SMALL_MAP["resolution"],
                         tuple(SMALL_MAP["origin"]), scans, seed, "cpu")


@pytest.mark.parametrize("name", ["square_track", "kidnap"])
def test_same_seed_same_stream_other_seed_other(name):
    a, b, c = _make(name, 2**31 + 7), _make(name, 2**31 + 7), _make(name, 3)
    for f in ("ranges", "odom", "gt", "placement"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.ranges, c.ranges)
    assert not np.array_equal(a.odom, c.odom)
    # the seed changes the noise, not the tour or its placements
    assert np.array_equal(a.gt, c.gt) and np.array_equal(a.placement, c.placement)


def test_lap_closes_at_the_published_sizes():
    p = world.load("traffic", "square_track")
    lap = generate.square_lap(p)
    assert len(lap) == 4 * (50 + 9)
    step = np.hypot(*np.diff(lap[:, :2], axis=0).T)
    assert np.allclose(step[step > 1e-9], 0.15 / 5.0)
    # the lap ends on a turn in place whose last tick brings it back
    assert np.allclose(lap[-1, :2], lap[0, :2], atol=1e-9)
    assert abs(generate.wrap(lap[-1, 2] + (np.pi / 2) / 9 - lap[0, 2])) < 1e-9


def test_kidnap_schedule_and_continuous_odometry():
    k = _make("kidnap", 11)
    assert not k.placement[:8 + 6].any()
    assert (k.placement[14:20] == 1).all() and not k.placement[20:26].any()
    jumps = np.hypot(*np.diff(k.gt[:, :2], axis=0).T)
    assert jumps[13] >= 2.0           # the teleport into scan 14
    steps = np.hypot(*np.diff(k.odom[:, :2], axis=0).T)
    assert steps.max() < 0.1          # the odometry never jumps


def test_scans_see_the_walls():
    s = _make("square_track", 5, scans=10)
    assert s.ranges.shape == (10, 360) and s.ranges.dtype == np.float32
    hit = s.ranges < s.max_range
    assert hit.mean() > 0.5 and (s.ranges[hit] > 0).all()
