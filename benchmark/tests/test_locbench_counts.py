"""The yardstick's counts at hand-worked shapes."""

import pytest

from benchmark.counts import field_build, peaks


def test_field_build_counts_by_hand():
    # K=2 bins, a 3 x 4 field, 5 valid beams: 2 * 12 * 5 adds
    assert field_build.ops(2, 3, 4, 5) == 120.0
    # a 5 x 7 table, (2, 6) offsets twice, a (2, 3, 4) field, 4 bytes each
    assert field_build.nbytes(2, 3, 4, 6, 5, 7) == 4.0 * (35 + 24 + 24)


def test_bound_takes_the_larger_time():
    t, by = peaks.bound_ms(67e9, 0.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = peaks.bound_ms(0.0, 3.35e9)
    assert by == "bytes" and t == pytest.approx(1.0)


def test_field_build_at_the_big_shape():
    # 120 bins over the 384^2 house padded by 102 cells, 114 valid of 360
    ops = field_build.ops(120, 384, 384, 114)
    nb = field_build.nbytes(120, 384, 384, 360, 588, 588)
    t, by = peaks.bound_ms(ops, nb)
    assert by == "operations" and t == pytest.approx(0.030106, rel=1e-4)
