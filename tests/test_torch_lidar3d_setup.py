"""The 3-D lidar's set-up under the port's tracing (``utils/profiling.py``):
building the voxel map records ``setup.voxel_map`` and building a model's
sensor table ``setup.voxel_tables``, once each; form (b)'s volume left in
its float32 form counts ``voxel_f32_volume``, and only past
``MAX_VOXEL_LEVELS`` levels; with tracing off nothing is recorded and the
tables are the same.  And the benchmark's count of the 3-D scorer's work
(``benchmark/counts/voxel_scores.py``) at ``chip_smoke.py``'s form (b)
shape."""

import numpy as np
import pytest
import torch

from benchmark.counts import peaks, voxel_scores
from mcmh_localization_tpu_torch.config import FilterConfig
from mcmh_localization_tpu_torch.filter.step import make_model
from mcmh_localization_tpu_torch.maps.voxel_map import (
    build_voxel_map,
    nav_slice,
)
from mcmh_localization_tpu_torch.ops.scan_scores import (
    MAX_VOXEL_LEVELS,
    voxel_levels,
)
from mcmh_localization_tpu_torch.utils import profiling
from tests.test_torch_ops import torch_one_thread  # noqa: F401

ORIGIN = (-1.0, -1.0, 0.0)


def _room() -> np.ndarray:
    """(8, 40, 40) voxels at 0.05 m: a floor, walls and a block."""
    occ = np.zeros((8, 40, 40), np.int8)
    occ[0] = 100
    occ[:, 0, :] = occ[:, -1, :] = occ[:, :, 0] = occ[:, :, -1] = 100
    occ[:4, 10:14, 20:26] = 100
    return occ


def _config() -> FilterConfig:
    return FilterConfig(mode="AMHAMCL", num_particles=64, min_particles=64,
                        max_particles=64, max_range=3.0,
                        sensor_model="lidar3d", lidar3d_sensor_z=0.2,
                        motion_validity="score")


@pytest.fixture
def tracing():
    profiling.reset()
    profiling.enable()
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.reset()


def test_tracing_records_the_voxel_map_and_tables_once(tracing):
    vm = build_voxel_map(_room(), 0.05, ORIGIN, device="cpu")
    nav = nav_slice(vm, z=0.1)
    spans = profiling.collect()["spans"]
    assert spans["setup.voxel_map"]["count"] == 1
    assert "setup.voxel_tables" not in spans
    profiling.reset()
    model = make_model(_config(), nav, voxel_map=vm)
    got = profiling.collect()
    assert got["spans"]["setup.voxel_tables"]["count"] == 1
    assert "setup.voxel_map" not in got["spans"]
    # the room's log volume takes the level form: nothing counted
    assert model.log_field.levels.index is not None
    assert "voxel_f32_volume" not in got["counters"]


def test_voxel_f32_volume_counts_only_past_the_levels(tracing):
    gen = torch.Generator().manual_seed(3)
    few = torch.randint(0, MAX_VOXEL_LEVELS, (4, 32, 48), generator=gen)
    at_most = voxel_levels(few.to(torch.float32) * 0.25 - 7.0)
    assert at_most.index is not None
    assert "voxel_f32_volume" not in profiling.collect()["counters"]
    many = torch.rand((8, 32, 48), generator=gen)
    assert torch.unique(many).numel() > MAX_VOXEL_LEVELS
    past = voxel_levels(many)
    assert past.index is None and torch.equal(past.volume, many)
    assert profiling.collect()["counters"]["voxel_f32_volume"] == 1


def test_tracing_off_records_nothing_and_builds_the_same():
    profiling.reset()
    assert not profiling.enabled()
    vm = build_voxel_map(_room(), 0.05, ORIGIN, device="cpu")
    off = make_model(_config(), nav_slice(vm, z=0.1), voxel_map=vm).log_field
    voxel_levels(torch.rand((8, 32, 48)))
    got = profiling.collect()
    assert got["spans"] == {} and got["counters"] == {}
    profiling.enable()
    try:
        vm_on = build_voxel_map(_room(), 0.05, ORIGIN, device="cpu")
        on = make_model(_config(), nav_slice(vm_on, z=0.1),
                        voxel_map=vm_on).log_field
    finally:
        profiling.enable(False)
        profiling.reset()
    assert torch.equal(vm.distance, vm_on.distance)
    assert torch.equal(off.log_volume, on.log_volume)
    assert torch.equal(off.levels.index, on.levels.index)
    assert torch.equal(off.levels.levels, on.levels.levels)


def test_voxel_scores_count_at_the_form_b_row():
    # chip_smoke.py's [kernel] form (b) row: 2 x 100k poses, 5006 live of
    # 5760 beams on the (60, 400, 400) building: 0.1943 ms, by the
    # operations (13 a pose and live beam)
    ops = voxel_scores.ops(200_000, 5006, 5760)
    nb = voxel_scores.nbytes(200_000, 5006, 5760, 60 * 400 * 400)
    t, by = peaks.bound_ms(ops, nb)
    assert by == "operations" and round(t, 4) == 0.1943
    assert ops - 13.0 * 200_000 * 5006 < 1e-4 * ops
    # by hand: 2 poses, 3 live of 4 beams, a 5-voxel volume read whole;
    # 1 pose and 2 live beams read 2 of its values
    assert voxel_scores.ops(2, 3, 4) == 13 * 6 + 3 * 2 + 20 * 4
    assert voxel_scores.nbytes(2, 3, 4, 5) == 12 * 2 + 12 * 4 + 4 * 2 + 4 * 5
    assert voxel_scores.nbytes(1, 2, 4, 5) == 12 + 12 * 4 + 4 + 4 * 2
