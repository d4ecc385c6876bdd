"""The card's scripts (chip_smoke.py, chip_kernel_ab.py,
chip_trace_check.py) on the CPU: they import without jax, and their host-side helpers (the A/B script's sector
counts and index helpers) do what their docstrings say.  The scripts
themselves need a card."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_kernel_ab.py",
                                    "chip_trace_check.py"])
def test_script_imports_and_parses_without_jax(script):
    """Each script imports (its helpers from chip_smoke included) and
    answers --help in an interpreter with no jax module loaded."""
    module = script[:-3]
    code = (
        f"import sys; sys.argv = ['{script}', '--help']\n"
        f"import {module}\n"
        "assert not [n for n in sys.modules if n.split('.')[0] == 'jax']\n"
        f"try:\n    {module}.main()\nexcept SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "usage" in res.stdout


def test_fleet_and_entry_modules_import_without_jax():
    """The batched fleet and the entry-point twin import, and the entry
    builds on the CPU, in an interpreter where jax and the JAX package
    cannot be imported."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'mcmh_localization_tpu'):\n"
        "            raise ImportError(f'{name} blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import mcmh_localization_tpu_torch.parallel.batched\n"
        "from mcmh_localization_tpu_torch import graft_entry, parallel\n"
        "fn, args = graft_entry.entry(device='cpu')\n"
        "assert args[0].particles.shape == (4096, 3)\n"
        "assert parallel.__all__ == ['make_mesh', 'make_sharded_model', "
        "'shard_state']\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_dist_helpers_import_without_jax():
    """[dist]'s modules and chip_smoke's [dist] helpers import where jax and
    the JAX package cannot be imported, and ``collectives_line`` prints
    calls and bytes a scan of each collective."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'mcmh_localization_tpu'):\n"
        "            raise ImportError(f'{name} blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from mcmh_localization_tpu_torch.parallel import distributed, sharding\n"
        "from mcmh_localization_tpu_torch.filter.staged import (\n"
        "    make_staged_dist_model)\n"
        "from mcmh_localization_tpu_torch.graft_entry import dryrun_multichip\n"
        "import chip_smoke\n"
        "for name in ('drive_dist', 'start_world_of_one', 'end_world',\n"
        "             'bin_slice_rows'):\n"
        "    assert callable(getattr(chip_smoke, name)), name\n"
        "line = chip_smoke.collectives_line(\n"
        "    {'psum': (26, 232, 12), 'all_gather': (2, 64, 32)}, 2)\n"
        "assert line == 'all_gather 1.00 calls 32 B, psum 13.00 calls 116 B', line\n"
        "chip_smoke.end_world()\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _room():
    from mcmh_localization_tpu_torch.maps import voxel_map as tvm

    occ = np.zeros((10, 40, 48), dtype=np.int8)
    occ[0] = 100
    occ[:, 0, :] = occ[:, -1, :] = occ[:, :, 0] = occ[:, :, -1] = 100
    return tvm.build_voxel_map(occ, 0.1, (-2.4, -2.0, 0.0), device="cpu")


def test_voxel_sectors_counts_distinct_sectors_a_warp_load():
    """``voxel_sectors`` on two clouds: 64 copies of one pose read one
    sector and one line a warp load in every layout at G = 1, and G
    sectors at most at G lanes; a spread cloud reads more, and never more
    than 32."""
    import chip_kernel_ab as ab
    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.models.sensor3d import (
        scan_beams,
        voxel_geometry,
    )

    vm = _room()
    cfg = FilterConfig(max_range=3.0)
    az = np.linspace(-np.pi, np.pi, 48, endpoint=False)
    dirs = torch.tensor(np.stack([az, np.full(48, -0.1)], 1),
                        dtype=torch.float32)
    ranges = torch.full((48,), 1.5)
    u, v, zrow, live, _ = scan_beams(ranges, dirs, vm, cfg, 0.5)
    geo = voxel_geometry(vm)
    same = torch.tensor([[0.1, 0.2, 0.3]]).expand(64, 3).contiguous()
    for g in (1, 2, 4):
        got = ab.voxel_sectors(same, u, v, zrow, live, geo, g, n_poses=64)
        for sectors, lines in got.values():
            assert 1.0 <= sectors <= g and 1.0 <= lines <= g
    one = ab.voxel_sectors(same, u, v, zrow, live, geo, 1, n_poses=64)
    assert all(x == (1.0, 1.0) for x in one.values())
    rng = np.random.default_rng(0)
    spread = torch.tensor(np.stack([rng.uniform(-1.5, 1.5, 64),
                                    rng.uniform(-1.5, 1.5, 64),
                                    rng.uniform(-np.pi, np.pi, 64)], 1),
                          dtype=torch.float32)
    got = ab.voxel_sectors(spread, u, v, zrow, live, geo, 1, n_poses=64)
    for sectors, lines in got.values():
        assert 4.0 < sectors <= 32.0 and lines <= 32.0


def test_table_scorer_indices_are_the_scorer_reads():
    """``table_scorer_indices``: one (cell, bin) pair a pose and beam, the
    cell in the map and the bin in [0, K)."""
    import chip_kernel_ab as ab
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map

    gm = build_grid_map(np.zeros((32, 40), np.int8), 0.05, (-1.0, -0.8),
                        device="cpu")
    angles = torch.linspace(-3.0, 3.0, 7)
    y, x = ab.table_scorer_indices(gm, 10, angles, 12,
                                   torch.Generator().manual_seed(0),
                                   torch.diag(torch.tensor([0.05, 0.05, 0.1])))
    assert y.shape == x.shape == (70,)
    assert y.dtype == x.dtype == torch.int32
    assert int(y.min()) >= 0 and int(y.max()) < 32 * 40
    assert int(x.min()) >= 0 and int(x.max()) < 12


def test_table_ops_counts_the_form_s_work():
    """``chip_smoke.table_ops``: 14 operations a pair in the per-pair form;
    in the level form 6 a pair and 10 an entry of the scan's LUT (valid
    beams x levels), the mixture computed once an entry, so that the bound
    counts what each form does on its inputs.  ``table_kernels`` gives the
    launches a ``table_scores`` call counts: 2 in the level form, else 1."""
    import chip_smoke
    from mcmh_localization_tpu_torch.ops.scan_scores import (
        table_kernels,
        table_levels,
    )

    table = torch.arange(6, dtype=torch.float32).repeat(20, 4)  # 6 levels
    levels = table_levels(table)
    per_pair = table_levels(torch.arange(1200.0).reshape(50, 24) * 0.01)
    assert levels.levels.numel() == 6 and per_pair.index is None
    assert chip_smoke.table_ops(levels, 1000, 50) == 6 * 1000 + 10 * 50 * 6
    assert chip_smoke.table_ops(per_pair, 1000, 50) == 14 * 1000
    assert table_kernels(levels) == 2 and table_kernels(per_pair) == 1


def test_lut_launch_ablation_edits_this_tree_s_kernel():
    """``chip_kernel_ab.LUT_LAUNCH_ABLATION``, the throwaway one-launch-a-
    chunk build of kernel 7, edits this tree's ``beam_field.cu``: each
    pattern occurs there once, the edited chunked kernel takes a bin range,
    and the production C entry point keeps only the chunk size."""
    import chip_kernel_ab as ab

    src = (ROOT / "mcmh_localization_tpu_torch" / "csrc"
           / "beam_field.cu").read_text()
    for pattern, repl in ab.LUT_LAUNCH_ABLATION:
        assert src.count(pattern) == 1, pattern
        src = src.replace(pattern, repl)
    assert "for (int g0 = g_lo; g0 < g_hi; g0 += kg)" in src
    entry = src[src.index('extern "C" int mcmh_lut_field('):]
    assert "g_lo" not in entry and "accumulate" not in entry
