"""The card's scripts (chip_smoke.py, chip_kernel_ab.py,
chip_trace_check.py) on the CPU: they import without jax, and their
host-side helpers (the smoke run's operation counts, the A/B script's
kernel 7 ablation, the trace check's odometry reading) do what their
docstrings say.  The scripts themselves need a card."""

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


def test_trace_check_reads_the_odometry_counters():
    """``chip_trace_check.odom_reading``: as expected where replays are
    99% or more of the window's messages, copy-ins equal the hand-offs
    (one more where the window opens on one), no message ran eagerly and
    nothing was captured; the ``online.odom.predict`` span a scan."""
    import chip_trace_check as tc

    caps = np.array([1024, 1024, 2000, 2000, 1024, 1024])

    def reading(spans=None, **counters):
        spans = {"online.odom.predict": {"total_ns": 6e6, "count": 36},
                 **(spans or {})}
        return tc.odom_reading({"scans": 6, "msgs": 6, "caps": caps,
                                "tracing": {"counters": counters,
                                            "spans": spans}})

    r = reading(odom_replay=36, odom_copy_in=2)
    assert r["as_expected"] and r["handoffs"] == 2 and r["messages"] == 36
    assert r["predict_span_ms_per_scan"] == 1.0
    assert r["per_scan"]["odom_copy_in"] == 2 / 6
    assert reading(odom_replay=36, odom_copy_in=3)["as_expected"]
    assert not reading(odom_replay=36, odom_copy_in=1)["as_expected"]
    assert not reading(odom_replay=35, odom_eager=1,
                       odom_copy_in=2)["as_expected"]
    assert not reading({"graph.capture": {"total_ns": 1, "count": 1}},
                       odom_replay=36, odom_copy_in=2)["as_expected"]


def test_trace_check_sums_each_graph_launch_on_the_card():
    """``chip_trace_check.replay_device_ms``: for the graph launches of a
    trace, the extent from each one's first device operation to its last,
    their own time and count, and the time between the first and last
    stage stamp; device work that no graph launch queued is left out."""
    import chip_trace_check as tc

    def op(name, cat, ts, dur, corr):
        return {"name": name, "cat": cat, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    events = [
        {"name": "cudaGraphLaunch", "args": {"correlation": 1}},
        {"name": "cudaGraphLaunch", "args": {"correlation": 2}},
        {"name": "cudaLaunchKernel", "args": {"correlation": 7}},
        op("randn", "kernel", 10.0, 2.0, 1),
        op("trace_stamp_kernel", "kernel", 13.0, 1.0, 1),
        op("trace_stamp_kernel", "kernel", 20.0, 1.0, 1),
        op("copy", "gpu_memcpy", 30.0, 4.0, 2),
        op("eager", "kernel", 0.0, 50.0, 7),
    ]
    r = tc.replay_device_ms(events)
    assert r["launches"] == 2 and r["ops"] == 4
    assert r["extent_ms"] == pytest.approx((11.0 + 4.0) * 1e-3)
    assert r["busy_ms"] == pytest.approx(8.0 * 1e-3)
    assert r["stamped_ms"] == pytest.approx(7.0 * 1e-3)
