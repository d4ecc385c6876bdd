"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or the JAX package (compared whole: the port's name begins with it), and
the reference imports nothing of the port.  And a run without a card
exits with an error and prints no result."""

import json
import os
import subprocess
import sys

from benchmark.tests.conftest import ROOT

CHECK = """
import sys
sys.path[0] = {root!r}
import runpy, importlib
{body}
bad = {{m.split('.')[0] for m in sys.modules}} & {names!r}
print(sorted(bad))
"""


def _loaded(body, names):
    code = CHECK.format(root=ROOT, body=body, names=set(names))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1].replace("'", '"'))


def test_run_traffic_and_reference_load_no_jax():
    body = ("importlib.import_module('benchmark.harness');"
            "runpy.run_path('benchmark/run.py', run_name='not_main');"
            "import benchmark.traffic.generate, benchmark.reference.check")
    assert _loaded(body, ["jax", "jaxlib", "flax", "mcmh_localization_tpu"]) == []


def test_reference_imports_nothing_of_the_port():
    body = "import benchmark.reference.check, benchmark.reference.filter"
    assert _loaded(body, ["mcmh_localization_tpu_torch",
                          "mcmh_localization_tpu"]) == []


def test_without_a_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "house_amcl_default.square_track", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
