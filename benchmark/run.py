"""Run one cell of the localizer's benchmark once and print its result as
the last line of standard output (one JSON object).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the package ``mcmh_localization_tpu_torch``.  It needs one CUDA card and
exits with an error, printing no result, without one.  ``--trace 1``
reports the per-layer metrics from a profiled stretch after the window;
``--trace 0`` the end-to-end metrics.  Every compared number is printed
with its limit, last on standard error and in the result's ``checks``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    sys.path[0] = ROOT  # the package root, not this folder
    import torch

    from benchmark import harness

    chips = next(w["chips"] for w in harness.world.benchmark_spec()["workloads"]
                 if w["name"] == a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           "cuda:0", T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
