"""The readings that the limits of ``reference/limits/<config>.json`` are
set from: for each seed, one run of the cell (a short window at the cell's
own load), its sampled scans' numbers against the reference (the
program's reading) and those of the reference in bfloat16 put in the
program's place (the control's).  Each seed runs in a process of its own,
as a benchmark run does: the port's captures take streams from PyTorch's
per-device pool, and after some eight localizers in one process a
capture fails (PERF.md, Open questions).

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--out <file.jsonl>]

It needs a CUDA card.  Not run by the benchmark's own runs."""

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
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    sys.path[0] = ROOT
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 2
    if len(a.seeds) > 1:
        import subprocess

        rest = ["--workload", a.workload, "--seconds", str(a.seconds)]
        rest += ["--out", a.out] if a.out else []
        return max(subprocess.run([sys.executable, __file__, *rest, "--seeds",
                                   str(s)]).returncode for s in a.seeds)
    sink = open(a.out, "a") if a.out else None
    try:
        for seed in a.seeds:
            t0 = time.perf_counter()
            out = harness.run_cell(a.workload, seed, a.seconds, False,
                                   "cuda:0", t0, control=True)
            line = json.dumps({"workload": a.workload, "seed": seed,
                               "correct": out["correct"],
                               "metrics": out["metrics"],
                               "readings": out["readings"]})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
