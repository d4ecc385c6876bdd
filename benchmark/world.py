"""The benchmark's own files, found by name: configurations, cells, traffic
mixes and maps are JSON files under this folder, and a per-layer metric is
a module under ``metrics/``.  Also the map as the benchmark makes it: the
occupancy grid from a map file and its distance transform, computed here
(scipy) and not by the program under test."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

import numpy as np

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
OCCUPIED, FREE = 100, 0


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load(kind: str, name: str) -> dict:
    """The JSON file ``<kind>/<name>.json`` (kind: configs, workloads,
    traffic, maps, reference/limits)."""
    path = ROOT / kind / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file named {name!r} ({path})")
    return json.loads(path.read_text())


def metric_reader(name: str) -> ModuleType:
    """The module ``metrics/<name>.py`` that reads the per-layer metric
    ``name``: it defines ``read(run)``, which returns a number or None."""
    path = ROOT / "metrics" / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"locbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def occupancy(map_spec: dict) -> np.ndarray:
    """(H, W) int8 occupancy (0 free, 100 occupied, -1 unknown; row 0 the
    bottom row) painted from the map file's rectangles in order:
    ``[kind, row0, row1, col0, col1]``, half-open."""
    n = int(map_spec["cells"])
    occ = np.full((n, n), int(map_spec["unknown"]), dtype=np.int8)
    for kind, r0, r1, c0, c1 in map_spec["rectangles"]:
        occ[r0:r1, c0:c1] = {"free": FREE, "occupied": OCCUPIED}[kind]
    return occ


def distance(occ: np.ndarray, resolution: float) -> np.ndarray:
    """(H, W) float32 meters from each cell to the nearest non-free cell."""
    from scipy.ndimage import distance_transform_edt

    return (distance_transform_edt(occ == FREE) * resolution).astype(np.float32)
