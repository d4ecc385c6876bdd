"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files."""

import json
import re

import pytest

from benchmark import world
from benchmark.reference import check

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = world.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    assert all(m["bound"] <= 0.25 and m["bound"] >= 0.01
               for m in SPEC["end_to_end"])


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in entry.get("reduced", []):
        assert NAME.match(key)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1
    conf = world.load("configs", entry["config"])
    assert conf["name"] == entry["config"]
    world.load("traffic", entry["traffic"])
    world.load("workloads", cell)
    world.load("maps", conf["map"])
    limits = world.load("reference/limits", cell)["numbers"]
    # every number of the comparison is named; the compared ones have a
    # limit at or above 0, and the exact ones a limit of 0
    assert set(limits) == set(check.NUMBERS)
    for name, spec in limits.items():
        if spec.get("compared", True):
            assert spec["limit"] >= 0
    for name in ("draws_mismatch",):
        assert limits[name]["limit"] == 0
    # every cell reports setup_s, another end-to-end metric and a per-layer
    # metric
    mine = [m for m in METRICS if cell in m.get("workloads", CELLS)]
    assert {"setup_s"} < {m["name"] for m in mine if "bound" in m}
    assert any("layer" in m for m in mine)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_readers_resolve(metric):
    assert callable(world.metric_reader(metric["name"]).read)
    if "moves" in metric:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}


def test_config_files_are_the_listed_ones():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        conf = world.load("configs", c["name"])
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
