"""The benchmark's seam for a configuration's sensor model and map
(``sensors/<name>.py``, found by name by ``world.sensor``): the likelihood
field behind it reads bit for bit what the harness read before the seam; a
module under another name is taken as it is, from new files only; a wrong
reference scorer makes ``correct`` false; a module's voxel map and (M, 2)
angles reach the localizer and the reference; an unknown name fails before
any traffic is made."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, world
from benchmark.reference import check
from benchmark.tests.conftest import ROOT, small
from benchmark.traffic import generate
from mcmh_localization_tpu_torch.filter import online

SEED = 0

# Each cell at ``conftest.small`` sizes, seeds 0 and 1, one torch thread:
# the sha256 of the traffic's (T, M) float32 ranges, then ``check.worst``
# of the program's sampled scans and of the bfloat16 control's, in the
# order of ``check.NUMBERS``.  Recorded by these runs (``run_cell(cell,
# seed, 1.5, False, "cpu", ..., overrides=small(cell), control=True)``) on
# the benchmark as it was before the seam, when the harness built the
# likelihood field itself, its ``check.gaps`` holding the covariance as
# ``check.COV_MIN_DENOM`` says: as it was, the kidnap cell's cov_gap read
# 8.6 (seed 0) and 1.1e-3 (seed 1; the control 0.85) on scans that one
# particle all but holds.
PARENT = {
    ("house_staged_1m.square_track", 0): (
        "271a2c1836d8941b381190fe17d1b8066090b97c13fbccb97d2440c6265f434d",
        [1.1756346670178418e-08, 7.317127836969917e-08,
         9.763438286017052e-08, 2.732386504794049e-07, 8.337882932989492e-08,
         0.0, 0.0, 6.117812771302252e-09, 6.184981530986774e-08,
         4.824411930189436e-08, 0.0, 0.0],
        [0.00033767791272928884, 0.000343200027513646, 0.0288357864725553,
         0.007476044820262797, 0.0026315807795716352, 0.0, 0.0029296875,
         0.00033767791272928884, 0.0288357864725553, 0.0024843114499671338,
         0.0, 0.0],
    ),
    ("house_staged_1m.square_track", 1): (
        "e4d5fa1793756be3152dae11aab410d704f82616ee172e1c9b1376bd47b33e7e",
        [4.019113858267506e-08, 8.76268826388582e-08, 1.750459970919583e-07,
         1.3704579882878895e-07, 7.695348776009549e-08, 0.0, 0.0,
         4.727355528747923e-12, 1.1900033507844057e-09,
         2.133132082543709e-10, 0.0, 0.0],
        [0.000558693127560834, 0.0005496035715477632, 0.06097273152404048,
         0.005573426438150862, 0.0029370509948878783, 0.0, 0.0029296875,
         0.000558693127560834, 0.06097273152404048, 0.0010687454738417125,
         0.0, 0.0],
    ),
    ("house_amcl_default.square_track", 0): (
        "271a2c1836d8941b381190fe17d1b8066090b97c13fbccb97d2440c6265f434d",
        [1.558521384994696e-08, 6.973701616175276e-08, 9.831025853152889e-08,
         1.030753610937029e-07, 7.100392283403663e-08, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0],
        [0.00014445397546016157, 0.0005830209880395287, 0.011226306105991811,
         0.005915159355571632, 0.0007989861978560175, 0.0,
         0.00666666666666671, 0.00321619792231672, 0.049968195467543934, 0.0,
         0.0, 0.0],
    ),
    ("house_amcl_default.square_track", 1): (
        "e4d5fa1793756be3152dae11aab410d704f82616ee172e1c9b1376bd47b33e7e",
        [2.3927282626621743e-08, 8.395453399145936e-08,
         6.284075066958005e-08, 1.196538660422703e-07, 3.425623766095184e-08,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.0006179959702364554, 0.001161422625339803, 0.014616473122682805,
         0.007270421589814583, 0.001163201484463226, 0.0,
         0.0033333333333332993, 0.002310250838074951, 0.054276876776270085,
         0.0, 0.0, 0.0],
    ),
    ("house_staged_1m.kidnap", 0): (
        "25b078b997ef670f16fd61cd4a3c8cedb2e9bf32c5549207a3d1ece86386a6f4",
        [9.968782613082694e-06, 2.4185210767413423e-07,
         8.431175206182093e-06, 7.532391791793573e-06,
         4.1038233467204907e-07, 0.0, 0.0, 8.148191266111937e-09,
         3.816546641248213e-07, 6.30887357077208e-08, 0.0, 0.0],
        [2.6337611767117757, 0.23762554924309942, 97.40157892361115,
         0.9978557961448631, 0.009695176910248302, 0.10017574692442882,
         0.0048828125, 2.6653338816916223, 0.9989933547139233,
         0.10017574692442882, 1.0, 0.0],
    ),
    ("house_staged_1m.kidnap", 1): (
        "6ad0e50187888aae10b086ba8ce90af2dbc7fbf8fdfe670f6f2d9dcc5c5da927",
        [7.260983809854067e-07, 6.758691029062902e-08, 4.196182857333479e-07,
         4.784749648398464e-07, 3.6841217380699327e-07, 0.0, 0.0,
         4.944530064741295e-09, 5.023084176933099e-07,
         1.8602896541867378e-07, 0.0, 0.0],
        [0.4000213573392325, 0.009413716538157146, 0.43988372041991164,
         0.8581067859578771, 0.036965891389255115, 0.0004551661356395084,
         0.0029296875, 0.32953646822543126, 113.62289687453969,
         0.005959083840248882, 0.0, 0.0],
    ),
}


@pytest.fixture(autouse=True)
def one_thread():
    """Bit for bit needs one summation order: one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(cell, seed=SEED, overrides=None, **kw):
    torch.manual_seed(0)
    return harness.run_cell(cell, seed, 1.5, False, "cpu", time.perf_counter(),
                            overrides=overrides or small(cell),
                            log=lambda *a: None, **kw)


def _numbers(readings):
    return [readings[k] for k in check.NUMBERS]


@pytest.mark.parametrize("cell,seed", sorted(PARENT))
def test_the_likelihood_field_reads_as_before_the_seam(monkeypatch, cell,
                                                       seed):
    made = []
    real = generate.make

    def make(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(generate, "make", make)
    out = _run(cell, seed, control=True)
    sha, program, control = PARENT[(cell, seed)]
    assert hashlib.sha256(made[0].ranges.tobytes()).hexdigest() == sha
    assert _numbers(out["readings"]["program"]) == program
    assert _numbers(out["readings"]["control"]) == control


# -- a configuration added as new files only

ALIAS = '''"""The likelihood field under another name."""
from benchmark import world

_lf = world.sensor("likelihood_field")
build_world, program_maps = _lf.build_world, _lf.program_maps
scanner, reference_angles = _lf.scanner, _lf.reference_angles
program, reference_map = _lf.program, _lf.reference_map
'''

# its reference scored on a likelihood field with sigma_hit 10% wider than
# the program's
WIDER = ALIAS + '''

def reference_map(w, f, device, *dtype):
    f = {**f, "sigma_hit": 1.1 * f["sigma_hit"]}
    return _lf.reference_map(w, f, device, *dtype)
'''

# a 3-D sensor's keywords: a voxel map beside the grid, and (azimuth,
# elevation) angles for the driver and the reference; the likelihood field
# under them, at elevation 0
SPY = ALIAS + '''
import numpy as np
import torch

VOXEL_MAP = "the spy's voxel map"
seen = []


def program_maps(w, conf, device):
    return {**_lf.program_maps(w, conf, device), "voxel_map": VOXEL_MAP}


def _pairs(a):
    return torch.stack([a, torch.zeros_like(a)], dim=1)


def scanner(w, p, device):
    s = _lf.scanner(w, p, device)
    return s._replace(
        angles=_pairs(_lf.reference_angles(w, p, "cpu")).numpy())


def reference_angles(w, p, device):
    return _pairs(_lf.reference_angles(w, p, device))


def program(prog):
    inner = _lf.program(prog).scorer

    def scorer(ranges, angles, *rest):
        seen.append(tuple(angles.shape))
        return inner(ranges, angles[:, 0], *rest)

    return prog._replace(scorer=scorer)
'''


def _copy(tmp_path, monkeypatch) -> Path:
    """The benchmark's files copied under ``tmp_path``, and ``world.ROOT``
    pointed at the copy."""
    shutil.copytree(Path(ROOT) / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(Path(ROOT) / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(world, "ROOT", tmp_path / "benchmark")
    return tmp_path / "benchmark"


def _add(bench: Path, sensor: str, source: str | None,
         base: str = "house_amcl_default.square_track") -> str:
    """A new configuration, its copy of ``base``'s but for ``"sensor"``,
    and a cell of it with ``base``'s traffic, run settings and limits:
    new files, and one entry more in ``BENCHMARK.json``'s ``configs`` and
    ``workloads``.  Returns the cell's name."""
    spec_path = bench.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    entry = next(w for w in spec["workloads"] if w["name"] == base)
    config = f"{entry['config']}_{sensor}"
    cell = f"{config}.{entry['traffic']}"
    conf = {**world.load("configs", entry["config"]), "name": config,
            "sensor": sensor}
    (bench / "configs" / f"{config}.json").write_text(json.dumps(conf))
    if source is not None:
        (bench / "sensors" / f"{sensor}.py").write_text(source)
    for kind in ("workloads", "reference/limits"):
        shutil.copy(bench / kind / f"{base}.json",
                    bench / kind / f"{cell}.json")
    c = next(c for c in spec["configs"] if c["name"] == entry["config"])
    spec["configs"].append({**c, "name": config,
                            "file": f"benchmark/configs/{config}.json"})
    spec["workloads"].append({**entry, "name": cell, "config": config})
    spec_path.write_text(json.dumps(spec, indent=1))
    return cell


def _tree(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("base", ["house_staged_1m.square_track",
                                  "house_amcl_default.square_track"])
def test_a_configuration_added_as_files_only(tmp_path, monkeypatch, base):
    """The likelihood field under another name, in a configuration that
    comes as new files and two entries of ``BENCHMARK.json``: correct, and
    the numbers of the same cell under the field's own name."""
    bench = _copy(tmp_path, monkeypatch)
    before = _tree(tmp_path)
    cell = _add(bench, "lf_alias", ALIAS, base)
    after = _tree(tmp_path)
    assert {p for p in before if after[p] != before[p]} == {
        Path("BENCHMARK.json")}
    config = cell.split(".")[0]
    assert set(after) - set(before) == {
        Path(f"benchmark/configs/{config}.json"),
        Path("benchmark/sensors/lf_alias.py"),
        Path(f"benchmark/workloads/{cell}.json"),
        Path(f"benchmark/reference/limits/{cell}.json")}
    out = _run(cell, overrides=small(base), control=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 4
    _, program, control = PARENT[(base, SEED)]
    assert _numbers(out["readings"]["program"]) == program
    assert _numbers(out["readings"]["control"]) == control


def test_a_wider_reference_field_makes_correct_false(tmp_path, monkeypatch):
    cell = _add(_copy(tmp_path, monkeypatch), "lf_wider", WIDER)
    out = _run(cell, overrides=small("house_amcl_default.square_track"))
    assert not out["correct"], out["checks"]


def test_a_sensors_maps_and_angles_reach_the_localizer_and_the_reference(
        tmp_path, monkeypatch):
    cell = _add(_copy(tmp_path, monkeypatch), "lf_spy", SPY)
    modules, calls = {}, []
    real = world.sensor
    monkeypatch.setattr(world, "sensor",
                        lambda name: modules.setdefault(name, real(name)))

    class Spy(online.OnlineLocalizer):
        def __init__(self, config, grid_map, voxel_map=None, **kw):
            calls.append(("init", voxel_map))
            super().__init__(config, grid_map, **kw)

        def warmup(self, ranges, angles=None, **kw):
            calls.append(("warmup", np.shape(angles)))
            return super().warmup(ranges, **kw)

        def on_scan(self, ranges, angles=None, **kw):
            calls.append(("on_scan", np.shape(angles)))
            return super().on_scan(ranges, **kw)

    monkeypatch.setattr(online, "OnlineLocalizer", Spy)
    out = _run(cell, overrides=small("house_amcl_default.square_track"))
    assert out["correct"]
    spy = modules["lf_spy"]
    m = world.load("traffic", "square_track")["n_beams"]
    assert calls[0] == ("init", spy.VOXEL_MAP)
    assert calls[1] == ("warmup", (m, 2))
    scans = [shape for kind, shape in calls[2:]]
    assert len(scans) >= out["attempted"] and set(scans) == {(m, 2)}
    # the reference's scorer of each sampled scan took them
    assert spy.seen and set(spy.seen) == {(m, 2)}


def test_an_unknown_sensor_fails_before_any_traffic(tmp_path, monkeypatch):
    cell = _add(_copy(tmp_path, monkeypatch), "no_such_sensor", None)

    def no_traffic(*a, **k):
        raise AssertionError("traffic made for an unknown sensor")

    monkeypatch.setattr(generate, "make", no_traffic)
    with pytest.raises(FileNotFoundError, match="no_such_sensor.py"):
        _run(cell, overrides=small("house_amcl_default.square_track"))


def test_the_fields_reference_imports_nothing_of_the_port():
    """The module's reference part (its world, angles, map and scorers)
    runs without the program under test; only ``program_maps`` loads it."""
    from benchmark.tests.test_locbench_imports import _loaded

    body = """
import torch
from benchmark import world
from benchmark.reference import filter as ref
from benchmark.tests.conftest import SMALL_MAP, small
lf = world.sensor("likelihood_field")
for name in ("house_staged_1m", "house_amcl_default"):
    conf = world.load("configs", name)
    conf["filter"].update(small(name)["filter"])
    w = lf.build_world(conf, SMALL_MAP)
    p = world.load("traffic", "square_track")
    m = lf.reference_map(w, conf["filter"], "cpu")
    angles = lf.reference_angles(w, p, "cpu")
    poses = torch.zeros((4, 3))
    ranges = lf.scanner(w, p, "cpu").clean(poses)[0]
    for prog in ref.programs(conf, lf).values():
        prog.scorer(ranges, angles, m, prog, poses[0], torch.zeros(3),
                    torch.float32)(poses)
"""
    assert _loaded(body, ["mcmh_localization_tpu_torch",
                          "mcmh_localization_tpu", "jax"]) == []
