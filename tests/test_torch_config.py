"""The port's own config and PGM modules against the JAX package's, its
isolation from that package, and the device rule of its entry points."""

import dataclasses
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu import config as jconfig  # noqa: E402
from mcmh_localization_tpu.io import pgm as jpgm  # noqa: E402
from mcmh_localization_tpu_torch import config as tconfig  # noqa: E402
from mcmh_localization_tpu_torch import convert  # noqa: E402
from mcmh_localization_tpu_torch.io import pgm as tpgm  # noqa: E402
from mcmh_localization_tpu_torch.maps import grid_map  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# config: a copy kept field for field
# ---------------------------------------------------------------------------

def test_filter_config_fields_and_defaults_match_jax():
    jf = dataclasses.fields(jconfig.FilterConfig)
    tf = dataclasses.fields(tconfig.FilterConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert a.default == b.default, a.name
        assert str(a.type) == str(b.type), a.name
    assert tconfig.FilterConfig() == tconfig.FilterConfig(
        **dataclasses.asdict(jconfig.FilterConfig()))
    assert tconfig.MODES == jconfig.MODES


@pytest.mark.parametrize("mode", jconfig.MODES)
def test_parse_mode_matches_jax(mode):
    assert tconfig.parse_mode(mode) == jconfig.parse_mode(mode)
    assert tconfig.FilterConfig(mode=mode).use_mh == \
        jconfig.FilterConfig(mode=mode).use_mh


# every key FilterConfig.from_yaml maps, with non-default values, and a few
# of the field-name pass-through keys
_PARAMS_YAML = """\
# reference-format params
localization_mode: 'MHAMCL'
init_particles: 2500
min_particles: 200
max_particles: 6000
alpha1: 0.01
alpha2: 0.02
alpha3: 0.03
alpha4: 0.04
alpha_slow: 0.002
alpha_fast: 0.2
kld_epsilon: 0.04
kld_z: 2.5
kld_bin_size_xy: 0.3
kld_bin_size_theta: 0.2
kld_delta: 0.02
sigma_hit: 0.25
z_hit: 0.9
z_rand: 0.1
max_range: 6.5
step: 2
initialized: true
likelihood_impl: corr
corr_window_cells: 96
initial_pose: [0.5, -1.0, 0.25]
"""


def test_from_yaml_matches_jax(tmp_path):
    path = tmp_path / "params.yaml"
    path.write_text(_PARAMS_YAML)
    got = tconfig.FilterConfig.from_yaml(str(path), motion_validity="reject")
    want = jconfig.FilterConfig.from_yaml(str(path), motion_validity="reject")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mode == "MHAMCL" and got.step == 2 and got.max_range == 6.5
    assert got.initial_pose == (0.5, -1.0, 0.25)
    assert got.corr_window_cells == 96 and got.motion_validity == "reject"


# ---------------------------------------------------------------------------
# PGM: what one package writes, the other reads back
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pgm_written_by_one_package_reads_in_the_other(tmp_path, writer):
    rng = np.random.default_rng(3)
    img = rng.choice(np.array([0, 205, 254], np.uint8), size=(37, 53))
    w_mod, r_mod = (jpgm, tpgm) if writer == "jax" else (tpgm, jpgm)
    w_mod.write_pgm(str(tmp_path / "m.pgm"), img)
    np.testing.assert_array_equal(r_mod.read_pgm(str(tmp_path / "m.pgm")),
                                  img)
    (tmp_path / "m.yaml").write_text(
        "image: m.pgm\nresolution: 0.05\norigin: [-1.0, -2.0, 0.0]\n"
        "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n")
    occ_t, meta_t = tpgm.load_map_yaml(str(tmp_path / "m.yaml"))
    occ_j, meta_j = jpgm.load_map_yaml(str(tmp_path / "m.yaml"))
    np.testing.assert_array_equal(occ_t, occ_j)
    assert meta_t == meta_j


# ---------------------------------------------------------------------------
# isolation: nothing of the JAX package is imported, opened or executed
# ---------------------------------------------------------------------------

def _port_sources():
    srcs = sorted((ROOT / "mcmh_localization_tpu_torch").rglob("*.py"))
    return srcs + [ROOT / "chip_smoke.py"]


def test_sources_do_not_load_the_jax_package():
    imports = re.compile(
        r"^\s*(import|from)\s+mcmh_localization_tpu(\s|\.|$)", re.M)
    loaders = re.compile(
        r"importlib|spec_from_file_location|runpy|__import__|\bexec\(|"
        r"[\"']mcmh_localization_tpu[\"']")
    srcs = _port_sources()
    assert len(srcs) > 20
    assert not (ROOT / "mcmh_localization_tpu_torch" / "_shared.py").exists()
    for p in srcs:
        text = p.read_text()
        assert not imports.search(text), p
        assert not loaders.search(text), p


def test_import_leaves_no_jax_package_module():
    code = (
        "import sys, mcmh_localization_tpu_torch\n"
        "import mcmh_localization_tpu_torch.config\n"
        "import mcmh_localization_tpu_torch.io.pgm\n"
        "import mcmh_localization_tpu_torch.convert\n"
        "import mcmh_localization_tpu_torch.filter.staged\n"
        "from mcmh_localization_tpu_torch import (filter, io, maps, models,\n"
        "                                         ops, utils)\n"
        "bad = [n for n, m in list(sys.modules.items())\n"
        "       if n.split('.')[0] in ('jax', 'jaxlib', 'flax')\n"
        "       or (n.startswith('mcmh_localization_tpu')\n"
        "           and n.split('.')[0] != 'mcmh_localization_tpu_torch')\n"
        "       or '/mcmh_localization_tpu/' in\n"
        "          (getattr(m, '__file__', None) or '').replace('\\\\', '/')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_harness_imports_without_jax_matplotlib_or_pil():
    """The evaluation harness (sim, eval, io, metrics, profiling, viz)
    imports in an interpreter where jax, matplotlib and PIL cannot be
    imported (the card's machine has none of them): they load inside the
    functions that draw."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'matplotlib', 'PIL'):\n"
        "            raise ImportError(f'{name} blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import mcmh_localization_tpu_torch.eval.runner\n"
        "import mcmh_localization_tpu_torch.eval.plots\n"
        "import mcmh_localization_tpu_torch.sim, mcmh_localization_tpu_torch.io\n"
        "import mcmh_localization_tpu_torch.utils.metrics\n"
        "import mcmh_localization_tpu_torch.utils.profiling\n"
        "import mcmh_localization_tpu_torch.viz\n"
        "from mcmh_localization_tpu_torch import eval, sim\n"
        "assert not [n for n in sys.modules\n"
        "            if n.split('.')[0] in ('jax', 'matplotlib', 'PIL')]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ---------------------------------------------------------------------------
# the entry points run on the card unless told otherwise
# ---------------------------------------------------------------------------

_ENTRY_POINTS = {
    "build_grid_map": (grid_map.build_grid_map,
                       lambda f: f(np.zeros((8, 8), np.int8), 0.05)),
    "load_map": (grid_map.load_map, None),
    "grid_map_from_numpy": (convert.grid_map_from_numpy,
                            lambda f: f(np.zeros((8, 8), np.int8), 0.05,
                                        np.zeros(3))),
    "beam_tables_from_numpy": (convert.beam_tables_from_numpy,
                               lambda f: f(np.zeros((2, 4, 4), np.float32),
                                           np.zeros((2, 4, 4), np.int8),
                                           np.zeros(3, np.float32))),
    "state_from_numpy": (convert.state_from_numpy, None),
}


def _tensors(out):
    fields = out._asdict() if hasattr(out, "_asdict") else vars(out)
    return [v for v in fields.values() if isinstance(v, torch.Tensor)]


def _state_arrays():
    arrays = {name: np.zeros((4, 3), np.float32)
              for name in ("particles", "prev_particles")}
    arrays.update(weights=np.full(4, 0.25, np.float32), count=np.int32(4),
                  w_slow=np.float32(0), w_fast=np.float32(0),
                  delta=np.zeros(3, np.float32),
                  anchor=np.zeros(3, np.float32), anchor_streak=np.int32(0))
    return arrays


@pytest.mark.parametrize("name", list(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, tmp_path):
    fn, call = _ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if name == "load_map":
        tpgm.write_pgm(str(tmp_path / "m.pgm"), np.full((8, 8), 254, np.uint8))
        (tmp_path / "m.yaml").write_text(
            "image: m.pgm\nresolution: 0.05\norigin: [0.0, 0.0, 0.0]\n")
        call = lambda f: f(str(tmp_path / "m.yaml"))  # noqa: E731
    if name == "state_from_numpy":
        call = lambda f: f(_state_arrays())  # noqa: E731
    if torch.cuda.is_available():  # decided here, never at import
        assert all(t.device.type == "cuda" for t in _tensors(call(fn)))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(fn)
    # the CPU is used only when asked for
    out = call(lambda *a, **kw: fn(*a, device="cpu", **kw))
    assert _tensors(out)
    assert all(t.device.type == "cpu" for t in _tensors(out))
