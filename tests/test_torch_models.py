"""The port's config, map, sensor, motion and init modules against the JAX
package on shared inputs and draws; and the port's import isolation."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu import config as jconfig  # noqa: E402
from mcmh_localization_tpu.filter import init as jinit  # noqa: E402
from mcmh_localization_tpu.models import motion as jmotion  # noqa: E402
from mcmh_localization_tpu.models import sensor as jsensor  # noqa: E402
from mcmh_localization_tpu_torch import config as tconfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.filter import init as tinit  # noqa: E402
from mcmh_localization_tpu_torch.filter.step import make_model  # noqa: E402
from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map  # noqa: E402
from mcmh_localization_tpu_torch.models import motion as tmotion  # noqa: E402
from mcmh_localization_tpu_torch.models import sensor as tsensor  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
ALPHA = (0.002, 0.03, 0.08, 0.002)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def torch_map(house_occupancy):
    return build_grid_map(house_occupancy, 0.05, (-4.8, -4.8), device="cpu")


# ---------------------------------------------------------------------------
# config, io, maps
# ---------------------------------------------------------------------------

def test_config_is_the_jax_source():
    """The port's own FilterConfig keeps the JAX file's fields and defaults
    (tests/test_torch_config.py compares them one by one)."""
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.FilterConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.FilterConfig)]
    assert jf == tf
    assert tconfig.MODES == jconfig.MODES
    assert tconfig.parse_mode("AMHAMCL") == jconfig.parse_mode("AMHAMCL")
    with pytest.raises(ValueError):
        tconfig.FilterConfig(corr_window_cells=12)


@pytest.mark.parametrize("kw, item", [
    (dict(sensor_model="beam"), "item 13"),
    (dict(sensor_model="lidar3d"), "item 14"),
])
def test_out_of_slice_config_raises(kw, item, torch_map, house_occupancy):
    """A configuration of a ROADMAP item was refused until the item was
    ported; items 13 (the beam model) and 14 (the 3-D lidar, with its voxel
    map) are, and make_model builds each.  ``config.check_supported``,
    which refused them, is gone with the last refusal."""
    base = dict(mode="AMHAMCL", motion_validity="score", corr_coarse_factor=0,
                likelihood_impl="auto")
    base.update(kw)
    voxel = None
    if item == "item 14":
        from mcmh_localization_tpu_torch.maps.voxel_map import build_voxel_map

        voxel = build_voxel_map(np.stack([house_occupancy] * 2), 0.05,
                                (-4.8, -4.8, 0.0), device="cpu")
    model = make_model(tconfig.FilterConfig(**base), torch_map, voxel)
    assert model.voxel_map is voxel
    assert not hasattr(tconfig, "check_supported")


@pytest.mark.parametrize("kw", [
    dict(likelihood_impl="jnp"),
    dict(corr_window_cells=64, corr_coarse_factor=4),
    dict(motion_validity="reject"),
    dict(mode="MHMCL"),
    dict(adaptive_resampler="lvr"),
], ids=["jnp", "coarse", "reject", "MHMCL", "lvr"])
def test_formerly_refused_config_accepted(kw, torch_map):
    """The exact scorer, the coarse fallback, "reject", the non-adaptive
    modes and the simple/lvr resamplers were refused before they were
    ported; make_model builds each now."""
    base = dict(mode="AMHAMCL", motion_validity="score", corr_coarse_factor=0,
                likelihood_impl="auto")
    base.update(kw)
    model = make_model(tconfig.FilterConfig(**base), torch_map)
    assert model.config == tconfig.FilterConfig(**base)


def test_pgm_map_roundtrip(tmp_path, house_occupancy):
    from mcmh_localization_tpu.io.pgm import load_map_yaml as j_load
    from mcmh_localization_tpu_torch.io.pgm import load_map_yaml, write_pgm
    from mcmh_localization_tpu_torch.maps.grid_map import load_map

    img = np.where(house_occupancy == 0, 254,
                   np.where(house_occupancy == 100, 0, 205))[::-1]
    write_pgm(str(tmp_path / "m.pgm"), img.astype(np.uint8))
    (tmp_path / "m.yaml").write_text(
        "image: m.pgm\nresolution: 0.05\norigin: [-4.8, -4.8, 0.0]\n"
        "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n")
    occ, meta = load_map_yaml(str(tmp_path / "m.yaml"))
    occ_j, meta_j = j_load(str(tmp_path / "m.yaml"))
    np.testing.assert_array_equal(occ, occ_j)
    np.testing.assert_array_equal(occ, house_occupancy)
    gm = load_map(str(tmp_path / "m.yaml"), device="cpu")
    assert gm.origin_xy == (np.float32(-4.8), np.float32(-4.8))


def test_grid_map_matches_jax(house_map, torch_map):
    """Same occupancy, EDT (scipy on both sides), free cells, transforms."""
    np.testing.assert_array_equal(torch_map.occupancy.numpy(),
                                  np.asarray(house_map.occupancy))
    np.testing.assert_array_equal(torch_map.distance.numpy(),
                                  np.asarray(house_map.distance))
    np.testing.assert_array_equal(torch_map.free_xy.numpy(),
                                  np.asarray(house_map.free_xy))
    np.testing.assert_array_equal(torch_map.free_mask.numpy(),
                                  np.asarray(house_map.free_mask))
    rng = np.random.default_rng(0)
    x = rng.uniform(-5.5, 5.5, 3000).astype(np.float32)
    y = rng.uniform(-5.5, 5.5, 3000).astype(np.float32)
    mx_j, my_j = house_map.world_to_grid(jnp.asarray(x), jnp.asarray(y))
    mx_t, my_t = torch_map.world_to_grid(_t(x), _t(y))
    np.testing.assert_array_equal(mx_t.numpy(), np.asarray(mx_j))
    np.testing.assert_array_equal(my_t.numpy(), np.asarray(my_j))
    np.testing.assert_array_equal(
        torch_map.occupancy_at(mx_t, my_t).numpy(),
        np.asarray(house_map.occupancy_at(mx_j, my_j)))
    np.testing.assert_array_equal(
        torch_map.is_free_world(_t(x), _t(y)).numpy(),
        np.asarray(house_map.is_free_world(jnp.asarray(x), jnp.asarray(y))))
    gm2 = grid_map_from_numpy(np.asarray(house_map.occupancy), 0.05,
                              np.asarray(house_map.origin), device="cpu")
    np.testing.assert_array_equal(gm2.distance.numpy(),
                                  torch_map.distance.numpy())


def test_log_likelihood_field_matches_jax(house_map, torch_map):
    """exp/log/sqrt differ by an ulp between XLA and torch: rtol 1e-6."""
    cfg = jconfig.FilterConfig(max_range=5.0)
    want = np.asarray(jsensor.log_likelihood_field(house_map, cfg))
    got = tsensor.log_likelihood_field(torch_map, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_raycast_matches_jax(house_map, torch_map):
    """Ranges are step multiples: equal except where an ulp of cos/sin
    moves a ray sample across a cell edge (one step, 0.1 m, at most 2%)."""
    angles = np.linspace(-np.pi, np.pi, 360).astype(np.float32)
    for pose in ((1.0, 1.0, 0.4), (-2.0, 3.1, -2.0), (3.0, -3.0, 3.1)):
        want = np.asarray(jsensor.raycast(
            jnp.asarray(pose[:2], jnp.float32), pose[2] + jnp.asarray(angles),
            house_map, 5.0, hit_unknown=True))
        got = tsensor.raycast(_t(np.float32(pose[:2])), pose[2] + _t(angles),
                              torch_map, 5.0, hit_unknown=True).numpy()
        diff = np.abs(got - want)
        assert diff.max() <= 0.1 + 1e-5
        assert (diff > 1e-5).mean() <= 0.02


# ---------------------------------------------------------------------------
# motion model
# ---------------------------------------------------------------------------

def test_sample_motion_matches_jax_on_shared_noise():
    """Same normals in; cos/sin ulps and possible contraction of the noise
    scales allow 2e-6 m / rad."""
    rng = np.random.default_rng(3)
    parts = np.stack([rng.uniform(-3, 3, 5000), rng.uniform(-3, 3, 5000),
                      rng.uniform(-np.pi, np.pi, 5000)], 1).astype(np.float32)
    delta = np.float32([0.3, 0.12, -0.2])
    key = jax.random.PRNGKey(4)
    want = np.asarray(jmotion.sample_motion(
        key, jnp.asarray(parts), jnp.asarray(delta), ALPHA, None, retries=0,
        rng_impl="threefry"))
    noise = jax.random.normal(key, (5000, 3), jnp.float32)
    got = tmotion.sample_motion(_t(parts), _t(delta), ALPHA,
                                noise=_t(noise)).numpy()
    d = np.abs(got - want)
    d[:, 2] = np.minimum(d[:, 2], 2 * np.pi - d[:, 2])
    assert d.max() < 2e-6


def test_motion_density_and_deltas_match_jax():
    rng = np.random.default_rng(5)
    prev = np.stack([rng.uniform(-3, 3, 4000), rng.uniform(-3, 3, 4000),
                     rng.uniform(-np.pi, np.pi, 4000)], 1).astype(np.float32)
    delta = np.float32([0.3, 0.12, -0.2])
    curr = np.asarray(jmotion.sample_motion(
        jax.random.PRNGKey(1), jnp.asarray(prev), jnp.asarray(delta), ALPHA,
        None, retries=0, rng_impl="threefry"))
    for ref_compat in (False, True):
        want_inv = np.asarray(jmotion.invert_delta(jnp.asarray(delta),
                                                   ref_compat=ref_compat))
        got_inv = tmotion.invert_delta(_t(delta), ref_compat=ref_compat)
        np.testing.assert_allclose(got_inv.numpy(), want_inv, rtol=1e-6,
                                   atol=1e-6)
    inv = jmotion.invert_delta(jnp.asarray(delta))
    # an ulp of atan2 near pi (2.4e-7 rad) over a rotation sigma of ~4e-3
    # moves the Gaussian exponent by ~6e-5 per unit of |diff/sigma|: rtol
    # 1e-3 on densities normalized over 4000 pairs
    for a, b, d in ((prev, curr, delta), (curr, prev, np.asarray(inv))):
        want = np.asarray(jmotion.motion_density(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(d), ALPHA))
        got = tmotion.motion_density(_t(a), _t(b), _t(d), ALPHA).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-9)
    p0, p1 = np.float32([0.5, -1.0, 3.0]), np.float32([0.9, -0.7, -2.9])
    np.testing.assert_allclose(
        tmotion.compute_motion(_t(p0), _t(p1)).numpy(),
        np.asarray(jmotion.compute_motion(jnp.asarray(p0), jnp.asarray(p1))),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5000, 70000], ids=["direct", "pooled"])
def test_init_uniform_matches_jax_on_shared_draws(house_map, torch_map, n):
    key = jax.random.PRNGKey(9)
    want = np.asarray(jinit.init_uniform(key, n, house_map))
    k_cell, k_off, k_theta = jax.random.split(key, 3)
    f = house_map.free_xy.shape[0]
    cells = jax.random.randint(k_cell, (min(n, 65536),), 0, f)
    jitter = jax.random.uniform(k_off, (n, 2), minval=-0.5, maxval=0.5)
    theta = jax.random.uniform(k_theta, (n,), minval=-jnp.pi, maxval=jnp.pi)
    got = tinit.init_uniform(n, torch_map, cells=_t(cells), jitter=_t(jitter),
                             theta=_t(theta)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ref_compat", [False, True])
def test_init_gaussian_matches_jax_on_shared_draws(house_map, torch_map,
                                                   ref_compat):
    key = jax.random.PRNGKey(2)
    mean = np.float32([1.0, 1.0, 0.4])
    cov = np.diag(np.float32([0.5, 0.5, 0.1]))
    want = np.asarray(jinit.init_gaussian(key, jnp.asarray(mean),
                                          jnp.asarray(cov), 4000, house_map,
                                          ref_compat=ref_compat))
    k_n, _ = jax.random.split(key)
    eps = jax.random.normal(k_n, (4000, 3), dtype=jnp.float32)
    got = tinit.init_gaussian(mean, cov, 4000, torch_map,
                              ref_compat=ref_compat, noise=_t(eps)).numpy()
    # matmul with the Cholesky factor: f32 order, 1e-6
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# isolation
# ---------------------------------------------------------------------------

def test_port_imports_without_jax():
    code = (
        "import sys, mcmh_localization_tpu_torch\n"
        "import mcmh_localization_tpu_torch.filter.staged\n"
        "import mcmh_localization_tpu_torch.convert\n"
        "import mcmh_localization_tpu_torch.ops.fused_score\n"
        "import mcmh_localization_tpu_torch.ops.likelihood\n"
        "import mcmh_localization_tpu_torch.ops.take\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'mcmh_localization_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_do_not_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|mcmh_localization_tpu)\b",
                     re.M)
    srcs = list((ROOT / "mcmh_localization_tpu_torch").rglob("*.py"))
    srcs.append(ROOT / "chip_smoke.py")
    assert len(srcs) > 10
    for p in srcs:
        assert not pat.search(p.read_text()), p
