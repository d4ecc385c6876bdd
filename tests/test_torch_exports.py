"""The port's package surface against the JAX package's: each sub-package
exports the JAX sub-package's names less a listed set not yet ported, and
the model factories take the JAX factories' parameters in their order."""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu.config import FilterConfig as JConfig  # noqa: E402
from mcmh_localization_tpu.filter import staged as jstaged  # noqa: E402
from mcmh_localization_tpu.filter import step as jstep  # noqa: E402
from mcmh_localization_tpu.parallel import batched as jbatched  # noqa: E402
from mcmh_localization_tpu.parallel import distributed as jdistributed  # noqa: E402
from mcmh_localization_tpu.parallel import sharding as jsharding  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.filter import staged, step  # noqa: E402
from mcmh_localization_tpu_torch.parallel import (  # noqa: E402
    batched,
    distributed,
    sharding,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

# JAX exports the port does not have yet, each with the ROADMAP item that
# ports it ("Not ported": the port keeps another form on purpose)
UNPORTED = {
    "filter": {},
    "models": {},
    "ops": {},
    "maps": {
        "distance_transform_edt_device":
            "Not ported: the port's EDT is scipy's exact one on the host"},
    "utils": {},
    "io": {},
    "sim": {},
    "eval": {},
    "parallel": {},
}


@pytest.mark.parametrize("sub", list(UNPORTED))
def test_subpackage_exports_match_jax_less_unported(sub):
    jmod = importlib.import_module(f"mcmh_localization_tpu.{sub}")
    tmod = importlib.import_module(f"mcmh_localization_tpu_torch.{sub}")
    unported = UNPORTED[sub]
    assert set(unported) <= set(jmod.__all__)
    assert tmod.__all__ == [n for n in jmod.__all__ if n not in unported]
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name
    for name in unported:
        assert not hasattr(tmod, name), f"{name} is ported: export it"


def test_top_level_exports_match_jax():
    """The top level exports JAX's names, ``__version__`` among them;
    ``build_grid_map`` stays importable from it (and from
    ``maps.grid_map``) without being exported."""
    import mcmh_localization_tpu as jpkg
    import mcmh_localization_tpu_torch as tpkg
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map

    assert tpkg.__all__ == jpkg.__all__
    assert isinstance(tpkg.__version__, str) and tpkg.__version__
    for name in tpkg.__all__:
        assert getattr(tpkg, name) is not None, name
    assert tpkg.build_grid_map is build_grid_map


def _params(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("port_fn,jax_fn", [
    (staged.make_staged_model, jstaged.make_staged_model),
    (step.make_model, jstep.make_model),
    (batched.make_batched_model, jbatched.make_batched_model),
    (batched.make_multimap_model, jbatched.make_multimap_model),
    (staged.make_staged_dist_model, jstaged.make_staged_dist_model),
    (distributed.make_dist_model, jdistributed.make_dist_model),
    (sharding.make_sharded_model, jsharding.make_sharded_model),
    (sharding.make_mesh, jsharding.make_mesh),
    (sharding.shard_state, jsharding.shard_state),
], ids=["make_staged_model", "make_model", "make_batched_model",
        "make_multimap_model", "make_staged_dist_model", "make_dist_model",
        "make_sharded_model", "make_mesh", "shard_state"])
def test_factory_signatures_match_jax(port_fn, jax_fn):
    assert _params(port_fn) == _params(jax_fn)
    names = [name for name, _ in _params(port_fn)]
    if "voxel_map" in names and "mesh" not in names:
        assert names.index("voxel_map") == (3 if "tracking_capacity" in names
                                            else 2)


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


_KW = dict(mode="AMHAMCL", num_particles=1_000_000, min_particles=1000,
           max_particles=1_000_000, initialized=True, likelihood_impl="corr",
           corr_window_cells=128, corr_theta_window_bins=32,
           motion_validity="score", min_injection_prob=0.02)


def test_jax_style_positional_staged_call_builds_a_windowed_model(
        house_map, torch_map):
    tst = staged.make_staged_model(FilterConfig(**_KW), torch_map, 2048, None,
                                   "windowed")
    jst = jstaged.make_staged_model(JConfig(**_KW), house_map, 2048, None,
                                    "windowed")
    # "windowed" keeps the window in the BIG program ("full" drops it)
    assert tst.config.corr_window_cells == 128
    assert step.state_size(tst.small_config) == 2048
    for t, j in ((tst.config, jst.config), (tst.small_config, jst.small_config)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tst.big.grid_map is torch_map and tst.small.config == tst.small_config


def test_factories_refuse_a_voxel_map(house_occupancy):
    """Both factories took ``voxel_map`` at JAX's position and refused any
    but None until the 3-D lidar was ported; now both build a lidar3d model
    from a voxel map passed there positionally, as a JAX call passes it,
    and a lidar3d config without one raises JAX's ValueError."""
    from mcmh_localization_tpu_torch.maps.voxel_map import (
        build_voxel_map,
        nav_slice,
    )

    occ = np.stack([np.full_like(house_occupancy, 100)]
                   + [house_occupancy] * 3)
    vm = build_voxel_map(occ, 0.05, (-4.8, -4.8, 0.0), device="cpu")
    nav = nav_slice(vm, z=0.1)
    cfg = FilterConfig(**{**_KW, "num_particles": 4096, "max_particles": 4096,
                          "sensor_model": "lidar3d"})
    model = step.make_model(cfg, nav, vm)
    assert isinstance(model, step.FilterModel) and model.voxel_map is vm
    assert model.log_field.log_volume.shape == occ.shape
    st = staged.make_staged_model(cfg, nav, 2048, vm)
    assert st.big.voxel_map is vm and st.small.voxel_map is vm
    assert step.state_size(st.small_config) == 2048
    with pytest.raises(ValueError, match="voxel_map"):
        step.make_model(cfg, nav)
    assert isinstance(step.make_model(FilterConfig(**_KW), nav, None),
                      step.FilterModel)
