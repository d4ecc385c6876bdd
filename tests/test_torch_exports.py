"""The port's package surface against the JAX package's: each sub-package
exports the JAX sub-package's names less a listed set not yet ported, every
exported callable takes the JAX parameters and every exported class has the
JAX members (less a listed set of deliberate differences), and the model
factories take the JAX factories' parameters in their order."""

import dataclasses
import importlib
import inspect
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
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
    "maps": {},
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


# The deliberate differences of the port's signatures and members from
# JAX's (ROADMAP §1): random draws come from a torch generator or the
# caller's draws, never from a JAX PRNG ``key`` (nor its ``rng_impl``); the
# port's FilterModel is a plain class, where JAX's NamedTuple inherits the
# tuple methods ``count`` and ``index``.
DELIBERATE_PARAMS = {"key", "rng_impl"}
DELIBERATE_MEMBERS = {"FilterModel": {"count", "index"}}


def _members(cls) -> set:
    """Public names of a class: its attributes, dataclass and NamedTuple
    fields, and the attributes its ``__init__`` assigns."""
    names = set(dir(cls)) | set(getattr(cls, "_fields", ()))
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    elif "__init__" in cls.__dict__ and not hasattr(cls, "_fields"):
        src = inspect.getsource(cls.__init__)
        names |= set(re.findall(r"self\.(\w+)\s*=", src))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("sub", [None, *UNPORTED])
def test_exports_take_jax_parameters_and_members(sub):
    """For every name in a JAX (sub-)package's ``__all__``: the port's
    callable takes every JAX parameter, and the port's class has every
    public JAX member, less the deliberate differences listed above."""
    suffix = "" if sub is None else f".{sub}"
    jmod = importlib.import_module(f"mcmh_localization_tpu{suffix}")
    tmod = importlib.import_module(f"mcmh_localization_tpu_torch{suffix}")
    gaps = {}
    for name in jmod.__all__:
        j, t = getattr(jmod, name), getattr(tmod, name)
        if inspect.isclass(j):
            missing = (_members(j) - _members(t)
                       - DELIBERATE_MEMBERS.get(name, set()))
        elif callable(j):
            tparams = inspect.signature(t).parameters
            missing = {p for p in inspect.signature(j).parameters
                       if p not in tparams} - DELIBERATE_PARAMS
        else:
            continue
        if missing:
            gaps[name] = sorted(missing)
    assert not gaps


def test_grid_map_limits_and_grid_to_world_match_jax(house_map,
                                                     house_occupancy):
    """``GridMap.limits`` and ``grid_to_world`` (F4) equal JAX's bitwise on
    the house map built from the same python resolution and origin."""
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map

    m = build_grid_map(house_occupancy, 0.05, (-4.8, -4.8), device="cpu")
    assert m.limits.dtype == torch.float32
    np.testing.assert_array_equal(m.limits.numpy(),
                                  np.asarray(house_map.limits))
    rng = np.random.default_rng(0)
    mx = np.concatenate([[0, 10, 191], rng.integers(-5, 200, 64)]).astype(np.int32)
    my = np.concatenate([[0, 20, 191], rng.integers(-5, 200, 64)]).astype(np.int32)
    tx, ty = m.grid_to_world(torch.from_numpy(mx), torch.from_numpy(my))
    jx, jy = house_map.grid_to_world(jnp.asarray(mx), jnp.asarray(my))
    assert tx.dtype == torch.float32 and tx.device == m.device
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    # the round trip of tests/test_maps.py::test_world_grid_roundtrip
    gx, gy = m.world_to_grid(tx[:3], ty[:3])
    assert gx.tolist() == [0, 10, 191] and gy.tolist() == [0, 20, 191]


def test_replace_on_maps_estimates_and_infos(house_occupancy):
    """``.replace(**kw)`` (F5) on GridMap, VoxelMap, PoseEstimate and
    StepInfo: a new object with the given fields and the rest as they were,
    the original unchanged; a GridMap given a new resolution or origin
    tensor also updates the python floats its kernels read."""
    from mcmh_localization_tpu_torch.filter.estimate import PoseEstimate
    from mcmh_localization_tpu_torch.filter.step import StepInfo
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map
    from mcmh_localization_tpu_torch.maps.voxel_map import build_voxel_map

    m = build_grid_map(house_occupancy, 0.05, (-4.8, -4.8), device="cpu")
    zeros = torch.zeros_like(m.distance)
    m2 = m.replace(distance=zeros)
    assert m2.distance is zeros and m.distance is not zeros
    assert m2.occupancy is m.occupancy and m2.res == m.res
    m3 = m.replace(resolution=torch.tensor(0.1), origin=torch.tensor([1.0, 2.0]))
    assert m3.res == float(np.float32(0.1)) and m3.origin_xy == (1.0, 2.0)
    assert m.res == float(np.float32(0.05))
    np.testing.assert_array_equal(m3.limits.numpy(), np.float32(
        [1.0, 1.0 + 192 * np.float32(0.1), 2.0, 2.0 + 192 * np.float32(0.1)]))

    vm = build_voxel_map(np.stack([house_occupancy] * 2), 0.05,
                         (-4.8, -4.8, 0.0), device="cpu")
    vm2 = vm.replace(max_distance=2.0)
    assert vm2.max_distance == 2.0 and vm.max_distance is None
    assert vm2.distance is vm.distance

    est = PoseEstimate(mean=torch.zeros(3), cov=torch.eye(3))
    est2 = est.replace(mean=torch.ones(3))
    assert torch.equal(est2.mean, torch.ones(3)) and est2.cov is est.cov
    assert torch.equal(est.mean, torch.zeros(3))
    scalars = {f: torch.tensor(float(i)) for i, f in
               enumerate(StepInfo._fields[1:])}
    info = StepInfo(estimate=est, **scalars)
    info2 = info.replace(ess=torch.tensor(7.0), estimate=est2)
    assert info2.ess.item() == 7.0 and info2.estimate is est2
    assert info2.count is info.count and info.ess.item() == 0.0


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
