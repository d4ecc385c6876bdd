"""The port's EDT options against the JAX package's, on the CPU: the device
EDT (``maps/edt.py``; on the CPU ``ops/edt.py``'s plain version, the
kernel's twin), ``edt_impl`` on ``build_grid_map``, ``load_map`` and
``nav_slice``, and the port's own ``native`` binding.  Inputs come from a
numpy seed; the JAX side runs its exact f32 min-plus passes.  Every
comparison is bitwise."""

import numpy as np
import pytest
from scipy.ndimage import distance_transform_edt

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu import native as jnative  # noqa: E402
from mcmh_localization_tpu.maps import edt as jedt  # noqa: E402
from mcmh_localization_tpu.maps import grid_map as jgm  # noqa: E402
from mcmh_localization_tpu.maps import voxel_map as jvm  # noqa: E402
from mcmh_localization_tpu_torch import native  # noqa: E402
from mcmh_localization_tpu_torch.io.pgm import write_pgm  # noqa: E402
from mcmh_localization_tpu_torch.maps import edt as tedt  # noqa: E402
from mcmh_localization_tpu_torch.maps import grid_map as tgm  # noqa: E402
from mcmh_localization_tpu_torch.maps import voxel_map as tvm  # noqa: E402
from mcmh_localization_tpu_torch.ops import edt as oedt  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

IMPLS = ("scipy", "device", "native", "auto")
ORIGIN = (-4.8, -4.8)


def _random(shape, p, seed=0):
    occ = np.random.default_rng(seed).random(shape) < p
    occ[0, 0] = True  # nonempty
    return occ


@pytest.fixture(params=["house", "random_37x53", "row_1x61", "column_61x1"])
def occupied(request, house_occupancy):
    if request.param == "house":
        return house_occupancy != 0
    shape = {"random_37x53": (37, 53), "row_1x61": (1, 61),
             "column_61x1": (61, 1)}[request.param]
    return _random(shape, 0.1)


def _need_native():
    if not native.available():
        pytest.skip("native/libmcmh_native.so not built")


def test_device_edt_matches_jax(occupied):
    """Twin of tests/test_maps.py::test_device_edt_matches_scipy and
    ::test_device_edt_random: the squared form bitwise JAX's
    ``squared_edt_device``, the meter form bitwise JAX's
    ``distance_transform_edt_device`` at 1.0 and 0.05 m, and within JAX's
    1e-3 of scipy."""
    occ_t = torch.from_numpy(occupied)
    d2 = tedt.squared_edt_device(occ_t)
    assert d2.dtype == torch.float32 and d2.shape == occupied.shape
    np.testing.assert_array_equal(
        d2.numpy(), np.asarray(jedt.squared_edt_device(jnp.asarray(occupied))))
    for res in (1.0, 0.05):
        got = tedt.distance_transform_edt_device(occ_t, res)
        want = np.asarray(jedt.distance_transform_edt_device(
            jnp.asarray(occupied), res))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        tedt.distance_transform_edt_device(occ_t, 1.0).numpy(),
        distance_transform_edt(~occupied), atol=1e-3)


@pytest.mark.parametrize("case", ["all_free", "all_occupied", "corner"])
def test_device_edt_edge_maps(case):
    """No occupied cell reads JAX's float32(1e12) squared (50000.0 m at
    0.05 m), an all-occupied map zeros, one occupied corner scipy's squared
    distances; each bitwise JAX's."""
    occ = np.zeros((23, 31), dtype=bool)
    if case == "all_occupied":
        occ[:] = True
    elif case == "corner":
        occ[22, 30] = True
    occ_t = torch.from_numpy(occ)
    d2 = tedt.squared_edt_device(occ_t).numpy()
    np.testing.assert_array_equal(
        d2, np.asarray(jedt.squared_edt_device(jnp.asarray(occ))))
    meters = tedt.distance_transform_edt_device(occ_t, 0.05).numpy()
    np.testing.assert_array_equal(meters, np.asarray(
        jedt.distance_transform_edt_device(jnp.asarray(occ), 0.05)))
    if case == "all_free":
        assert (d2 == np.float32(1e12)).all() and (meters == 50000.0).all()
    elif case == "all_occupied":
        assert (d2 == 0).all()
    else:
        ref = np.rint(distance_transform_edt(~occ) ** 2).astype(np.float32)
        np.testing.assert_array_equal(d2, ref)


@pytest.mark.parametrize("shape", [(1, 5000), (5000, 1)])
def test_squared_edt_exact_past_f32_integers(shape):
    """One occupied end cell of a 5000-cell line: squared distances up to
    4999^2 > 2^24, where JAX's f32 passes stop being exact (JAX is not run
    here); the port's integers, cast to f32, equal scipy's rounded
    squares."""
    occ = np.zeros(shape, dtype=bool)
    occ[0, 0] = True
    d2 = tedt.squared_edt_device(torch.from_numpy(occ)).numpy()
    ref = np.rint(distance_transform_edt(~occ) ** 2).astype(np.float32)
    assert ref.max() > 2 ** 24
    np.testing.assert_array_equal(d2, ref)


def test_plain_chunks_and_input_checks():
    """The plain version's column chunk bounds memory, not the result;
    the wrapper refuses anything but a 2-D bool tensor."""
    occ = torch.from_numpy(_random((37, 53), 0.05, seed=3))
    ref = oedt.squared_edt_plain(occ, chunk=128)
    for chunk in (1, 7, 53, 1000):
        assert torch.equal(oedt.squared_edt_plain(occ, chunk=chunk), ref)
    assert torch.equal(oedt.squared_edt(occ, chunk=5), ref)
    with pytest.raises(ValueError, match="bool"):
        oedt.squared_edt(occ.to(torch.uint8))
    with pytest.raises(ValueError, match="2-D"):
        oedt.squared_edt(occ[None])


def _jax_map(occ, impl):
    return jgm.build_grid_map(occ, 0.05, ORIGIN, edt_impl=impl)


def _assert_maps_equal(t, j):
    for name in ("occupancy", "distance", "origin", "resolution", "free_xy",
                 "free_mask"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)


@pytest.mark.parametrize("impl", IMPLS)
def test_build_grid_map_edt_impl_matches_jax(impl, house_occupancy):
    """Each ``edt_impl`` gives JAX's map for the same name, bitwise; the
    device field is computed where the map lives (no host scipy)."""
    if impl == "native":
        _need_native()
    t = tgm.build_grid_map(house_occupancy, 0.05, ORIGIN, edt_impl=impl,
                           device="cpu")
    _assert_maps_equal(t, _jax_map(house_occupancy, impl))
    assert t.distance.dtype == torch.float32 and t.distance.device.type == "cpu"


@pytest.mark.parametrize("impl", IMPLS)
def test_load_map_edt_impl_matches_jax(impl, house_occupancy, tmp_path):
    """``load_map(yaml, edt_impl)`` gives JAX's ``load_map(yaml,
    edt_impl)``, bitwise, on the house written as PGM + YAML."""
    if impl == "native":
        _need_native()
    occ = house_occupancy
    img = np.where(occ == 0, 254, np.where(occ > 0, 0, 205)).astype(np.uint8)
    write_pgm(str(tmp_path / "map.pgm"), img[::-1])
    yaml = tmp_path / "map.yaml"
    yaml.write_text(f"image: map.pgm\nresolution: 0.05\norigin: [{ORIGIN[0]}, "
                    f"{ORIGIN[1]}, 0.0]\nnegate: 0\noccupied_thresh: 0.65\n"
                    "free_thresh: 0.196\n")
    t = tgm.load_map(str(yaml), edt_impl=impl, device="cpu")
    _assert_maps_equal(t, jgm.load_map(str(yaml), edt_impl=impl))


def test_device_and_scipy_fields_differ_by_an_ulp_at_most(house_occupancy):
    """"device" is JAX's sqrt-times-resolution in f32, "scipy" the f64
    product cast to f32: not interchangeable bitwise, within one ulp."""
    dev = tgm.build_grid_map(house_occupancy, 0.05, ORIGIN, edt_impl="device",
                             device="cpu").distance.numpy()
    sci = tgm.build_grid_map(house_occupancy, 0.05, ORIGIN, edt_impl="scipy",
                             device="cpu").distance.numpy()
    assert not np.array_equal(dev, sci)
    assert (np.abs(dev - sci) <= np.spacing(np.maximum(dev, sci))).all()


def test_unknown_edt_impl_raises(house_occupancy, tmp_path):
    """A name outside the four raises (JAX takes its device path there)."""
    with pytest.raises(ValueError, match="edt_impl"):
        tgm.build_grid_map(house_occupancy, 0.05, ORIGIN, edt_impl="gpu",
                           device="cpu")
    vm = tvm.build_voxel_map(np.stack([house_occupancy] * 2), 0.05,
                             (*ORIGIN, 0.0), device="cpu")
    with pytest.raises(ValueError, match="edt_impl"):
        tvm.nav_slice(vm, 0.0, edt_impl="Device")
    # a given distance field needs no EDT, as in JAX
    m = tgm.build_grid_map(house_occupancy, 0.05, ORIGIN,
                           distance=np.zeros(house_occupancy.shape),
                           edt_impl="anything", device="cpu")
    assert (m.distance == 0).all()


def test_device_impl_runs_no_host_edt(house_occupancy, monkeypatch):
    """"device" computes on the map's device through ``ops/edt.py``: the
    host EDTs are never called."""
    def refuse(*a, **k):
        raise AssertionError("host EDT called")

    monkeypatch.setattr(tgm, "distance_transform_edt", refuse)
    monkeypatch.setattr(native, "edt", refuse)
    calls = []
    real = oedt.squared_edt_plain
    monkeypatch.setattr(oedt, "squared_edt_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tgm.build_grid_map(house_occupancy, 0.05, ORIGIN, edt_impl="device",
                       device="cpu")
    assert calls == [1]


@pytest.mark.parametrize("built", [True, False])
def test_auto_takes_native_only_where_available(built, house_occupancy,
                                                monkeypatch):
    """"auto" is the native library where ``available()`` says it is
    built, else the device EDT; with the library missing "native" raises
    and ``available()`` is False."""
    if built:
        _need_native()
    else:
        monkeypatch.setattr(native, "LIB_PATH",
                            native.LIB_PATH.with_name("missing.so"))
        monkeypatch.setattr(native, "_LIB", None)
        assert not native.available()
        with pytest.raises(ImportError):
            tgm.build_grid_map(house_occupancy, 0.05, ORIGIN,
                               edt_impl="native", device="cpu")
    auto = tgm.build_grid_map(house_occupancy, 0.05, ORIGIN, edt_impl="auto",
                              device="cpu")
    want = _jax_map(house_occupancy, "native" if built else "device")
    np.testing.assert_array_equal(auto.distance.numpy(),
                                  np.asarray(want.distance))


@pytest.mark.parametrize("impl", ["device", "scipy"])
def test_nav_slice_edt_impl_matches_jax(impl, house_occupancy):
    """``nav_slice(..., edt_impl)`` passes the name on, as JAX does: the
    slice equals JAX's bitwise."""
    occ = np.stack([np.full_like(house_occupancy, 100), house_occupancy,
                    house_occupancy])
    jv = jvm.build_voxel_map(occ, 0.05, (*ORIGIN, 0.0))
    tv = tvm.build_voxel_map(occ, 0.05, (*ORIGIN, 0.0), device="cpu")
    _assert_maps_equal(tvm.nav_slice(tv, 0.07, edt_impl=impl),
                       jvm.nav_slice(jv, 0.07, edt_impl=impl))


# twins of tests/test_native.py for the port's binding


def test_native_edt_matches_scipy_random():
    _need_native()
    rng = np.random.default_rng(0)
    for shape in ((33, 47), (128, 128), (200, 64)):
        occ = rng.random(shape) < 0.08
        occ[0, 0] = True
        got = native.edt(occ)
        np.testing.assert_allclose(got, distance_transform_edt(~occ), atol=1e-4)
        np.testing.assert_array_equal(got, jnative.edt(occ))


def test_native_edt_house(house_occupancy):
    _need_native()
    occ = house_occupancy != 0
    got = native.edt(occ)
    np.testing.assert_allclose(got, distance_transform_edt(~occ), atol=1e-4)
    np.testing.assert_array_equal(got, jnative.edt(occ))


def test_native_edt_no_obstacles():
    _need_native()
    got = native.edt(np.zeros((16, 16), dtype=bool))
    assert got.dtype == np.float32 and (got > 1e10).all()


def test_native_edt_all_obstacles():
    _need_native()
    assert (native.edt(np.ones((8, 8), dtype=bool)) == 0).all()


def test_build_grid_map_native_path(house_occupancy):
    _need_native()
    m_native = tgm.build_grid_map(house_occupancy, 0.05, ORIGIN,
                                  edt_impl="native", device="cpu")
    m_scipy = tgm.build_grid_map(house_occupancy, 0.05, ORIGIN,
                                 edt_impl="scipy", device="cpu")
    np.testing.assert_allclose(m_native.distance.numpy(),
                               m_scipy.distance.numpy(), atol=1e-4)
