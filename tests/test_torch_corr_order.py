"""Kernel 1's summation order: ``_bin_offsets`` orders each bin's beams by
(oy, ox), and the field build sums in that order.  The ordered build stays
within the f32 field-build tolerance of JAX's ``_build_field_xla`` (beam
order) and of the port's own beam-order sum, at a full-map, a SMALL-window
and a coarse-field layout."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu.models.corr_field import _build_field_xla  # noqa: E402
from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.models import corr_field as tcf  # noqa: E402
from mcmh_localization_tpu_torch.ops.corr_field_build import (  # noqa: E402
    corr_field_build,
    corr_field_build_plain,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401

M = 120
N_THETA = 24


@pytest.fixture(scope="module")
def torch_map(house_map):
    return grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")


def _beams(seed):
    """(u, v, valid) of an M-beam scan from a numpy seed; a third of the
    beams past max_range (invalid)."""
    rng = np.random.default_rng(seed)
    ranges = rng.uniform(0.2, 4.9, M).astype(np.float32)
    ranges[rng.random(M) < 0.33] = np.inf
    angles = np.linspace(-math.pi, math.pi, M, dtype=np.float32)
    r = torch.from_numpy(ranges)
    a = torch.from_numpy(angles)
    valid = torch.isfinite(r) & (r < 5.0)
    safe = torch.where(valid, r, 0.0)
    return safe * torch.cos(a), safe * torch.sin(a), valid


def _order_spec(ox, oy):
    """numpy spec of the order: per row, a stable sort on (oy, ox)."""
    ox, oy = np.asarray(ox), np.asarray(oy)
    order = np.stack([np.lexsort((ox[k], oy[k]), axis=0)
                      for k in range(ox.shape[0])])
    return (np.take_along_axis(ox, order, 1), np.take_along_axis(oy, order, 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_offsets_are_each_bins_beams_sorted(torch_map, seed):
    u, v, valid = _beams(seed)
    pad = 102
    args = (u, v, valid, torch_map.inv_res, N_THETA, pad, 2 * pad + 192)
    ox_raw, oy_raw = tcf._beam_offsets(*args)
    ox, oy = tcf._bin_offsets(*args)
    want_ox, want_oy = _order_spec(ox_raw, oy_raw)
    np.testing.assert_array_equal(ox.numpy(), want_ox)
    np.testing.assert_array_equal(oy.numpy(), want_oy)
    # a permutation of each bin's beams, the invalid ones last
    for k in range(N_THETA):
        got = sorted(zip(ox[k].tolist(), oy[k].tolist()))
        assert got == sorted(zip(ox_raw[k].tolist(), oy_raw[k].tolist()))
    n_valid = int(valid.sum())
    assert (oy[:, n_valid:] == 2 * pad + 192).all()
    assert (oy[:, :n_valid] <= 2 * pad).all()


def _layout(kind, torch_map, seed):
    """(padded, ox_beam_order, oy_beam_order, h, w, pad) as
    models/corr_field.py lays out the full map, the SMALL window and the
    coarse field."""
    lf = torch.from_numpy(np.random.default_rng(seed + 10).normal(
        -3.0, 1.5, size=(torch_map.height, torch_map.width)).astype(np.float32))
    u, v, valid = _beams(seed)
    cfg = FilterConfig(max_range=5.0, corr_window_cells=64,
                       corr_coarse_factor=4, corr_coarse_n_theta=12)
    h, w = lf.shape
    pad = tcf.pad_cells_for(cfg, torch_map)
    padded0 = torch.nn.functional.pad(lf, (pad, pad, pad, pad))
    zb = padded0.shape[0]
    if kind == "coarse":
        padded, _, _ = tcf.coarse_build_inputs(u, v, valid, lf, torch_map, cfg)
        kc, hc, wc = tcf.coarse_shape(cfg, h, w)
        pad_c = (padded.shape[1] - wc) // 2
        ox, oy = tcf._beam_offsets(u, v, valid, 1.0 / (4 * torch_map.res), kc,
                                   pad_c, padded.shape[0] - hc)
        return padded, ox, oy, hc, wc, pad_c
    if kind == "full":
        ox, oy = tcf._beam_offsets(u, v, valid, torch_map.inv_res, N_THETA,
                                   pad, zb)
        padded = torch.cat([padded0, torch.zeros((h, padded0.shape[1]))])
        return padded, ox, oy, h, w, pad
    win, oy0, ox0 = 64, 50, 70
    ox, oy = tcf._beam_offsets(u, v, valid, torch_map.inv_res, N_THETA, pad,
                               zb, bin_start=20, nbins=8)
    side = win + 2 * pad
    padded = torch.cat([padded0[oy0:oy0 + side, ox0:ox0 + side],
                        torch.zeros((win, side))])
    return padded, ox, torch.where(oy >= zb, side, oy), win, win, pad


@pytest.mark.parametrize("kind", ["full", "window", "coarse"])
@pytest.mark.parametrize("seed", [0, 3])
def test_ordered_build_within_tolerance_of_jax(torch_map, kind, seed):
    padded, ox, oy, h, w, pad = _layout(kind, torch_map, seed)
    oxo, oyo = tcf._order_beams(ox, oy, pad)
    got = corr_field_build(padded.contiguous(), oxo.contiguous(),
                           oyo.contiguous(), h, w).numpy()
    want = np.asarray(_build_field_xla(jnp.asarray(padded.numpy()),
                                       jnp.asarray(ox.numpy()),
                                       jnp.asarray(oy.numpy()), h, w))
    beam_order = corr_field_build_plain(padded, ox, oy, h, w).numpy()
    # f32 sums of M log values in another order: rtol 1e-5 and an absolute
    # floor of 1e-5 * M * max|L| for cancellation (test_torch_ops.py's)
    atol = 1e-5 * M * float(padded.abs().max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, beam_order, rtol=1e-5, atol=atol)
    assert got.shape == (oxo.shape[0], h, w)
    # the build's order is not the beam order
    assert not np.array_equal(oxo.numpy(), ox.numpy())
