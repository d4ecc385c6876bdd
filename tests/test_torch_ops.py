"""The port's kernel modules (mcmh_localization_tpu_torch/ops) against the
JAX package on the same inputs.

The port's wrappers take their plain PyTorch versions on CPU tensors; the
CUDA kernels are held to those plain versions on the card by chip_smoke.py.
The JAX side runs its Pallas kernels in interpret mode and its exact CPU
(XLA) paths."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmh_localization_tpu_torch.ops.corr_field_build import corr_field_build  # noqa: E402
from mcmh_localization_tpu_torch.ops.gather import gather_2d  # noqa: E402
from mcmh_localization_tpu_torch.ops.rank import (  # noqa: E402
    expand_sorted,
    rank_in_sorted,
)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One torch thread in each test process.  The tensors here are small,
    and the suite runs in several worker processes: torch's default of one
    thread per core in each of them oversubscribes the cores (measured on
    8 cores with 6 workers: the port's tests took 226 s, 73 s with one
    thread).  Every tests/test_torch_*.py module imports this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


# ---------------------------------------------------------------------------
# kernel 1: the correlation-field build
# ---------------------------------------------------------------------------

def _field_inputs(house_map, n_theta, m, seed, window=None):
    """(padded, ox, oy, h, w, M, max|L|) as models/corr_field.py lays them
    out for the full map, or for a window region (win, oy0, ox0)."""
    from mcmh_localization_tpu.models.corr_field import _bin_offsets

    rng = np.random.default_rng(seed)
    h, w = house_map.occupancy.shape
    L = rng.normal(-2.0, 1.0, size=(h, w)).astype(np.float32)
    res = float(jax.device_get(house_map.resolution))
    pad = int(-(-5.0 // res)) + 2
    ranges = rng.uniform(0.3, 6.0, m).astype(np.float32)
    ranges[::9] = np.inf                      # invalid beams -> zero band
    angles = np.linspace(-np.pi, np.pi, m).astype(np.float32)
    valid = jnp.isfinite(ranges) & (ranges < 5.0)
    safe_r = jnp.where(valid, ranges, 0.0)
    u = (safe_r * jnp.cos(angles)).astype(jnp.float32)
    v = (safe_r * jnp.sin(angles)).astype(jnp.float32)
    padded0 = jnp.pad(jnp.asarray(L), pad)
    zrow = padded0.shape[0]
    ox, oy = _bin_offsets(u, v, valid, 1.0 / house_map.resolution, n_theta,
                          pad, zrow)
    if window is None:
        padded = jnp.pad(padded0, ((0, h + 16), (0, 128)))
        return padded, ox, oy, h, w, m, float(np.abs(L).max())
    win, oy0, ox0 = window
    rh, rw = 2 * pad + win + 16, 2 * pad + win + 128
    padded = jnp.pad(padded0, ((0, h + 16), (0, 128)))
    region = jax.lax.dynamic_slice(padded, (oy0, ox0), (rh, rw))
    region = jnp.pad(region, ((0, win + 16), (0, 0)))
    oy = jnp.where(oy >= zrow, rh, oy)
    return region, ox, oy, win, win, m, float(np.abs(L).max())


@pytest.mark.parametrize("window", [None, (64, 40, 70)],
                         ids=["full_map", "windowed"])
def test_corr_field_build_matches_jax(house_map, window):
    from mcmh_localization_tpu.models.corr_field import _build_field_xla
    from mcmh_localization_tpu.ops.corr_field_pallas import corr_field_pallas

    padded, ox, oy, h, w, m, lmax = _field_inputs(house_map, 12, 45, 0,
                                                  window)
    got = corr_field_build(_t(padded), _t(ox), _t(oy), h, w).numpy()
    ref_xla = np.asarray(_build_field_xla(padded, ox, oy, h, w))
    ref_pallas = np.asarray(corr_field_pallas(padded, ox, oy, h, w,
                                              interpret=True))
    # f32 sums of M log values in another order: rtol 1e-5 and an absolute
    # floor of 1e-5 * M * max|L| for cancellation
    atol = 1e-5 * m * lmax
    np.testing.assert_allclose(got, ref_xla, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, ref_pallas, rtol=1e-5, atol=atol)


# ---------------------------------------------------------------------------
# kernel 2: gather_2d (the corr_lookup index triples: test_torch_corr_field)
# ---------------------------------------------------------------------------

def test_gather_2d_bitwise_vs_jax_cpu():
    from mcmh_localization_tpu.ops.gather_pallas import gather_2d as jgather

    rng = np.random.default_rng(1)
    table = rng.normal(0, 300.0, size=(40 * 12, 40)).astype(np.float32)
    y = rng.integers(0, table.shape[0], 5000).astype(np.int32)
    x = rng.integers(0, table.shape[1], 5000).astype(np.int32)
    got = gather_2d(_t(table), _t(y), _t(x)).numpy()
    want = np.asarray(jgather(jnp.asarray(table), jnp.asarray(y),
                              jnp.asarray(x)))  # exact XLA path on CPU
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got, table[y, x])


def test_gather_2d_misaligned_ragged_view_bitwise_vs_jax_cpu():
    """gather_2d on index views one element past an aligned base, N = 4097
    (no multiple of the pairs a thread), equals the JAX package's gather on
    the same indices bitwise."""
    from mcmh_localization_tpu.ops.gather_pallas import gather_2d as jgather

    rng = np.random.default_rng(4)
    table = rng.normal(0, 300.0, size=(384, 96)).astype(np.float32)
    y = rng.integers(0, table.shape[0], 4099).astype(np.int32)
    x = rng.integers(0, table.shape[1], 4099).astype(np.int32)
    yv, xv = _t(y)[1:-1], _t(x)[1:-1]
    assert yv.storage_offset() == 1 and yv.numel() == 4097
    got = gather_2d(_t(table), yv, xv).numpy()
    want = np.asarray(jgather(jnp.asarray(table), jnp.asarray(y[1:-1]),
                              jnp.asarray(x[1:-1])))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,p", [
    (2 * 130_048, 1),         # the staged SMALL lookup; gather_2d's window
    (4 * 5000, 1),            # the free mask: FilterConfig()'s retries
    (4 * 100_000, 1),         # and the exact 100k run's
    (2 * 1500 * 360, 4),      # the range-table scorer's (cell, bin) pairs
    (2 * 1_000_000, 4),       # the BIG lookup
])
def test_gather_kernels_take_poses_per_thread_at_the_path_shapes(n, p):
    """gather.cu's kernels take the P of ops/_cuda.py::poses_per_thread:
    the largest of 4, 2, 1 leaving at least FILL_THREADS threads."""
    from mcmh_localization_tpu_torch.ops import _cuda

    assert _cuda.poses_per_thread(n) == p
    assert n // p >= _cuda.FILL_THREADS or p == 1
    assert p == 4 or n < 4 * _cuda.FILL_THREADS


def test_gather_2d_vs_tpu_kernel_interpret():
    """The TPU kernel reads through split bf16 hi/lo planes (~1e-3
    relative error, a TPU approximation): the port agrees within it."""
    from mcmh_localization_tpu.ops.gather_pallas import gather_2d as jgather

    rng = np.random.default_rng(2)
    table = rng.normal(0, 300.0, size=(256, 128)).astype(np.float32)
    y = rng.integers(0, 256, 2048).astype(np.int32)
    x = rng.integers(0, 128, 2048).astype(np.int32)
    got = gather_2d(_t(table), _t(y), _t(x)).numpy()
    want = np.asarray(jgather(jnp.asarray(table), jnp.asarray(y),
                              jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# kernels 3 and 4: rank_in_sorted / expand_sorted
# ---------------------------------------------------------------------------

def _weights(kind, n, rng):
    w = {
        "exponential": rng.exponential(size=n),
        "concentrated": np.where(rng.random(n) < 0.002, 500.0, 1e-6),
        "leading-zeros": np.concatenate([np.zeros(n // 2), np.ones(n // 2)]),
    }[kind]
    return (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("kind", ["exponential", "concentrated",
                                  "leading-zeros"])
@pytest.mark.parametrize("count", [None, 5000], ids=["full", "count_lt_out"])
def test_rank_and_expand_bitwise_vs_jax(kind, count):
    from mcmh_localization_tpu.ops.rank_pallas import (
        expand_sorted as j_expand,
        rank_in_sorted as j_rank,
    )
    from mcmh_localization_tpu.ops.resampling import _segment_bounds

    rng = np.random.default_rng(41)
    n = 16384
    particles = rng.normal(size=(n, 3)).astype(np.float32)
    w = jnp.asarray(_weights(kind, n, rng))
    cnt = None if count is None else jnp.int32(count)
    bound = np.asarray(_segment_bounds(jax.random.PRNGKey(13), w, n, cnt))
    keep = n if count is None else count     # slots < count are defined
    b = jnp.asarray(bound)
    want_idx = {
        "xla": np.asarray(j_rank(b, n, count=cnt)),
        "interpret": np.asarray(j_rank(b, n, interpret=True, count=cnt)),
    }
    want_exp = {
        "xla": np.asarray(j_expand(b, jnp.asarray(particles), n, count=cnt)),
        "interpret": np.asarray(j_expand(b, jnp.asarray(particles), n,
                                         interpret=True, count=cnt)),
    }
    got_idx = rank_in_sorted(_t(bound), n, count=count).numpy()
    got_exp = expand_sorted(_t(bound), _t(particles), n, count=count).numpy()
    for path in ("xla", "interpret"):
        np.testing.assert_array_equal(got_idx[:keep], want_idx[path][:keep],
                                      err_msg=path)
        np.testing.assert_array_equal(got_exp[:keep], want_exp[path][:keep],
                                      err_msg=path)
    # the fused expansion is the two-step take, bitwise, tail included
    np.testing.assert_array_equal(got_exp, particles[got_idx])


def test_rank_tail_repeats_last_active_slot():
    bound = torch.tensor([0, 0, 2, 5, 5, 9], dtype=torch.int32)
    idx = rank_in_sorted(bound, 10, count=4).tolist()
    assert idx == [2, 2, 3, 3, 3, 3, 3, 3, 3, 3]
    assert rank_in_sorted(bound, 10).tolist() == [2, 2, 3, 3, 3, 5, 5, 5, 5, 5]
