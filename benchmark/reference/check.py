"""The comparison that decides ``correct``: each sampled scan of the window
recomputed by the plain reference (``filter.py``) from the state the
program held before the scan, and the program's outputs of that scan held
against it, number by number, each against its limit from
``limits/<config>.json``.

Numbers, each the largest over the sampled scans:

* ``pose_gap_m``, ``yaw_gap_rad``: the pose that ``on_scan`` returned to
  the host against the reference's estimate;
* ``cov_gap``: the returned covariance (x, y, yaw), the Frobenius norm of
  the difference over the reference's;
* ``ess_gap``: the effective sample size of the weights after the
  Metropolis-Hastings choice, relative;
* ``wfast_gap``: the fast augmented-MCL average the state holds after the
  scan, relative: the mean per-beam likelihood the scorer gave the
  proposed set;
* ``count_gap``: the particle count after the KLD resampling, relative;
* ``accept_gap``: the Metropolis-Hastings acceptance rate, absolute;
* ``set_mean_gap_m``, ``set_cov_gap``, ``set_ess_gap``: the active set
  the state holds after the scan (resampled, with its injected poses, or
  carried past a closed ESS gate, and past the staged hand-off), its
  weighted mean, its weighted covariance (Frobenius, relative) and the
  effective sample size of its weights (relative), against the
  reference's set;
* ``handoff_mismatch``: scans after which the program's staged capacity
  (BIG or SMALL) is not the one that the hand-off policy gives on the
  reference's count, injection share and mode mass (exact);
* ``draws_mismatch``: scans after which the program's generator state is
  not the reference's: the program drew otherwise than the reference's
  documented layout (``filter.py``), so no other number of that scan can
  be trusted (exact).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import filter as ref

COV_SLOTS = (0, 1, 5, 6, 7, 11, 30, 31, 35)   # the 3x3 in ROS's 6x6
NUMBERS = ("pose_gap_m", "yaw_gap_rad", "cov_gap", "ess_gap", "wfast_gap",
           "count_gap", "accept_gap", "set_mean_gap_m", "set_cov_gap",
           "set_ess_gap", "handoff_mismatch", "draws_mismatch")


class Record(NamedTuple):
    """One sampled scan: the program's state before it, the scan's inputs,
    and what the program gave."""

    scan: int
    program: str                 # "big", "small" or "single"
    particles: torch.Tensor      # (n_max, 3) before the scan's odometry
    weights: torch.Tensor
    count: int
    w_slow: float
    w_fast: float
    anchor: torch.Tensor         # (3,)
    streak: int
    gen_state: torch.Tensor      # the state of the program's generator
    last_odom: np.ndarray
    odom_msgs: list
    # the program's outputs
    pose: tuple                  # (x, y, yaw) returned on the host
    cov: np.ndarray              # (3, 3) returned on the host
    ess: float
    accept_rate: float
    out_count: int
    p_random: float
    anchor_mass: float
    w_fast_after: float          # the state's, after the scan
    small_after: bool | None     # the staged program after the scan
    set_particles: torch.Tensor  # (count, 3) the active set after the scan
    set_weights: torch.Tensor    # (count,) its weights
    gen_after: torch.Tensor      # the generator's state after the scan


def _moments(particles, weights):
    p = particles.double()
    return ref.estimate(p, weights.double(),
                        torch.ones(p.shape[0], dtype=torch.bool, device=p.device))


def _ess(weights):
    w = weights.double()
    return float(w.sum() ** 2 / torch.clamp((w * w).sum(), min=1e-300))


def gaps(rec: Record, res: ref.Result, conf: dict) -> dict:
    """The numbers of one scan: the program's outputs against ``res``."""
    mean = res.mean.double().cpu().numpy()
    cov = res.cov.double().cpu().numpy()
    dev = res.particles.device
    pm, pc = _moments(rec.set_particles.to(dev), rec.set_weights.to(dev))
    rm, rc = _moments(res.particles, res.weights)
    out = {
        "pose_gap_m": math.hypot(rec.pose[0] - mean[0], rec.pose[1] - mean[1]),
        "yaw_gap_rad": abs(float(ref.wrap(torch.tensor(rec.pose[2] - mean[2],
                                                       dtype=torch.float64)))),
        "cov_gap": float(np.linalg.norm(rec.cov - cov)
                         / max(np.linalg.norm(cov), 1e-30)),
        "ess_gap": abs(rec.ess - res.ess) / max(res.ess, 1e-30),
        "wfast_gap": abs(rec.w_fast_after - res.w_fast)
        / max(abs(res.w_fast), 1e-30),
        "count_gap": abs(rec.out_count - res.count) / max(res.count, 1),
        "accept_gap": abs(rec.accept_rate - res.accept_rate),
        "set_mean_gap_m": float(torch.hypot(pm[0] - rm[0], pm[1] - rm[1])),
        "set_cov_gap": float(torch.linalg.norm(pc - rc)
                             / torch.clamp(torch.linalg.norm(rc), min=1e-30)),
        "set_ess_gap": abs(_ess(rec.set_weights) - _ess(res.weights))
        / max(_ess(res.weights), 1e-30),
        "handoff_mismatch": 0.0,
        "draws_mismatch": float(not torch.equal(rec.gen_after.cpu(),
                                                res.gen_state.cpu())),
    }
    if rec.small_after is not None:
        out["handoff_mismatch"] = float(handoff(rec, res, conf)
                                        != rec.small_after)
    return out


def handoff(rec: Record, res: ref.Result, conf: dict) -> bool:
    """The staged program after the scan by the reference: SMALL or not."""
    cap = ref.programs(conf)["small"].n_max
    return ref.next_stage(rec.program == "small", res.count, res.p_random,
                          res.anchor_mass, cap)


def control_record(rec: Record, res: ref.Result, conf: dict) -> Record:
    """``rec`` with the program's outputs replaced by a lower-precision
    reference's ``res``: the control, put in the program's place."""
    mean = res.mean.double().cpu().numpy()
    return rec._replace(
        pose=(float(mean[0]), float(mean[1]), float(mean[2])),
        cov=res.cov.double().cpu().numpy(), ess=res.ess,
        accept_rate=res.accept_rate, out_count=res.count,
        p_random=res.p_random, anchor_mass=res.anchor_mass,
        w_fast_after=res.w_fast,
        small_after=(None if rec.small_after is None
                     else handoff(rec, res, conf)),
        set_particles=res.particles, set_weights=res.weights,
        gen_after=res.gen_state)


def recompute(rec: Record, conf: dict, m: ref.Map, ranges, angles,
              dtype=torch.float32) -> ref.Result:
    """The reference's scan ``rec`` on the device the records live on."""
    dev = rec.particles.device
    gen = torch.Generator(device=dev)
    gen.set_state(rec.gen_state)
    prog = ref.programs(conf)[rec.program]
    state = ref.State(rec.particles, rec.weights, rec.count, rec.w_slow,
                      rec.w_fast, rec.anchor, rec.streak)
    return ref.scan(state, rec.odom_msgs, rec.last_odom, ranges, angles, m,
                    prog, gen, dtype)


def worst(rows: list) -> dict:
    """Each number's largest value over the scans (nan counts as
    infinitely far)."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in rows]
        out[k] = max((math.inf if not math.isfinite(v) else v) for v in vals) \
            if vals else math.inf
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [value, limit]}) over the compared numbers."""
    shown = {}
    ok = True
    for name, spec in limits["numbers"].items():
        if not spec.get("compared", True):
            continue
        v = numbers[name]
        shown[name] = [v, spec["limit"]]
        ok = ok and v <= spec["limit"]
    return ok, shown
