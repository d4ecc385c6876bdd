"""RMSE evaluation protocol, byte-compatible with the reference's outputs
(the port's own copy of the JAX package's ``eval/evaluator.py``: the same
inputs give the same bytes in both packages).

Mirrors evaluate_localization.py: per-estimate planar position error vs
ground truth plus yaw error (:55-65), final RMSE (:118), and the exact
on-disk formats (:120-136):

  results/<name>.txt        "time,error" CSV + "\\nRMSE final: X.XXXX" footer
  results/poses_<name>.txt  7-column est-vs-gt trajectory CSV
  results/summary_results.txt  append-log "<file>,<rmse>"

so the reference's plotting scripts parse our results unmodified.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class EvalResult(NamedTuple):
    times: np.ndarray       # (T,)
    errors: np.ndarray      # (T,) planar position error
    yaw_errors: np.ndarray  # (T,) |gt_yaw - est_yaw| (unwrapped, like ref :65)
    est: np.ndarray         # (T, 3)
    gt: np.ndarray          # (T, 3)
    rmse: float


def evaluate_run(times, est, gt) -> EvalResult:
    """Position / yaw error trajectories + final RMSE.

    Note the reference's yaw error is a plain ``abs(gt_yaw - est_yaw)``
    without wrapping (evaluate_localization.py:65) — kept for parity.
    """
    times = np.asarray(times, dtype=np.float64)
    est = np.asarray(est, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    errors = np.hypot(est[:, 0] - gt[:, 0], est[:, 1] - gt[:, 1])
    yaw_errors = np.abs(gt[:, 2] - est[:, 2])
    rmse = float(np.sqrt(np.mean(np.square(errors)))) if len(errors) else float("nan")
    return EvalResult(times, errors, yaw_errors, est, gt, rmse)


def save_results(result: EvalResult, name: str, results_dir: str) -> str:
    """Write the three reference-format files; returns the main results path."""
    os.makedirs(results_dir, exist_ok=True)
    name = os.path.basename(name).replace(".txt", "")
    out_path = os.path.join(results_dir, f"{name}.txt")
    poses_path = os.path.join(results_dir, f"poses_{name}.txt")
    summary_path = os.path.join(results_dir, "summary_results.txt")

    with open(out_path, "w") as f:
        f.write("time,error\n")
        for t, e in zip(result.times, result.errors):
            f.write(f"{t:.3f},{e:.4f}\n")
        f.write(f"\nRMSE final: {result.rmse:.4f}\n")

    with open(poses_path, "w") as f:
        f.write("time,est_x,est_y,est_yaw,gt_x,gt_y,gt_yaw\n")
        for t, e, g in zip(result.times, result.est, result.gt):
            f.write(
                f"{t:.3f},{e[0]:.4f},{e[1]:.4f},{e[2]:.4f},"
                f"{g[0]:.4f},{g[1]:.4f},{g[2]:.4f}\n"
            )

    with open(summary_path, "a") as f:
        f.write(f"{os.path.basename(out_path)},{result.rmse:.4f}\n")
    return out_path


def parse_results_file(path: str):
    """Read back a results/<name>.txt (ours or the reference's): returns
    (times, errors, rmse)."""
    times, errors, rmse = [], [], float("nan")
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("RMSE final:"):
                rmse = float(line.split(":")[1])
            elif "," in line and not line.startswith("time"):
                t, e = line.split(",")
                times.append(float(t))
                errors.append(float(e))
    return np.asarray(times), np.asarray(errors), rmse


def parse_poses_file(path: str):
    """Read back a poses_<name>.txt: (times, est (T,3), gt (T,3))."""
    data = np.genfromtxt(path, delimiter=",", skip_header=1)
    if data.ndim == 1:
        data = data[None, :]
    return data[:, 0], data[:, 1:4], data[:, 4:7]
