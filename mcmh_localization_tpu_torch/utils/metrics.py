"""Per-step observability: JSONL metrics logging (port of
``mcmh_localization_tpu/utils/metrics.py``, the same JSONL schema).

The reference's only observability is the results-file protocol plus ad-hoc
loginfo lines (SURVEY.md §5).  Here every step's StepInfo (ESS, MH
acceptance rate, active particle count, augmented-MCL internals, pose
estimate) streams to JSONL for offline analysis; `summarize` aggregates a
run.  A StepInfo's fields may live on the card: each is copied to the host
once (``utils/host.py``) before it is formatted.
"""

from __future__ import annotations

import json
import os
from typing import IO

import numpy as np

from mcmh_localization_tpu_torch.utils.host import to_numpy

_FIELDS = ("ess", "accept_rate", "count", "p_random", "w_slow", "w_fast",
           "anchor_mass")


def _host_info(info) -> dict:
    """The estimate's mean and the scalar fields of a (stacked) StepInfo as
    host arrays."""
    out = {f: to_numpy(getattr(info, f)) for f in _FIELDS}
    out["est"] = to_numpy(info.estimate.mean)
    return out


class MetricsLogger:
    """Append-only JSONL writer for StepInfo records."""

    def __init__(self, path: str):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self._f: IO = open(path, "a")
        self._step = 0

    def log_step(self, info, wall_ms: float | None = None, extra: dict | None = None):
        h = _host_info(info)
        rec = {
            "step": self._step,
            "est": [round(float(v), 6) for v in h["est"]],
            "ess": round(float(h["ess"]), 3),
            "accept_rate": round(float(h["accept_rate"]), 4),
            "count": int(h["count"]),
            "p_random": round(float(h["p_random"]), 6),
            "w_slow": float(h["w_slow"]),
            "w_fast": float(h["w_fast"]),
            "anchor_mass": round(float(h["anchor_mass"]), 4),
        }
        if wall_ms is not None:
            rec["ms"] = round(wall_ms, 3)
        if extra:
            rec.update(extra)
        self._f.write(json.dumps(rec) + "\n")
        self._step += 1

    def log_run(self, infos, times=None):
        """Log a stacked StepInfo (from a ``run``) in one call."""
        h = _host_info(infos)
        times = None if times is None else np.asarray(times)
        for i in range(len(h["ess"])):
            rec = {
                "step": self._step,
                "est": [round(float(v), 6) for v in h["est"][i]],
                "ess": round(float(h["ess"][i]), 3),
                "accept_rate": round(float(h["accept_rate"][i]), 4),
                "count": int(h["count"][i]),
                "p_random": round(float(h["p_random"][i]), 6),
                "anchor_mass": round(float(h["anchor_mass"][i]), 4),
            }
            if times is not None:
                rec["t"] = float(times[i])
            self._f.write(json.dumps(rec) + "\n")
            self._step += 1
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def summarize(path: str) -> dict:
    recs = read_metrics(path)
    if not recs:
        return {}
    out = {"steps": len(recs)}
    for k in ("ess", "accept_rate", "count", "p_random"):
        vals = [r[k] for r in recs if k in r]
        if vals:
            out[f"{k}_mean"] = float(np.mean(vals))
            out[f"{k}_min"] = float(np.min(vals))
            out[f"{k}_max"] = float(np.max(vals))
    if "ms" in recs[0]:
        out["ms_mean"] = float(np.mean([r["ms"] for r in recs]))
    return out
