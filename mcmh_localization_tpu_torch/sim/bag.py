"""NPZ "bag" persistence — the recorded-run format standing in for rosbags
(a copy of ``mcmh_localization_tpu/sim/bag.py``: the same npz keys, so a bag
saved by either package loads in the other, bitwise).

The reference replayed ROS bags (`rosbag play`, test_algs.launch:40-44; the
four evaluation bags were stripped from the repo).  Our runs serialize to a
single .npz with self-describing arrays; `load_bag` also accepts paths to
directories of prior recordings.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mcmh_localization_tpu_torch.sim.simulator import Bag


def save_bag(path: str, bag: Bag) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        ranges=bag.ranges,
        angles=bag.angles,
        odom=bag.odom,
        gt=bag.gt,
        times=bag.times,
        max_range=np.float32(bag.max_range),
        meta=json.dumps(bag.meta),
    )


def load_bag(path: str) -> Bag:
    with np.load(path, allow_pickle=False) as z:
        return Bag(
            ranges=z["ranges"],
            angles=z["angles"],
            odom=z["odom"],
            gt=z["gt"],
            times=z["times"],
            max_range=float(z["max_range"]),
            meta=json.loads(str(z["meta"])),
        )
