"""online.scan_p50_ms: the median of the same ``on_scan`` samples as
scan_p99_ms."""

import numpy as np


def read(run):
    return float(np.median(run.scan_s)) * 1e3 if len(run.scan_s) else None
