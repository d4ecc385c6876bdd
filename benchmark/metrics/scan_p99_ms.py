"""scan_p99_ms: the 99th percentile of ``on_scan``'s call-to-return time on
the host over every scan of the window (numpy's linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile(run.scan_s, 99)) * 1e3 if len(run.scan_s) else None
