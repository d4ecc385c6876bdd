"""device.busy_ms_per_scan: device busy time (kernels, copies, memsets in
the profiler's trace) over the profiled stretch's scans."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return t.busy_s / t.scans * 1e3
