"""device.idle_share: 1 - device busy time (kernels, copies, memsets in the
profiler's trace) over the host-clock wall time of the profiled stretch,
in %."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
