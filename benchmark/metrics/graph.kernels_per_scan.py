"""graph.kernels_per_scan: device kernels in the profiled stretch (the
profiler's trace, the captured graphs' kernels among them), over its
scans."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return t.kernels / t.scans
