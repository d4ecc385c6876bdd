"""online.odom_ms_per_scan: the host time of a scan's odometry messages
through ``OnlineLocalizer.on_odom`` (the eager predicts), the benchmark's
span around them summed over the window, over its scans."""


def read(run):
    n = len(run.odom_s)
    return float(run.odom_s.sum()) / n * 1e3 if n else None
