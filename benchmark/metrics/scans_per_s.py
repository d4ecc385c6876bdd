"""scans_per_s: scans whose pose reached the host inside the window, each
with its odometry messages, over the window's wall time (host clock)."""


def read(run):
    return run.scans / run.window_s if run.scans else None
