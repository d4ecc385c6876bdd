"""staged.big_scan_share: the share of the window's scans after which the
staged localizer's state holds the BIG program's capacity, in %: the
hand-off's decision scan by scan (nothing to read without a staged
configuration)."""


def read(run):
    if run.small_cap is None or not run.scans:
        return None
    return 100.0 * float((run.capacities == run.n_big).mean())
