"""The benchmark's CPU tests: the repository root on the path, and the
small sizes at which a whole run of a cell fits a CPU test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# an 8 x 8 m house at 0.1 m: walls, a door, two pillars
SMALL_MAP = {
    "cells": 80, "resolution": 0.1, "origin": [-4.0, -4.0], "unknown": -1,
    "rectangles": [
        ["free", 4, 76, 4, 76], ["occupied", 4, 5, 4, 76],
        ["occupied", 75, 76, 4, 76], ["occupied", 4, 76, 4, 5],
        ["occupied", 4, 76, 75, 76], ["occupied", 4, 50, 52, 53],
        ["free", 30, 38, 52, 53], ["occupied", 20, 24, 20, 25],
        ["occupied", 60, 63, 30, 34]]}


def small(cell: str) -> dict:
    """Overrides that cut ``cell`` to CPU size: the small map, a few
    thousand particles (a 32-cell, 16-bin window under staging), and few
    scans."""
    ov = {"map": SMALL_MAP, "traffic": {"settle_scans": 8},
          "run": {"max_scans_per_s": 200, "profiled_scans": 6,
                  "min_window_scans": 16,
                  "check": {"scans": 6, "min_scans_per_s": 8, "kidnaps": 1,
                            "after_kidnap": 3}}}
    if cell.startswith("house_staged_1m"):
        ov["filter"] = {"num_particles": 4096, "min_particles": 1024,
                        "max_particles": 4096, "corr_window_cells": 32,
                        "corr_theta_window_bins": 16}
    else:
        ov["filter"] = {"num_particles": 300, "min_particles": 100,
                        "max_particles": 1000}
    if cell.endswith("kidnap"):
        ov["traffic"].update(kidnap_every=6, kidnap_min_dist_m=2.0)
    return ov
