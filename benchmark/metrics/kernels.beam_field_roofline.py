"""kernels.beam_field_roofline: the beam score field's builds of a scan at
the configuration's shapes (the fine field: the bin-LUT matrix of the
window's theta bins, then the LUT field over the window read in place at
its device-held origin; the coarse field: the optimistic LUT, the offset
row and its rolled matrix, then the LUT field over the block centres), on
scans of the cell's own traffic with the window on the tour's pose,
called through the port's public ``models/range_table.py`` and
``ops/beam_field.py`` functions and timed by CUDA events
(``kernels.field_build_roofline``'s ``device_ms``); its share of the least
time the card could take for that work (``counts/beam_field.py`` against
``counts/peaks.py``), in %.  The share reads the same work whatever
kernels implement the builds.  Nothing to read without the beam score
field on the card."""

import math
import sys

import numpy as np
import torch

from benchmark import world
from benchmark.counts import beam_field, peaks

SCANS = 8      # scans of the traffic, spread over the window's

_timing = world.metric_reader("kernels.field_build_roofline")


def read(run):
    tables = getattr(run.loc.model, "log_field", None)
    if not run.cuda or getattr(tables, "qtc", None) is None:
        return None
    from mcmh_localization_tpu_torch.models.range_table import (
        beam_mixture,
        coarse_lut_inputs,
        field_origin,
        fine_lut_matrix,
    )
    from mcmh_localization_tpu_torch.ops.beam_field import lut_field, lut_field_at

    cfg, gm, dev = run.loc.config, run.loc.grid_map, run.device
    k, h, w = tables.qt.shape
    nq = tables.dvals.shape[0]
    kc, (_, hc, wc) = cfg.corr_coarse_n_theta, tables.qtc.shape
    win = min(cfg.corr_window_cells, h, w)
    tw = bool(cfg.corr_theta_window_bins)
    nbins = min(cfg.corr_theta_window_bins, k) if tw else k
    mix = beam_mixture(cfg)
    m = run.traffic.n_beams
    angles = (torch.linspace(-math.pi, math.pi, m, dtype=torch.float32,
                             device=dev) if run.traffic.angles is None
              else torch.as_tensor(run.traffic.angles, device=dev))
    fine_ms = coarse_ms = bound = 0.0
    for t in np.linspace(0, len(run.traffic.ranges) - 1, SCANS).astype(int):
        r = torch.from_numpy(run.traffic.ranges[t]).to(dev)
        valid = torch.isfinite(r) & (r < cfg.max_range)
        z = (torch.where(valid, r, 0.0)[:, None] - tables.dvals[None, :]) \
            / mix.sigma
        lp = torch.log(torch.clamp(mix.z_hit * mix.hit_norm
                                   * torch.exp(-0.5 * z * z) + mix.z_floor,
                                   min=1e-6))
        lp = torch.where(valid[:, None], lp, 0.0)
        x, y, th = (float(v) for v in run.traffic.gt[t])
        kmid = int((th + math.pi) * k / (2 * math.pi)) % k
        origin = field_origin(
            (int((y - gm.origin[1]) / gm.res) - win // 2,
             int((x - gm.origin[0]) / gm.res) - win // 2,
             (kmid - nbins // 2) % k if tw else 0), h, w, win, tw, dev)
        kstart = origin[2] if tw else 0
        fine_ms += _timing.device_ms(lambda: lut_field_at(
            tables.qt, fine_lut_matrix(lp, angles, k, kstart, nbins, tw),
            origin, win))
        coarse_ms += _timing.device_ms(lambda: lut_field(
            *coarse_lut_inputs(lp, angles, tables, cfg, k)))
        bound += peaks.bound_ms(
            beam_field.ops(nbins, win, kc, hc, wc, int(valid.sum()), nq),
            beam_field.nbytes(k, nbins, win, kc, hc, wc, m, nq))[0]
    share = 100.0 * bound / (fine_ms + coarse_ms)
    print(f"beam field builds: fine {fine_ms / SCANS:.4f} + coarse "
          f"{coarse_ms / SCANS:.4f} ms a scan against a bound of "
          f"{bound / SCANS:.5f} ms ({share:.2f}%) on {_timing._power_line()}",
          file=sys.stderr)
    return share
