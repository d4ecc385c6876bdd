"""Plain PyTorch reference of one scan of the localizer: the odometry
messages' motion proposals, then the scan's correction (the scorer, the
Metropolis-Hastings choice, the augmented-MCL averages, the window anchor,
the pose estimate, the ESS gate, the KLD resampling with the augmented-MCL
injection, and the staged hand-off).

It follows the semantics of the upstream node (amcmh_localizer.py:294-338,
379-408, 496-527; parallel_utils.py:85-149, 238-330, 529-591) as the
configuration file states them, and imports nothing of the program under
test.  It recomputes everything from the benchmark's inputs (map, scans,
odometry) and from the state the program held before the scan: the
particles, weights, count, averages, anchor and the state of its random
generator.  The random draws are replayed from that generator in the
program's documented order, so the comparison is draw for draw: predict,
the motion normals, (N, 3), or (retries, N, 3) under "reject"; correct,
the MH uniforms (N,), then, whether or not the resampling gate opens, the
KLD offset (), its jitter normals (the first prefix of
max(131072, 1.25 min_particles) rows, then the rest), the injection's
pool cells (min(N, 65536),), in-cell jitter (N, 2) and headings (N,).
That layout is part of the benchmark's contract: a program that draws
otherwise cannot be followed draw for draw, and the comparison reports it
apart (``check.py``'s ``draws_mismatch``: the generator's state after the
scan differs from the reference's).  Sums run in plain PyTorch order, not
the kernels' order.

``dtype`` is the precision of every floating computation: float32 for the
reference, bfloat16 for the lower-precision control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

BLIND = -50.0        # no valid beam (parallel_utils.py:147)
INVALID = -100.0     # a pose on a non-free cell, motion_validity="score"
LOG_FLOOR = 1e-6     # parallel_utils.py:141
KLD_JITTER = (0.001, 0.001, 0.02)   # parallel_utils.py:552
KLD_STAGE1 = 131072  # the escalating stop rule's first prefix
POOL = 65536         # injected poses come from a tiled pool of free cells
AUTO_CORR_MIN_STATE = 8192


def wrap(a):
    return (a + math.pi) % (2.0 * math.pi) - math.pi


class Program(NamedTuple):
    """One program of the configuration, as the reference reads it."""

    cfg: dict            # the filter keys
    n_max: int
    scorer: str          # "corr" or "exact"
    aggregation: str     # "mean" or "sum"
    window: int          # corr window cells (0: the full map)
    theta_bins: int      # corr theta window bins (0: all)
    ess_threshold: float
    refill: bool         # injection sized by the capacity (BIG)


def programs(conf: dict) -> dict:
    """{"big": Program, "small": Program} of a staged configuration, or
    {"single": Program}: the staged BIG program scores the whole map at
    every bin, sums the beams and refills its injection to capacity; SMALL
    holds 1.3 x min_particles rounded up to 1024 slots, the window with no
    coarse fallback, and its ESS gate."""
    f = conf["filter"]
    n_max = f["max_particles"]

    def scorer(n):
        impl = f.get("likelihood_impl", "auto")
        if impl == "auto":
            return "corr" if n >= AUTO_CORR_MIN_STATE else "exact"
        return {"corr": "corr", "jnp": "exact"}[impl]

    agg = f.get("score_aggregation", "mean")
    ess = f.get("resample_ess_threshold", 1.0)
    if not conf.get("staged"):
        if f.get("corr_window_cells") and scorer(n_max) == "corr":
            raise NotImplementedError("the single corr program's coarse "
                                      "fallback has no reference yet")
        return {"single": Program(f, n_max, scorer(n_max), agg, 0, 0, ess,
                                  False)}
    staged = conf["staged"]
    cap = -(-int(1.3 * f["min_particles"]) // 1024) * 1024
    cap = min(max(cap, 1024), n_max)
    return {
        "big": Program(f, n_max, scorer(n_max), "sum", 0, 0, ess, True),
        "small": Program(f, cap, scorer(n_max), agg,
                         f.get("corr_window_cells", 0),
                         f.get("corr_theta_window_bins", 0),
                         staged.get("tracking_ess_threshold", ess), False),
    }


class Map(NamedTuple):
    occ: torch.Tensor        # (H, W) int8
    log_field: torch.Tensor  # (H, W)
    free_xy: torch.Tensor    # (F, 2) free-cell centres, row-major order
    res: float
    origin: tuple


def make_map(occ: np.ndarray, dist: np.ndarray, res: float, origin,
             f: dict, device, dtype=torch.float32) -> Map:
    """The likelihood field ``log(max(z_hit N(d; sigma_hit) + z_rand /
    max_range, 1e-6))`` (no hit term past max_range) and the free cells."""
    d = torch.from_numpy(dist).to(device=device, dtype=torch.float64)
    s = f["sigma_hit"]
    p_hit = torch.exp(-0.5 * d * d / (s * s)) / math.sqrt(2 * math.pi * s * s)
    p_hit = torch.where(d <= f["max_range"], p_hit, 0.0)
    p = f["z_hit"] * p_hit + f["z_rand"] / f["max_range"]
    log_field = torch.log(torch.clamp(p, min=LOG_FLOOR)).to(dtype)
    rows, cols = np.nonzero(occ == 0)
    free = np.stack([origin[0] + (cols + 0.5) * res,
                     origin[1] + (rows + 0.5) * res], axis=1)
    o32 = np.float32(origin[0]), np.float32(origin[1])
    return Map(torch.from_numpy(occ).to(device), log_field,
               torch.from_numpy(free.astype(np.float32)).to(device),
               float(np.float32(res)), (float(o32[0]), float(o32[1])))


class State(NamedTuple):
    particles: torch.Tensor
    weights: torch.Tensor
    count: int
    w_slow: float
    w_fast: float
    anchor: torch.Tensor
    streak: int


class Result(NamedTuple):
    mean: torch.Tensor     # (3,) estimate
    cov: torch.Tensor      # (3, 3)
    ess: float
    accept_rate: float
    count: int             # after resampling
    p_random: float
    w_slow: float
    w_fast: float
    anchor_mass: float
    particles: torch.Tensor  # (count, 3) the active set after the scan
    weights: torch.Tensor    # (count,) its weights
    gen_state: torch.Tensor  # the generator's state after the scan


def motion(prev_odom: np.ndarray, curr_odom: np.ndarray) -> torch.Tensor:
    """(rot1, trans, rot2) between two float32 odometry poses, on the host
    in float32 (amcmh_localizer.py:410-421; rot1 not wrapped)."""
    a = torch.from_numpy(np.asarray(prev_odom, dtype=np.float32))
    b = torch.from_numpy(np.asarray(curr_odom, dtype=np.float32))
    dx, dy = b[0] - a[0], b[1] - a[1]
    rot1 = torch.atan2(dy, dx) - a[2]
    return torch.stack([rot1, torch.hypot(dx, dy), wrap(b[2] - a[2]) - rot1])


def _stds(delta, alpha):
    r1, t, r2 = delta.abs()
    a1, a2, a3, a4 = alpha
    return a1 * r1 + a2 * t, a3 * t + a4 * (r1 + r2), a1 * r2 + a2 * t


def cell_of(x, origin, res):
    """int32 cell by ``(x - origin) / res`` truncated, in IEEE division (a
    CUDA division by a python scalar multiplies by its reciprocal)."""
    return ((x - origin) / torch.full((), res, device=x.device)).to(torch.int32)


def is_free(m: Map, x, y):
    h, w = m.occ.shape
    mx, my = cell_of(x, m.origin[0], m.res), cell_of(y, m.origin[1], m.res)
    inb = (mx >= 0) & (mx < w) & (my >= 0) & (my < h)
    return inb & (m.occ[my.clamp(0, h - 1).long(), mx.clamp(0, w - 1).long()]
                  == 0)


def predict(particles, delta, f, m: Map, gen, dtype):
    """The noisy odometry proposal of every slot: the raw draw under
    motion_validity="score", else the first of ``motion_retries`` draws
    on a free cell (the old pose when none is)."""
    n = particles.shape[0]
    retries = 0 if f.get("motion_validity", "reject") == "score" \
        else f.get("motion_retries", 4)
    shape = (n, 3) if retries == 0 else (retries, n, 3)
    z = torch.randn(shape, generator=gen, device=particles.device).to(dtype)
    d = delta.to(particles.device, dtype)
    s1, st, s2 = _stds(d, (f["alpha1"], f["alpha2"], f["alpha3"], f["alpha4"]))
    r1 = d[0] + z[..., 0] * s1
    tr = d[1] + z[..., 1] * st
    r2 = d[2] + z[..., 2] * s2
    x, y, th = particles.unbind(1)
    head = th + r1
    cand = torch.stack([x + tr * torch.cos(head), y + tr * torch.sin(head),
                        wrap(head + r2)], dim=-1)
    if retries == 0:
        return cand
    ok = is_free(m, cand[..., 0].float(), cand[..., 1].float())
    first = ok.to(torch.uint8).argmax(dim=0)
    picked = cand[first, torch.arange(n, device=cand.device)]
    return torch.where(ok.any(dim=0)[:, None], picked, particles)


def advance(anchor, delta):
    th1 = anchor[2] + delta[0]
    return torch.stack([anchor[0] + delta[1] * torch.cos(th1),
                        anchor[1] + delta[1] * torch.sin(th1),
                        wrap(th1 + delta[2])])


def _beams(ranges, angles, f, dtype):
    valid = torch.isfinite(ranges) & (ranges < f["max_range"])
    r = torch.where(valid, ranges, 0.0)
    return (r * torch.cos(angles)).to(dtype), (r * torch.sin(angles)).to(dtype), valid


def corr_scorer(ranges, angles, m: Map, prog: Program, origin3, dtype):
    """Correlation-field scores: the field ``F[k, y, x]``, the summed log
    field at every valid beam's endpoint from cell (y, x) at the centre
    heading of theta bin k (endpoint offsets truncated to cells, off-map
    endpoints add 0), built once a scan; then one read per pose.  Occupied
    or unknown cells score INVALID per beam under motion_validity="score",
    poses off the map INVALID, poses in the map but outside the window
    BLIND.  Returns the scorer of (N, 3) poses."""
    f = prog.cfg
    k_all = f.get("corr_n_theta", 120)
    h, w = m.occ.shape
    dev = ranges.device
    inv_res = float(np.float32(1.0) / np.float32(m.res))
    u, v, valid = _beams(ranges, angles, f, torch.float32)
    n_valid = int(valid.sum())
    cnt = max(n_valid, 1)
    pad = int(-(-f["max_range"] // m.res)) + 2
    if prog.window:
        oy0, ox0, kstart = (int(x) for x in origin3)
        fh = fw = prog.window
        nbins = prog.theta_bins or k_all
    else:
        oy0 = ox0 = kstart = 0
        fh, fw, nbins = h, w, k_all
    thetas = ((kstart + torch.arange(nbins, dtype=torch.float32, device=dev)
               + 0.5) * (2.0 * math.pi / k_all) - math.pi)
    c, s = torch.cos(thetas)[:, None], torch.sin(thetas)[:, None]
    ox = ((c * u - s * v) * inv_res).to(torch.int64)
    oy = ((s * u + c * v) * inv_res).to(torch.int64)
    padded = torch.nn.functional.pad(m.log_field, (pad, pad, pad, pad))
    wp = padded.shape[1]
    flat = padded.reshape(-1)
    base = ((oy0 + pad + torch.arange(fh, device=dev))[:, None] * wp
            + (ox0 + pad + torch.arange(fw, device=dev))[None, :])
    field = torch.zeros((nbins, fh, fw), dtype=dtype, device=dev)
    for j in torch.nonzero(valid).flatten().tolist():
        field += flat[base[None] + (oy[:, j] * wp + ox[:, j])[:, None, None]]
    if f.get("motion_validity") == "score":
        occ = m.occ[oy0:oy0 + fh, ox0:ox0 + fw]
        field = field + torch.where(occ == 0, 0.0, INVALID * cnt).to(dtype)
    pi32 = float(np.float32(np.pi))
    tscale = float(np.float32(k_all / (2 * math.pi)))

    def score(poses):
        px, py, pth = poses.float().unbind(1)
        mx = ((px - m.origin[0]) * inv_res).to(torch.int32)
        my = ((py - m.origin[1]) * inv_res).to(torch.int32)
        k_rel = (((pth + pi32) * tscale).to(torch.int32) % k_all - kstart) % k_all
        mxw, myw = mx - ox0, my - oy0
        covered = (k_rel < nbins) & (mxw >= 0) & (mxw < fw) & (myw >= 0) \
            & (myw < fh)
        in_map = (mx >= 0) & (mx < w) & (my >= 0) & (my < h)
        total = field[k_rel.clamp(0, nbins - 1).long(),
                      myw.clamp(0, fh - 1).long(), mxw.clamp(0, fw - 1).long()]
        total = torch.where(in_map & covered, total, 0.0)
        out = total if prog.aggregation == "sum" else total / cnt
        out = torch.where(in_map & ~covered, BLIND, out)
        if f.get("motion_validity") == "score":
            out = torch.where(in_map, out, INVALID * cnt
                              if prog.aggregation == "sum" else INVALID)
        if n_valid == 0:
            out = torch.full_like(out, BLIND)
        return out.to(dtype)

    return score


def exact_scorer(ranges, angles, m: Map, prog: Program, dtype):
    """Likelihood-field scores beam by beam (parallel_utils.py:85-149):
    each valid beam's endpoint cell by ``(l - origin) / res`` truncated,
    off-map endpoints add 0, the mean over the valid beams.  Returns the
    scorer of (N, 3) poses."""
    f = prog.cfg
    if f.get("motion_validity") == "score":
        raise NotImplementedError("the exact scorer's validity wrap")
    u, v, valid = _beams(ranges, angles, f, dtype)
    h, w = m.occ.shape
    return lambda poses: _exact(poses.to(dtype), u, v, valid, m, prog, h, w)


def _exact(p, u, v, valid, m, prog, h, w):
    c, s = torch.cos(p[:, 2:3]), torch.sin(p[:, 2:3])
    lx = p[:, 0:1] + c * u[valid] - s * v[valid]
    ly = p[:, 1:2] + s * u[valid] + c * v[valid]
    mx = cell_of(lx.float(), m.origin[0], m.res)
    my = cell_of(ly.float(), m.origin[1], m.res)
    in_map = (mx >= 0) & (mx < w) & (my >= 0) & (my < h)
    vals = m.log_field[my.clamp(0, h - 1).long(), mx.clamp(0, w - 1).long()]
    total = torch.where(in_map, vals, 0.0).sum(dim=1)
    n_valid = int(valid.sum())
    if n_valid == 0:
        return torch.full_like(total, BLIND)
    return total if prog.aggregation == "sum" else total / n_valid


def softmax(scores, mask):
    s = torch.where(mask, scores, -torch.inf)
    e = torch.where(mask, torch.exp(s - s.max()), 0.0)
    return e / e.sum()


def motion_density(a, b, delta, alpha):
    """p(b | a, delta) per pose pair, normalised to sum 1."""
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    t = torch.sqrt(dx * dx + dy * dy)
    r1 = wrap(torch.atan2(dy, dx) - a[:, 2])
    r2 = wrap(b[:, 2] - a[:, 2] - r1)
    s1, st, s2 = (torch.clamp(x, min=1e-9) for x in _stds(delta, alpha))

    def g(x, sd):
        return torch.exp(-0.5 * (x / sd) ** 2) / torch.sqrt(2 * math.pi * sd * sd)

    p = g(wrap(delta[0] - r1), s1) * g(delta[1] - t, st) \
        * g(wrap(delta[2] - r2), s2)
    total = p.sum()
    return p / total if float(total) > 0 else p


def _near(particles, pose, rxy, rth):
    dx, dy = particles[:, 0] - pose[0], particles[:, 1] - pose[1]
    return (dx * dx + dy * dy <= rxy * rxy) & \
        (wrap(particles[:, 2] - pose[2]).abs() <= rth)


def estimate(particles, weights, mask):
    """Weighted mean (circular in theta) and the aweights covariance."""
    w = torch.where(mask, weights, 0.0)
    w = w / torch.clamp(w.sum(), min=1e-30)
    mxy = (particles[:, :2] * w[:, None]).sum(0)
    th = torch.atan2((torch.sin(particles[:, 2]) * w).sum(),
                     (torch.cos(particles[:, 2]) * w).sum())
    res = torch.stack([particles[:, 0] - mxy[0], particles[:, 1] - mxy[1],
                       wrap(particles[:, 2] - th)])
    res = torch.where(mask[None], res, 0.0)
    cov = (res * w) @ res.T / torch.clamp(1.0 - (w * w).sum(), min=1e-12)
    return torch.cat([mxy, th[None]]), cov


def kld_resample(particles, weights, count, r, noise, tail_noise, f, n_max):
    """KLD-adaptive systematic resampling (Fox 2003): ``(samples, kept)``.
    Systematic draws at offset ``r`` over the first ``count`` of ``n_max``
    output slots (later slots repeat the last), each with its jitter
    normal, bins of (xy, xy, theta) size, and ``kept`` the first sample
    index past ``min_particles`` beyond the Wilson-Hilferty bound of the
    bins so far (the whole capacity when there is none).  The prefix of
    KLD_STAGE1 draws decides first; the rest are drawn only when it finds
    no stop, and the samples past the prefix are zero when it did."""
    dev = particles.device
    c = torch.cumsum(weights.double(), 0)
    c = c / torch.clamp(c[-1], min=1e-30)
    bound = torch.clamp(torch.ceil(c * count - float(r)), 0, n_max)
    bound = torch.cummax(bound, 0).values
    jit = torch.tensor(KLD_JITTER, device=dev, dtype=particles.dtype)
    mn = f["min_particles"]

    def draws(rows, z):
        slot = torch.minimum(torch.arange(rows, device=dev, dtype=torch.float64),
                             torch.tensor(float(min(count, n_max) - 1),
                                          device=dev, dtype=torch.float64))
        idx = torch.searchsorted(bound, slot, right=True).clamp(
            max=particles.shape[0] - 1)
        return particles[idx] + z.to(particles.dtype) * jit

    def first_stop(sub):
        bxy = torch.full((), f["kld_bin_size_xy"], device=dev)
        bth = torch.full((), f["kld_bin_size_theta"], device=dev)
        bx = (sub[:, 0].float() / bxy).to(torch.int64)
        by = (sub[:, 1].float() / bxy).to(torch.int64)
        bt = (sub[:, 2].float() / bth).to(torch.int64)
        key = torch.stack([bx, by, bt], 1)
        _, inv = torch.unique(key, dim=0, return_inverse=True)
        pos = torch.arange(sub.shape[0], device=dev)
        first = torch.full((int(inv.max()) + 1,), sub.shape[0], device=dev,
                           dtype=torch.int64).scatter_reduce(
            0, inv, pos, reduce="amin")
        k = torch.cumsum(first[inv] == pos, 0).double()
        km1 = torch.clamp(k - 1, min=1.0)
        t = 1 - 2 / (9 * km1) + torch.sqrt(2 / (9 * km1)) * f["kld_z"]
        need = km1 * t ** 3 / (2 * f["kld_epsilon"])
        stop = (k > 1) & (pos >= mn) & (pos > need)
        return int(torch.nonzero(stop)[0]) if bool(stop.any()) else None

    if mn >= n_max:
        return draws(n_max, noise), n_max
    if tail_noise is not None:
        w1 = noise.shape[0]
        head = draws(w1, noise)
        s = first_stop(head)
        if s is not None:
            pad = torch.zeros((n_max - w1, 3), device=dev, dtype=head.dtype)
            return torch.cat([head, pad]), s
        full = draws(n_max, torch.cat([noise, tail_noise]))
    else:
        full = draws(n_max, noise)
    s = first_stop(full)
    return full, (n_max if s is None else s)


def uniform_poses(m: Map, cells, jitter, heading, n: int, dtype):
    """The first ``n`` poses uniform over free space: the pool's free-cell
    centres (the pool tiled to the capacity) moved by the in-cell jitter,
    with the drawn headings."""
    xy = m.free_xy[cells.long()]
    if xy.shape[0] < heading.shape[0]:
        xy = xy.repeat(-(-heading.shape[0] // xy.shape[0]), 1)
    xy = xy[:n] + jitter[:n] * m.res
    return torch.cat([xy, heading[:n, None]], dim=1).to(dtype)


def kld_rows(n_max: int, mn: int) -> tuple[int, int]:
    if mn < n_max:
        w1 = max(KLD_STAGE1, mn + mn // 4)
        if w1 < n_max:
            return w1, n_max - w1
    return n_max, 0


def scan(state: State, odom_msgs: list, last_odom, ranges, angles, m: Map,
         prog: Program, gen: torch.Generator, dtype=torch.float32) -> Result:
    """One scan from ``state``: a predict per odometry message (each from
    the previous message), then the correction on ``ranges``."""
    f = prog.cfg
    dev = state.particles.device
    n = prog.n_max
    parts = state.particles.to(dtype)
    prev = parts
    anchor = state.anchor.float()
    delta = torch.zeros(3)
    for msg in odom_msgs:
        curr = np.asarray(msg, dtype=np.float32)
        delta = motion(last_odom, curr)
        prev = parts
        parts = predict(parts, delta, f, m, gen, dtype)
        anchor = advance(anchor, delta.to(dev))
        last_odom = curr
    mask = torch.arange(n, device=dev) < state.count
    alpha = (f["alpha1"], f["alpha2"], f["alpha3"], f["alpha4"])
    d = delta.to(dev, dtype)

    # the window: centred on the anchor, its heading backed off half the
    # scan's rotation
    origin3 = None
    if prog.window:
        h, w = m.occ.shape
        inv_res = float(np.float32(1.0) / np.float32(m.res))
        a32 = anchor
        half = prog.window // 2
        ox0 = int(((a32[0] - m.origin[0]) * inv_res).to(torch.int32)) - half
        oy0 = int(((a32[1] - m.origin[1]) * inv_res).to(torch.int32)) - half
        ox0, oy0 = min(max(ox0, 0), w - prog.window), min(max(oy0, 0), h - prog.window)
        k_all = f.get("corr_n_theta", 120)
        mt = wrap(a32[2] - 0.5 * (delta[0].to(dev) + delta[2].to(dev)))
        kmid = int(((mt + math.pi) * (k_all / (2.0 * math.pi))).to(torch.int32)) % k_all
        origin3 = (oy0, ox0, (kmid - prog.theta_bins // 2) % k_all)

    if prog.scorer == "corr":
        score = corr_scorer(ranges, angles, m, prog, origin3, dtype)
    else:
        score = exact_scorer(ranges, angles, m, prog, dtype)

    first = parts[0]
    s_post = score(torch.where(mask[:, None], parts, first))
    s_pre = score(torch.where(mask[:, None], prev, first))
    carry = prog.ess_threshold < 1.0
    log_carry = torch.log(torch.clamp(state.weights.to(dtype), min=1e-30)) \
        if carry else 0.0
    w_post = softmax(s_post + log_carry, mask)
    w_pre = softmax(s_pre + log_carry, mask)
    if f["mode"].startswith("AMH"):
        fwd = motion_density(prev, parts, d, alpha)
        bwd_delta = torch.stack([wrap(math.pi - d[2]), d[1], wrap(-d[0] - math.pi)])
        bwd = motion_density(parts, prev, bwd_delta, alpha)
        num = torch.log(w_post + 1e-10) + torch.log(bwd + 1e-10)
        den = torch.log(w_pre + 1e-10) + torch.log(fwd + 1e-10)
        acc_p = torch.clamp(torch.exp(num - den), max=1.0)
        if f.get("ref_compat_assym_guard", True):
            acc_p = torch.where(den > 0, acc_p, 1.0)
    else:
        acc_p = torch.where(w_pre > 0, torch.clamp(w_post / w_pre, max=1.0), 1.0)
    u = torch.rand((n,), generator=gen, device=dev).to(dtype)
    accept = u < acc_p
    parts = torch.where(accept[:, None], parts, prev)
    weights = torch.where(mask, torch.where(accept, w_post, w_pre), 0.0)
    weights = weights / torch.clamp(weights.sum(), min=1e-30)
    accept_rate = float((accept & mask).sum()) / max(state.count, 1)

    # augmented MCL: averages of the per-beam geometric-mean likelihood
    n_beams = int((torch.isfinite(ranges) & (ranges < f["max_range"])).sum())
    per_beam = s_post / max(n_beams, 1) if prog.aggregation == "sum" else s_post
    w_avg = float(torch.where(mask, torch.exp(per_beam.double()), 0.0).sum()) \
        / max(state.count, 1)
    w_slow = state.w_slow + f["alpha_slow"] * (w_avg - state.w_slow)
    w_fast = state.w_fast + f["alpha_fast"] * (w_avg - state.w_fast)

    # the window anchor: the top particle's cluster takes over when it
    # holds more weight, or when it is the same mode
    rxy, rth = f.get("cluster_radius_xy", 0.5), f.get("cluster_radius_theta", 1.0)
    cand = parts[int(torch.argmax(weights))].double()
    anchor = anchor.double()
    p64, w64 = parts.double(), weights.double()
    m_cand = float(torch.where(_near(p64, cand, rxy, rth), w64, 0.0).sum())
    m_cur = float(torch.where(_near(p64, anchor, rxy, rth), w64, 0.0).sum())
    same = bool(torch.hypot(cand[0] - anchor[0], cand[1] - anchor[1]) <= rxy) \
        and bool(wrap(cand[2] - anchor[2]).abs() <= rth)
    migrate = m_cand > f.get("anchor_hysteresis", 1.0) * m_cur
    streak = state.streak + 1 if (migrate and not same) else 0
    migrate = migrate and streak >= f.get("anchor_commit_scans", 1)
    anchor_mass = m_cand if (same or migrate) else m_cur

    mean, cov = estimate(parts.double(), weights.double(), mask)
    ess = 1.0 / max(float((weights.double() ** 2).sum()), 1e-30)

    # resampling: every draw is made whether or not the gate opens
    r = torch.rand((), generator=gen, device=dev)
    rows, tail = kld_rows(n, f["min_particles"])
    noise = torch.randn((rows, 3), generator=gen, device=dev)
    tail_noise = torch.randn((tail, 3), generator=gen, device=dev) if tail else None
    cells = torch.randint(0, m.free_xy.shape[0], (min(n, POOL),), generator=gen,
                          device=dev)
    jitter = torch.rand((n, 2), generator=gen, device=dev) - 0.5
    heading = torch.rand((n,), generator=gen, device=dev) * (2.0 * math.pi) \
        - math.pi
    p_rand = max(1.0 - w_fast / (w_slow + 1e-9), 0.0)
    p_rand = p_rand if p_rand >= f.get("min_injection_prob", 0.0) else 0.0
    count = state.count
    if not carry or ess < prog.ess_threshold * count or p_rand > 0:
        # the injected poses take the first slots, the kept samples follow
        n_drop = int(np.float32(p_rand) * np.float32(count))
        n_res = count - n_drop
        n_rand = int(np.float32(p_rand) * np.float32(n)) if prog.refill else n_drop
        samples, kept = kld_resample(parts, weights, n_res, r, noise,
                                     tail_noise, f, n)
        count = int(min(max(n_rand + min(kept, n_res), f["min_particles"]), n))
        active = torch.cat([uniform_poses(m, cells, jitter, heading, n_rand,
                                          dtype), samples[:count - n_rand]])
        active_w = torch.full((count,), 1.0 / count, device=dev, dtype=dtype)
    else:
        p_rand = 0.0
        active, active_w = parts[:count], weights[:count]
    return Result(mean, cov, ess, accept_rate, count, p_rand, w_slow, w_fast,
                  anchor_mass, active, active_w, gen.get_state())


def next_stage(in_small: bool, count: int, p_rand: float, mass: float,
               cap: int) -> bool:
    """The staged hand-off: stay in (or go to) the tracking program while
    the count fits, nothing is injected and one mode holds the weight."""
    if in_small:
        return not (count >= cap or p_rand > 1e-6 or mass < 0.35)
    return count <= int(0.9 * cap) and p_rand <= 1e-6 and mass >= 0.6
