"""Exact likelihood-field scores, the endpoint math fused with the reads.

Port of ``mcmh_localization_tpu/ops/likelihood_pallas.py``; the CUDA kernel
is ``csrc/likelihood.cu``.  It serves both JAX exact scorers: the "jnp"
scorer (``models/sensor.py::likelihood_field_scores``) finds a beam's cell
by dividing by the resolution (``GridMap.world_to_grid``), the "pallas"
scorer by multiplying by ``f32(1 / resolution)``; the two differ by an ulp
at cell edges, so ``cell_div`` picks the form.  The TPU kernel's VMEM table
and lane-group partial sums are TPU mechanics.  The beam sum runs in the
kernel's fixed order (``lane_sum``), so the kernel and the plain version
agree bitwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mcmh_localization_tpu_torch.models.sensor import BLIND_SCORE
from mcmh_localization_tpu_torch.ops import _cuda
from mcmh_localization_tpu_torch.utils.f32 import divide

# The kernel stages a scan's valid beams in shared memory in tiles of this
# many raw beams (csrc/likelihood.cu::kBeamTile), carrying each lane's sum
# across tiles in ``lane_sum``'s order: a multiple of every G.
BEAM_TILE = 2048


def scan_endpoints_uv(particles: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor):
    """(lx, ly), each (N, M): the world endpoints of sensor-frame beam
    endpoints (u, v) from every pose, in the JAX evaluation order."""
    c = torch.cos(particles[:, 2])[:, None]
    s = torch.sin(particles[:, 2])[:, None]
    lx = particles[:, 0][:, None] + c * u[None, :] - s * v[None, :]
    ly = particles[:, 1][:, None] + s * u[None, :] + c * v[None, :]
    return lx, ly


def endpoint_cells(particles: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   origin_x: float, origin_y: float, scale: float,
                   cell_div: bool):
    """(mx, my) int32 (N, M): the cell of every beam endpoint,
    ``i32((l - origin) / scale)`` or ``i32((l - origin) * scale)``."""
    lx, ly = scan_endpoints_uv(particles, u, v)
    dx, dy = lx - origin_x, ly - origin_y
    if cell_div:
        return (divide(dx, scale).to(torch.int32),
                divide(dy, scale).to(torch.int32))
    return (dx * scale).to(torch.int32), (dy * scale).to(torch.int32)


def lanes_per_particle(n: int) -> int:
    """G, the lanes of the kernel that share one pose: the smallest power
    of two in [1, 32] that gives ``n * G`` at least ``_cuda.FILL_THREADS``
    threads, so a small cloud
    still spreads over the card and a large one reads each beam from
    neighbouring poses.  Nonincreasing in ``n``."""
    g = 1
    while g < 32 and n * g < _cuda.FILL_THREADS:
        g *= 2
    return g


def lane_sum(contrib: torch.Tensor, lanes: int) -> torch.Tensor:
    """(N,) row sums of ``contrib`` (N, K) in the kernel's order: lane g
    of a group of ``lanes`` adds columns g, g + lanes, ... in ascending
    order from +0.0 (the padding adds +0.0, which changes no bit), then an
    xor butterfly over the group, offsets lanes/2 down to 1."""
    n, k = contrib.shape
    steps = -(-k // lanes)
    part = F.pad(contrib, (0, steps * lanes - k)).reshape(n, steps, lanes)
    acc = torch.zeros((n, lanes), dtype=contrib.dtype, device=contrib.device)
    for t in range(steps):
        acc = acc + part[:, t]
    while lanes > 1:
        lanes //= 2
        acc = acc[:, :lanes] + acc[:, lanes:]
    return acc[:, 0]


def valid_first(valid: torch.Tensor) -> torch.Tensor:
    """(M,) the beam order that puts the valid beams first, each group in
    beam order: the kernels' compaction of the valid beams, at the scan's
    static shape (a boolean-mask index would read the count on the host).
    The invalid beams behind them add +0.0 to a lane sum, which changes no
    bit."""
    return torch.argsort((~valid).to(torch.uint8), stable=True)


def likelihood_scores_plain(particles, u, v, valid, field, origin_x, origin_y,
                            scale, cell_div, count, aggregation, lanes=None):
    h, w = field.shape
    if lanes is None:
        lanes = lanes_per_particle(particles.shape[0])
    order = valid_first(valid)
    mx, my = endpoint_cells(particles, u[order], v[order], origin_x, origin_y,
                            scale, cell_div)
    in_map = ((mx >= 0) & (mx < w) & (my >= 0) & (my < h)
              & valid[order][None, :])
    flat = my.clamp(0, h - 1).to(torch.int64) * w + mx.clamp(0, w - 1)
    contrib = torch.where(in_map, field.reshape(-1)[flat], 0.0)
    total = lane_sum(contrib, lanes)
    score = (total if aggregation == "sum"
             else total / count.clamp(min=1).to(torch.float32))
    return torch.where(count > 0, score, BLIND_SCORE).to(torch.float32)


def likelihood_scores(particles: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor, valid: torch.Tensor,
                      field: torch.Tensor, origin_x: float, origin_y: float,
                      scale: float, cell_div: bool, count: torch.Tensor,
                      aggregation: str) -> torch.Tensor:
    """(N,) exact scores: particles (N, 3) f32; the beams' sensor-frame
    endpoints ``u``, ``v`` (M,) f32 and ``valid`` (M,) bool; the (H, W)
    f32 log field; ``scale`` the resolution (``cell_div``) or its inverse;
    ``count`` the 0-d int valid-beam count: the "mean" divisor, and the
    blind penalty when it is 0.  The beam sums run in the order of
    ``lanes_per_particle(N)`` lanes a pose.  CPU tensors take the plain
    version."""
    if particles.device.type == "cpu":
        return likelihood_scores_plain(particles, u, v, valid, field,
                                       origin_x, origin_y, scale, cell_div,
                                       count, aggregation)
    cnt = count.to(torch.int32).reshape(())
    _cuda.require_cuda("likelihood_scores", particles, u, v, valid, field, cnt)
    if (particles.dtype != torch.float32 or u.dtype != torch.float32
            or v.dtype != torch.float32 or field.dtype != torch.float32):
        raise ValueError("likelihood_scores: particles, u, v and field must "
                         "be float32")
    if valid.dtype != torch.bool or particles.dim() != 2 or particles.shape[1] != 3:
        raise ValueError("likelihood_scores: valid must be bool and "
                         "particles (N, 3)")
    m = u.shape[0]
    if v.shape != u.shape or valid.shape != u.shape:
        raise ValueError("likelihood_scores: u, v, valid must be (M,) alike")
    n = particles.shape[0]
    h, w = field.shape
    out = torch.empty(n, dtype=torch.float32, device=particles.device)
    code = _cuda.library().mcmh_likelihood_scores(
        particles.data_ptr(), n, u.data_ptr(), v.data_ptr(), valid.data_ptr(),
        m, field.data_ptr(), h, w, origin_x, origin_y, scale, int(cell_div),
        cnt.data_ptr(), int(aggregation == "sum"), BLIND_SCORE,
        lanes_per_particle(n),
        out.data_ptr(), _cuda.stream_of(particles),
    )
    _cuda.check_launch("likelihood_scores", code)
    return out
