"""Fused scan scorers: one table read per (particle, beam) with the index
math, the mixture and the beam sum fused around it.

The JAX package's range-table scorer (``models/range_table.py::
raycast_table_scores``) and 3-D lidar scorer (``models/sensor3d.py::
lidar3d_scores``) each read one value per (particle, beam) through
``ops/gather_pallas.py::gather_2d`` and reduce (N, M) arrays after it.
Here each is one CUDA kernel (``csrc/scan_scores.cu``) on the exact
scorer's layout: the valid beams staged, G lanes a pose, the beam sum in
``ops/likelihood.py::lane_sum``'s order, so kernel and plain version agree
bitwise.  The plain versions work on a chunk of poses at a time, so no
(N, M) array is built whole.

``table_scores`` (the range table): per pose its cell ``i32((p - origin) /
res)`` (``GridMap.world_to_grid``) and per valid beam ``k = floor((theta +
a_j + pi) / (2 pi / K)) mod K``, ``z = (r_j - table[cell, k]) / sigma``
(IEEE divisions), ``log(max(z_hit * (hit_norm * exp(-z^2 / 2)) + z_rand /
max_range, LOG_FLOOR))``; off-map poses add 0.

``voxel_scores`` (the 3-D lidar): per pose and live beam the endpoint
``(x + c u - s v, y + s u + c v)``, its voxel ``floor((l - origin) *
inv)`` (``VoxelMap.world_to_voxel``) in the beam's plane, one read of the
log-mixture volume where the voxel lies in the volume.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mcmh_localization_tpu_torch.models.sensor import BLIND_SCORE, LOG_FLOOR
from mcmh_localization_tpu_torch.ops import _cuda
from mcmh_localization_tpu_torch.ops.gather import PI_F32
from mcmh_localization_tpu_torch.ops.likelihood import lane_sum, lanes_per_particle
from mcmh_localization_tpu_torch.utils.f32 import divide

MAX_TABLE_BEAMS = 2048    # csrc/scan_scores.cu: staged as float2
MAX_VOXEL_BEAMS = 14336   # staged as float4, 224 KB of shared memory
# The plain versions' pose chunk: about this many (pose, beam) pairs at a
# time, so a temporary stays near 64 MB (128 MB for int64 indices).
CHUNK_PAIRS = 1 << 24
# Beam columns padded to a multiple of this: PyTorch's CPU kernels take a
# vector path for whole vectors and a scalar one for a tail, and their exp
# and log round differently there; with no tail, a chunk's values do not
# depend on where the chunk starts.
_COLUMN_PAD = 64


class TableGeometry(NamedTuple):
    """The map and table of ``table_scores``: the f32 origin and resolution
    as python floats, the map's cell shape and the table's bin count."""

    origin_x: float
    origin_y: float
    res: float
    h: int
    w: int
    n_theta: int


class Mixture(NamedTuple):
    """The beam model's mixture constants, as the PyTorch ops take them:
    ``z_hit * (hit_norm * exp(-0.5 z^2)) + z_floor`` with ``z_floor = z_rand
    / max_range`` (python floats)."""

    sigma: float
    z_hit: float
    hit_norm: float
    z_floor: float


class VoxelGeometry(NamedTuple):
    """The volume of ``voxel_scores``: origin x and y and the inverse
    resolution as ``VoxelMap.world_to_voxel`` takes them (python floats),
    the volume's shape."""

    origin_x: float
    origin_y: float
    inv: float
    d: int
    h: int
    w: int


def _f32(x: float) -> float:
    return float(np.float32(x))


def _chunk_rows(cols: int, chunk: int | None) -> int:
    return chunk if chunk else max(1, CHUNK_PAIRS // max(cols, 1))


def _aggregate(total: torch.Tensor, count: torch.Tensor,
               aggregation: str) -> torch.Tensor:
    score = (total if aggregation == "sum"
             else total / count.clamp(min=1).to(torch.float32))
    return torch.where(count > 0, score, BLIND_SCORE).to(torch.float32)


def _padded_columns(*cols: torch.Tensor):
    """The beam columns padded with zeros to a multiple of ``_COLUMN_PAD``
    and the (M_pad,) mask of the real ones."""
    m = cols[0].shape[0]
    mp = -(-max(m, 1) // _COLUMN_PAD) * _COLUMN_PAD
    real = torch.arange(mp, device=cols[0].device) < m
    return [F.pad(c, (0, mp - m)) for c in cols], real


def table_scores_plain(particles, ranges, angles, valid, table_cm,
                       geo: TableGeometry, mix: Mixture, count, aggregation,
                       lanes=None, chunk=None) -> torch.Tensor:
    """The plain version of ``table_scores``: ``chunk`` poses at a time
    (default: about ``CHUNK_PAIRS`` pose-beam pairs), the beam sums in
    ``lanes`` lanes' order (default ``lanes_per_particle(N)``)."""
    n = particles.shape[0]
    lanes = lanes or lanes_per_particle(n)
    (r, a), real = _padded_columns(ranges[valid], angles[valid])
    dev = particles.device
    mx = divide(particles[:, 0] - geo.origin_x, geo.res).to(torch.int32)
    my = divide(particles[:, 1] - geo.origin_y, geo.res).to(torch.int32)
    in_map = (mx >= 0) & (mx < geo.w) & (my >= 0) & (my < geo.h)
    cell = (my.clamp(0, geo.h - 1).to(torch.int64) * geo.w
            + mx.clamp(0, geo.w - 1))
    flat = table_cm.reshape(-1)
    dtheta = 2.0 * math.pi / geo.n_theta
    total = torch.empty(n, dtype=torch.float32, device=dev)
    rows = _chunk_rows(r.shape[0], chunk)
    for i0 in range(0, n, rows):
        sl = slice(i0, i0 + rows)
        k = torch.floor(divide(particles[sl, 2][:, None] + a[None, :] + PI_F32,
                               dtheta)).to(torch.int64) % geo.n_theta
        z = divide(r[None, :] - flat[cell[sl, None] * geo.n_theta + k],
                   mix.sigma)
        prob = (mix.z_hit * (mix.hit_norm * torch.exp(-0.5 * z ** 2))
                + mix.z_floor)
        logp = torch.log(torch.clamp(prob, min=LOG_FLOOR))
        total[sl] = lane_sum(
            torch.where(in_map[sl, None] & real[None, :], logp, 0.0), lanes)
    return _aggregate(total, count, aggregation)


def table_scores(particles: torch.Tensor, ranges: torch.Tensor,
                 angles: torch.Tensor, valid: torch.Tensor,
                 table_cm: torch.Tensor, geo: TableGeometry, mix: Mixture,
                 count: torch.Tensor, aggregation: str) -> torch.Tensor:
    """(N,) beam-model scores with one read of the (H*W, K) cell-major
    range table per pose and valid beam: particles (N, 3) f32, the scan's
    ``ranges``, ``angles`` (M,) f32 and ``valid`` (M,) bool; ``count`` the
    0-d int valid-beam count (the "mean" divisor, and the blind penalty
    when 0).  CPU tensors take the plain version."""
    if particles.device.type == "cpu":
        return table_scores_plain(particles, ranges, angles, valid, table_cm,
                                  geo, mix, count, aggregation)
    cnt = count.to(torch.int32).reshape(())
    _cuda.require_cuda("table_scores", particles, ranges, angles, valid,
                       table_cm, cnt)
    if (particles.dtype != torch.float32 or ranges.dtype != torch.float32
            or angles.dtype != torch.float32 or table_cm.dtype != torch.float32):
        raise ValueError("table_scores: particles, ranges, angles and the "
                         "table must be float32")
    m = ranges.shape[0]
    if (valid.dtype != torch.bool or particles.shape[1:] != (3,)
            or angles.shape != ranges.shape or valid.shape != ranges.shape
            or m > MAX_TABLE_BEAMS):
        raise ValueError(f"table_scores: particles (N, 3), ranges, angles, "
                         f"valid (M,) alike with M <= {MAX_TABLE_BEAMS}")
    if table_cm.shape != (geo.h * geo.w, geo.n_theta):
        raise ValueError("table_scores: the table must be (H*W, K)")
    n = particles.shape[0]
    args = _cuda.TableArgs(
        origin_x=geo.origin_x, origin_y=geo.origin_y, res=geo.res,
        pi_f=PI_F32, dtheta=_f32(2.0 * math.pi / geo.n_theta),
        sigma=_f32(mix.sigma), hit_norm=mix.hit_norm, z_hit=_f32(mix.z_hit),
        z_floor=_f32(mix.z_floor), log_floor=_f32(LOG_FLOOR),
        blind_score=BLIND_SCORE, h=geo.h, w=geo.w, n_theta=geo.n_theta,
        sum_aggregation=int(aggregation == "sum"))
    out = torch.empty(n, dtype=torch.float32, device=particles.device)
    code = _cuda.library().mcmh_table_scores(
        particles.data_ptr(), n, ranges.data_ptr(), angles.data_ptr(),
        valid.data_ptr(), m, table_cm.data_ptr(), cnt.data_ptr(), args,
        lanes_per_particle(n), out.data_ptr(), _cuda.stream_of(particles))
    _cuda.check_launch("table_scores", code)
    return out


def voxel_scores_plain(particles, u, v, zrow, live, volume,
                       geo: VoxelGeometry, count, aggregation, lanes=None,
                       chunk=None) -> torch.Tensor:
    """The plain version of ``voxel_scores``: ``chunk`` poses at a time,
    the beam sums in ``lanes`` lanes' order."""
    n = particles.shape[0]
    lanes = lanes or lanes_per_particle(n)
    # cos and sin once over all poses: the chunks do not move them
    c = torch.cos(particles[:, 2])
    s = torch.sin(particles[:, 2])
    ul, vl, zl = u[live], v[live], zrow[live].to(torch.int64)
    flat = volume.reshape(-1)
    total = torch.empty(n, dtype=torch.float32, device=particles.device)
    rows = _chunk_rows(ul.shape[0], chunk)
    for i0 in range(0, n, rows):
        sl = slice(i0, i0 + rows)
        cs, ss = c[sl, None], s[sl, None]
        lx = particles[sl, 0][:, None] + cs * ul[None, :] - ss * vl[None, :]
        ly = particles[sl, 1][:, None] + ss * ul[None, :] + cs * vl[None, :]
        vx = torch.floor((lx - geo.origin_x) * geo.inv).to(torch.int64)
        vy = torch.floor((ly - geo.origin_y) * geo.inv).to(torch.int64)
        inb = (vx >= 0) & (vx < geo.w) & (vy >= 0) & (vy < geo.h)
        idx = ((zl[None, :] + vy.clamp(0, geo.h - 1)) * geo.w
               + vx.clamp(0, geo.w - 1))
        total[sl] = lane_sum(torch.where(inb, flat[idx], 0.0), lanes)
    return _aggregate(total, count, aggregation)


def voxel_scores(particles: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 zrow: torch.Tensor, live: torch.Tensor, volume: torch.Tensor,
                 geo: VoxelGeometry, count: torch.Tensor,
                 aggregation: str) -> torch.Tensor:
    """(N,) 3-D lidar scores with one read of the (D, H, W) log-mixture
    ``volume`` per pose and live beam: particles (N, 3) f32; each beam's
    sensor-frame ``u``, ``v`` (M,) f32, ``zrow`` (M,) int32 (its voxel
    plane times H) and ``live`` (M,) bool (valid, and its plane in the
    volume); ``count`` the 0-d int count of valid beams, live or not.  CPU
    tensors take the plain version."""
    if particles.device.type == "cpu":
        return voxel_scores_plain(particles, u, v, zrow, live, volume, geo,
                                  count, aggregation)
    cnt = count.to(torch.int32).reshape(())
    _cuda.require_cuda("voxel_scores", particles, u, v, zrow, live, volume,
                       cnt)
    if (particles.dtype != torch.float32 or u.dtype != torch.float32
            or v.dtype != torch.float32 or volume.dtype != torch.float32):
        raise ValueError("voxel_scores: particles, u, v and the volume must "
                         "be float32")
    m = u.shape[0]
    if (zrow.dtype != torch.int32 or live.dtype != torch.bool
            or particles.shape[1:] != (3,) or v.shape != u.shape
            or zrow.shape != u.shape or live.shape != u.shape
            or m > MAX_VOXEL_BEAMS):
        raise ValueError(f"voxel_scores: particles (N, 3); u, v, zrow "
                         f"(int32), live (bool) (M,) alike with M <= "
                         f"{MAX_VOXEL_BEAMS}")
    if volume.shape != (geo.d, geo.h, geo.w):
        raise ValueError("voxel_scores: the volume must be (D, H, W)")
    n = particles.shape[0]
    args = _cuda.VoxelArgs(
        origin_x=_f32(geo.origin_x), origin_y=_f32(geo.origin_y),
        inv=_f32(geo.inv), blind_score=BLIND_SCORE, h=geo.h, w=geo.w,
        sum_aggregation=int(aggregation == "sum"))
    out = torch.empty(n, dtype=torch.float32, device=particles.device)
    code = _cuda.library().mcmh_voxel_scores(
        particles.data_ptr(), n, u.data_ptr(), v.data_ptr(), zrow.data_ptr(),
        live.data_ptr(), m, volume.data_ptr(), cnt.data_ptr(), args,
        lanes_per_particle(n), _cuda.SM_COUNT, out.data_ptr(),
        _cuda.stream_of(particles))
    _cuda.check_launch("voxel_scores", code)
    return out
