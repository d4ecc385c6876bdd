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

Both read their table through the level form built once per (map,
config): ``table_levels`` and ``voxel_levels`` store each value as an
index into the table's distinct f32 levels (``levels[index]`` is the table
bit for bit).  The range table's few levels give a per-scan LUT of the
mixture over the valid beams x levels, so a pair is a byte read and a LUT
read; the log volume's give a 16-bit index volume in planes of 4 x 4
bricks.  A table with more levels than the kernel holds keeps its f32
form.
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
from mcmh_localization_tpu_torch.ops.likelihood import (
    lane_sum,
    lanes_per_particle,
    valid_first,
)
from mcmh_localization_tpu_torch.utils import profiling
from mcmh_localization_tpu_torch.utils.f32 import divide

# The raw beams a tile of the kernels' beam staging (csrc/scan_scores.cu:
# kTableTile, kVoxelTile): each lane's sum carries across tiles in
# ``lane_sum``'s order, so a scan of any length takes the sums of one tile;
# each a multiple of every G.
TABLE_TILE = 2048
VOXEL_TILE = 512
# The level forms' limits (csrc/scan_scores.cu): the range table's LUT
# form (uint8 indices up to 256 levels, int16 above), and the log volume's
# levels in shared memory; a table with more levels keeps its f32 form.
MAX_TABLE_LEVELS = 1024
MAX_VOXEL_LEVELS = 4096
# Form (a) takes its level form for a scorer that scores at least this many
# poses a call, else the per-pair f32 form: below it the level form's LUT
# launch and each block's LUT copy cost more than the mixture they save
# (chip_kernel_ab.py's sweep over N on an H100, PERF.md §6).
TABLE_LEVEL_MIN_POSES = 40_000
# The index volume's planes are stored in TILE x TILE bricks of 16-bit
# indices, one 32-byte sector each (``tile_planes``).
TILE = 4
# The plain versions' pose chunk: about this many (pose, beam) pairs at a
# time, so a temporary stays near 64 MB (128 MB for int64 indices).
CHUNK_PAIRS = 1 << 24
# Beam columns padded to a multiple of this in the per-pair form: PyTorch's
# CPU kernels take a vector path for whole vectors and a scalar one for a
# tail, and their exp and log round differently there; with no tail, a
# chunk's values do not depend on where the chunk starts.
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


class TableLevels(NamedTuple):
    """Form (a)'s (H*W, K) cell-major range table as the kernel reads it:
    ``index`` (uint8 up to 256 levels, else int16) into the (nq,) f32
    ``levels``, ``table`` None; or, past ``MAX_TABLE_LEVELS`` levels, the
    f32 ``table`` itself, ``index`` and ``levels`` None."""

    index: torch.Tensor | None
    levels: torch.Tensor | None
    table: torch.Tensor | None


class VoxelLevels(NamedTuple):
    """Form (b)'s (D, H, W) log volume as the kernel reads it: ``index``
    the int16 level of every voxel in planes of 4 x 4 bricks
    (``tile_planes``) into the (L,) f32 ``levels``, ``volume`` None; or,
    past ``MAX_VOXEL_LEVELS`` levels, the f32 ``volume`` itself, ``index``
    and ``levels`` None."""

    index: torch.Tensor | None
    levels: torch.Tensor | None
    volume: torch.Tensor | None


def _f32(x: float) -> float:
    return float(np.float32(x))


def _chunk_rows(cols: int, chunk: int | None) -> int:
    return chunk if chunk else max(1, CHUNK_PAIRS // max(cols, 1))


def _aggregate(total: torch.Tensor, count: torch.Tensor,
               aggregation: str) -> torch.Tensor:
    score = (total if aggregation == "sum"
             else total / count.clamp(min=1).to(torch.float32))
    return torch.where(count > 0, score, BLIND_SCORE).to(torch.float32)


def _padded_columns(*cols: torch.Tensor) -> list:
    """The beam columns padded with zeros (False) to a multiple of
    ``_COLUMN_PAD``."""
    m = cols[0].shape[0]
    mp = -(-max(m, 1) // _COLUMN_PAD) * _COLUMN_PAD
    return [F.pad(c, (0, mp - m)) for c in cols]


def _levels(values: torch.Tensor):
    """(levels, inverse): the distinct f32 values of ``values`` by their
    bits (so -0.0 and +0.0, or two NaNs, stay apart) and the index of each
    value among them."""
    bits = values.contiguous().view(torch.int32)
    uniq, inverse = torch.unique(bits, return_inverse=True)
    return uniq.view(torch.float32), inverse


def table_levels(table_cm: torch.Tensor,
                 poses: int | None = None) -> TableLevels:
    """Form (a)'s table from an (H*W, K) f32 cell-major range table, on its
    device: the level form where it has at most ``MAX_TABLE_LEVELS``
    distinct values (a ray-cast table has ``max_range / RAY_STEP + 1``)
    and its scorer scores at least ``TABLE_LEVEL_MIN_POSES`` ``poses`` a
    call (None: any number), else the table itself.  Both forms score
    bitwise alike."""
    if poses is not None and poses < TABLE_LEVEL_MIN_POSES:
        return TableLevels(None, None, table_cm.contiguous())
    levels, inverse = _levels(table_cm)
    if levels.numel() > MAX_TABLE_LEVELS:
        return TableLevels(None, None, table_cm.contiguous())
    dtype = torch.uint8 if levels.numel() <= 256 else torch.int16
    return TableLevels(inverse.to(dtype).reshape(table_cm.shape).contiguous(),
                       levels.contiguous(), None)


def table_kernels(table: TableLevels) -> int:
    """The kernels one ``table_scores`` call launches on ``table``: the
    level form's scan LUT and scorer, or the per-pair scorer."""
    return 2 if table.index is not None else 1


def tile_planes(x: torch.Tensor) -> torch.Tensor:
    """(D, H, W) -> (D * Hp * Wp,): each plane padded to whole TILE x TILE
    bricks (Hp, Wp) and stored brick by brick, row-major over the bricks, a
    brick row by row (``tiled_offsets``)."""
    d, h, w = x.shape
    hp, wp = -(-h // TILE) * TILE, -(-w // TILE) * TILE
    x = F.pad(x, (0, wp - w, 0, hp - h))
    x = x.reshape(d, hp // TILE, TILE, wp // TILE, TILE)
    return x.permute(0, 1, 3, 2, 4).reshape(-1).contiguous()


def tiled_offsets(vz: torch.Tensor, vy: torch.Tensor, vx: torch.Tensor,
                  h: int, w: int) -> torch.Tensor:
    """The int64 offsets of voxels (vz, vy, vx) in ``tile_planes``'s
    layout of a (D, H, W) volume (csrc/scan_scores.cu::VolumeLevels)."""
    hp, wp = -(-h // TILE) * TILE, -(-w // TILE) * TILE
    brick = (vy >> 2) * (wp // TILE) + (vx >> 2)
    return vz * (hp * wp) + brick * 16 + (vy & 3) * 4 + (vx & 3)


def voxel_levels(volume: torch.Tensor) -> VoxelLevels:
    """Form (b)'s volume from a (D, H, W) f32 log volume, on its device:
    the level form where it has at most ``MAX_VOXEL_LEVELS`` distinct
    values (every voxel beyond about 6.5 sigma from a surface holds the
    same one), else the volume itself.  The level form's kernel takes
    planes under 2^22 voxels a side and an index under 2^31 voxels.
    Under tracing a volume left in its f32 form counts one
    ``voxel_f32_volume``."""
    d, h, w = volume.shape
    hp, wp = -(-h // TILE) * TILE, -(-w // TILE) * TILE
    levels = None
    if max(h, w) < 1 << 22 and d * hp * wp < 1 << 31:
        levels, inverse = _levels(volume)
    if levels is None or levels.numel() > MAX_VOXEL_LEVELS:
        profiling.count("voxel_f32_volume")
        return VoxelLevels(None, None, volume.contiguous())
    return VoxelLevels(
        tile_planes(inverse.to(torch.int16).reshape(volume.shape)),
        levels.contiguous(), None)


def voxel_lanes(n: int) -> int:
    """Form (b)'s G: the smallest power of two in [1, 32] that gives ``n *
    G`` at least a quarter of ``_cuda.FILL_THREADS`` threads.  One lane a
    pose at the [lidar3d] shape (2 x 100k poses): a warp's 32 lanes then
    read one beam from 32 consecutive slots, after resampling copies of a
    few parents whose endpoints share sectors (PERF.md §6)."""
    g = 1
    while g < 32 and n * g < _cuda.FILL_THREADS // 4:
        g *= 2
    return g


def table_args(geo: TableGeometry, mix: Mixture,
               aggregation: str) -> _cuda.TableArgs:
    """csrc/scan_scores.cu's scalar arguments of form (a)."""
    return _cuda.TableArgs(
        origin_x=geo.origin_x, origin_y=geo.origin_y, res=geo.res,
        pi_f=PI_F32, dtheta=_f32(2.0 * math.pi / geo.n_theta),
        sigma=_f32(mix.sigma), hit_norm=mix.hit_norm, z_hit=_f32(mix.z_hit),
        z_floor=_f32(mix.z_floor), log_floor=_f32(LOG_FLOOR),
        blind_score=BLIND_SCORE, h=geo.h, w=geo.w, n_theta=geo.n_theta,
        sum_aggregation=int(aggregation == "sum"))


def voxel_args(geo: VoxelGeometry, aggregation: str) -> _cuda.VoxelArgs:
    """csrc/scan_scores.cu's scalar arguments of form (b)."""
    return _cuda.VoxelArgs(
        origin_x=_f32(geo.origin_x), origin_y=_f32(geo.origin_y),
        inv=_f32(geo.inv), blind_score=BLIND_SCORE, h=geo.h, w=geo.w,
        sum_aggregation=int(aggregation == "sum"))


def _pair_mixture(r: torch.Tensor, d: torch.Tensor,
                  mix: Mixture) -> torch.Tensor:
    """The beam model's per-pair log mixture at range ``r`` and table value
    ``d`` (broadcast), in the JAX op order (csrc/scan_scores.cu::
    pair_mixture)."""
    z = divide(r - d, mix.sigma)
    prob = mix.z_hit * (mix.hit_norm * torch.exp(-0.5 * z ** 2)) + mix.z_floor
    return torch.log(torch.clamp(prob, min=LOG_FLOOR))


def table_scores_plain(particles, ranges, angles, valid, table: TableLevels,
                       geo: TableGeometry, mix: Mixture, count, aggregation,
                       lanes=None, chunk=None) -> torch.Tensor:
    """The plain version of ``table_scores``: ``chunk`` poses at a time
    (default: about ``CHUNK_PAIRS`` pose-beam pairs), the beam sums in
    ``lanes`` lanes' order (default ``lanes_per_particle(N)``).  The level
    form reads the scan's LUT (valid beams x levels) through the index."""
    n = particles.shape[0]
    lanes = lanes or lanes_per_particle(n)
    dev = particles.device
    mx = divide(particles[:, 0] - geo.origin_x, geo.res).to(torch.int32)
    my = divide(particles[:, 1] - geo.origin_y, geo.res).to(torch.int32)
    in_map = (mx >= 0) & (mx < geo.w) & (my >= 0) & (my < geo.h)
    cell = (my.clamp(0, geo.h - 1).to(torch.int64) * geo.w
            + mx.clamp(0, geo.w - 1))
    dtheta = 2.0 * math.pi / geo.n_theta
    lut = table.index is not None
    # the valid beams first, at the scan's static shape (a boolean-mask
    # index would read their count on the host); the rest add +0.0
    order = valid_first(valid)
    if lut:
        r, a, real = ranges[order], angles[order], valid[order]
        nq = table.levels.shape[0]
        lp = _pair_mixture(r[:, None], table.levels[None, :], mix).reshape(-1)
        row = torch.arange(r.shape[0], device=dev) * nq
        flat = table.index.reshape(-1)
    else:
        r, a, real = _padded_columns(ranges[order], angles[order],
                                     valid[order])
        flat = table.table.reshape(-1)
    total = torch.empty(n, dtype=torch.float32, device=dev)
    rows = _chunk_rows(r.shape[0], chunk)
    for i0 in range(0, n, rows):
        sl = slice(i0, i0 + rows)
        k = torch.floor(divide(particles[sl, 2][:, None] + a[None, :] + PI_F32,
                               dtheta)).to(torch.int64) % geo.n_theta
        read = flat[cell[sl, None] * geo.n_theta + k]
        logp = (lp[row[None, :] + read.to(torch.int64)] if lut
                else _pair_mixture(r[None, :], read, mix))
        total[sl] = lane_sum(
            torch.where(in_map[sl, None] & real[None, :], logp, 0.0), lanes)
    return _aggregate(total, count, aggregation)


def table_scores(particles: torch.Tensor, ranges: torch.Tensor,
                 angles: torch.Tensor, valid: torch.Tensor,
                 table: TableLevels, geo: TableGeometry, mix: Mixture,
                 count: torch.Tensor, aggregation: str) -> torch.Tensor:
    """(N,) beam-model scores with one read of the (H*W, K) cell-major
    range ``table`` (``table_levels``) per pose and valid beam: particles
    (N, 3) f32, the scan's ``ranges``, ``angles`` (M,) f32 and ``valid``
    (M,) bool; ``count`` the 0-d int valid-beam count (the "mean" divisor,
    and the blind penalty when 0).  CPU tensors take the plain version."""
    if particles.device.type == "cpu":
        return table_scores_plain(particles, ranges, angles, valid, table,
                                  geo, mix, count, aggregation)
    cnt = count.to(torch.int32).reshape(())
    lut = table.index is not None
    stored = (table.index, table.levels) if lut else (table.table,)
    _cuda.require_cuda("table_scores", particles, ranges, angles, valid,
                       cnt, *stored)
    if (particles.dtype != torch.float32 or ranges.dtype != torch.float32
            or angles.dtype != torch.float32):
        raise ValueError("table_scores: particles, ranges and angles must be "
                         "float32")
    m = ranges.shape[0]
    if (valid.dtype != torch.bool or particles.shape[1:] != (3,)
            or angles.shape != ranges.shape or valid.shape != ranges.shape):
        raise ValueError("table_scores: particles (N, 3), ranges, angles, "
                         "valid (M,) alike")
    shape = (geo.h * geo.w, geo.n_theta)
    if lut:
        nq = table.levels.shape[0]
        if (table.index.dtype not in (torch.uint8, torch.int16)
                or table.index.shape != shape
                or table.levels.dtype != torch.float32
                or table.levels.dim() != 1 or not 0 < nq <= MAX_TABLE_LEVELS):
            raise ValueError("table_scores: the level form is an (H*W, K) "
                             "uint8 or int16 index and at most "
                             f"{MAX_TABLE_LEVELS} float32 levels")
    elif table.table.dtype != torch.float32 or table.table.shape != shape:
        raise ValueError("table_scores: the table must be (H*W, K) float32")
    n = particles.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=particles.device)
    if lut:
        scratch = torch.empty(m * nq, dtype=torch.float32,
                              device=particles.device)
        ptrs = (None, table.index.data_ptr(), table.index.element_size(),
                table.levels.data_ptr(), nq, scratch.data_ptr())
    else:
        ptrs = (table.table.data_ptr(), None, 0, None, 0, None)
    code = _cuda.library().mcmh_table_scores(
        particles.data_ptr(), n, ranges.data_ptr(), angles.data_ptr(),
        valid.data_ptr(), m, *ptrs, cnt.data_ptr(),
        table_args(geo, mix, aggregation), lanes_per_particle(n),
        _cuda.SM_COUNT, out.data_ptr(), _cuda.stream_of(particles))
    _cuda.check_launch("table_scores", code, kernels=table_kernels(table))
    return out


def voxel_scores_plain(particles, u, v, zrow, live, table: VoxelLevels,
                       geo: VoxelGeometry, count, aggregation, lanes=None,
                       chunk=None) -> torch.Tensor:
    """The plain version of ``voxel_scores``: ``chunk`` poses at a time,
    the beam sums in ``lanes`` lanes' order (default ``voxel_lanes(N)``),
    each read through the table's form."""
    n = particles.shape[0]
    lanes = lanes or voxel_lanes(n)
    # cos and sin once over all poses: the chunks do not move them
    c = torch.cos(particles[:, 2])
    s = torch.sin(particles[:, 2])
    # the live beams first, at the scan's static shape; the rest add +0.0
    order = valid_first(live)
    ul, vl, zl = u[order], v[order], zrow[order].to(torch.int64)
    real = live[order][None, :]
    levels = table.index is not None
    if levels:
        flat = table.index
        plane = zl // geo.h
    else:
        flat = table.volume.reshape(-1)
    total = torch.empty(n, dtype=torch.float32, device=particles.device)
    rows = _chunk_rows(ul.shape[0], chunk)
    for i0 in range(0, n, rows):
        sl = slice(i0, i0 + rows)
        cs, ss = c[sl, None], s[sl, None]
        lx = particles[sl, 0][:, None] + cs * ul[None, :] - ss * vl[None, :]
        ly = particles[sl, 1][:, None] + ss * ul[None, :] + cs * vl[None, :]
        vx = torch.floor((lx - geo.origin_x) * geo.inv).to(torch.int64)
        vy = torch.floor((ly - geo.origin_y) * geo.inv).to(torch.int64)
        inb = (vx >= 0) & (vx < geo.w) & (vy >= 0) & (vy < geo.h) & real
        vx, vy = vx.clamp(0, geo.w - 1), vy.clamp(0, geo.h - 1)
        if levels:
            read = table.levels[flat[tiled_offsets(
                plane[None, :], vy, vx, geo.h, geo.w)].to(torch.int64)]
        else:
            read = flat[(zl[None, :] + vy) * geo.w + vx]
        total[sl] = lane_sum(torch.where(inb, read, 0.0), lanes)
    return _aggregate(total, count, aggregation)


def voxel_scores(particles: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 zrow: torch.Tensor, live: torch.Tensor, table: VoxelLevels,
                 geo: VoxelGeometry, count: torch.Tensor,
                 aggregation: str) -> torch.Tensor:
    """(N,) 3-D lidar scores with one read of the (D, H, W) log-mixture
    volume (``voxel_levels``) per pose and live beam: particles (N, 3) f32;
    each beam's sensor-frame ``u``, ``v`` (M,) f32, ``zrow`` (M,) int32
    (its voxel plane times H) and ``live`` (M,) bool (valid, and its plane
    in the volume); ``count`` the 0-d int count of valid beams, live or
    not.  CPU tensors take the plain version."""
    if particles.device.type == "cpu":
        return voxel_scores_plain(particles, u, v, zrow, live, table, geo,
                                  count, aggregation)
    cnt = count.to(torch.int32).reshape(())
    levels = table.index is not None
    stored = (table.index, table.levels) if levels else (table.volume,)
    _cuda.require_cuda("voxel_scores", particles, u, v, zrow, live, cnt,
                       *stored)
    if (particles.dtype != torch.float32 or u.dtype != torch.float32
            or v.dtype != torch.float32):
        raise ValueError("voxel_scores: particles, u and v must be float32")
    m = u.shape[0]
    if (zrow.dtype != torch.int32 or live.dtype != torch.bool
            or particles.shape[1:] != (3,) or v.shape != u.shape
            or zrow.shape != u.shape or live.shape != u.shape):
        raise ValueError("voxel_scores: particles (N, 3); u, v, zrow "
                         "(int32), live (bool) (M,) alike")
    if levels:
        hp, wp = -(-geo.h // TILE) * TILE, -(-geo.w // TILE) * TILE
        n_levels = table.levels.shape[0]
        if (table.index.dtype != torch.int16
                or table.index.shape != (geo.d * hp * wp,)
                or table.levels.dtype != torch.float32
                or table.levels.dim() != 1
                or not 0 < n_levels <= MAX_VOXEL_LEVELS):
            raise ValueError("voxel_scores: the level form is a tiled int16 "
                             "index (tile_planes) and at most "
                             f"{MAX_VOXEL_LEVELS} float32 levels")
        ptrs = (None, table.index.data_ptr(), table.levels.data_ptr(),
                n_levels)
    else:
        if (table.volume.dtype != torch.float32
                or table.volume.shape != (geo.d, geo.h, geo.w)):
            raise ValueError("voxel_scores: the volume must be (D, H, W) "
                             "float32")
        ptrs = (table.volume.data_ptr(), None, None, 0)
    n = particles.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=particles.device)
    code = _cuda.library().mcmh_voxel_scores(
        particles.data_ptr(), n, u.data_ptr(), v.data_ptr(), zrow.data_ptr(),
        live.data_ptr(), m, *ptrs, cnt.data_ptr(),
        voxel_args(geo, aggregation), voxel_lanes(n),
        _cuda.SM_COUNT, out.data_ptr(), _cuda.stream_of(particles))
    _cuda.check_launch("voxel_scores", code)
    return out
