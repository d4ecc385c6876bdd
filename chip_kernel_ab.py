#!/usr/bin/env python3
"""Kernels 2, 4, 5, 6 and 7 of the PyTorch/CUDA port against their first
Hopper versions, and kernel 2's fused forms (a) and (b) against their
first versions, on one NVIDIA GPU, in turns.

    git archive 31a30c8 mcmh_localization_tpu_torch/csrc | tar -x -C build/parent
    git archive 4c0386c mcmh_localization_tpu_torch/csrc | tar -x -C build/parent_scan
    python3 chip_kernel_ab.py --old build/parent --old-scan build/parent_scan \
        [--kernels 2,4,5,6,7,a,b]

``--old DIR`` holds the ``likelihood.cu``, ``fused_score.cu``, ``gather.cu``,
``beam_field.cu`` and ``rank.cu`` of commit 31a30c8, the kernels' first
Hopper versions (its rank.cu holds kernel 4 before its one-launch
redesign).  The script binds their C
interface (the window score's denominator and fill as one (2,) device
array; the exact scorer without a lane count; the lookups without a
poses-a-thread count; the LUT field without its tile; the rank with its
running max and look-back words as scratch), which no other tree has, so
it checks the five files' sha256 first and refuses any other tree before
it builds.  They are built into a library of their own with ``nvcc``, the
earlier rank.cu inside a file that also exposes its three device
operations one at a time.  On the inputs of ``chip_smoke.py`` (its house
map, scan, clouds, beam model and weight patterns), every kernel is called
through its C entry point on the same precomputed arguments (kernel 4 of
this tree through its wrapper), so the readings hold the kernels alone:

- kernel 4 (the rank as indices) at R = 1M, num_out = 1M and 131 072,
  uniform weights and all mass on the middle particle: the earlier
  kernel's memset, scan and expansion timed apart, then the earlier kernel
  and this one, each bitwise against the plain version;
- kernel 6 (the exact scorer) at 2x100k and 2x1500 poses, both cell forms:
  the earlier kernel and this one at every lane count G in {1, 2, 4, 8,
  16, 32}, each G bitwise against the plain version at that G;
- kernel 5 (the window score) in the corr op forms at 2x1M poses, on a
  misaligned view of 2x100k + 3, in the beam op forms at the beam path's
  geometry and 2x100k, and its escapee count at 2x1M: the earlier kernel
  and this one at every number of poses a thread P in {1, 2, 4}, each
  bitwise against the plain version (the count: equal); at 2x1M also the
  call as the earlier wrapper made it (a fill tensor and a stack of the
  two scalars on the device, then the kernel; a zeroed counter, then the
  count) beside this tree's wrappers;
- kernel 7 (the beam LUT field) at the beam path's fine (B=24, K=96,
  nq=51, C=64^2) and coarse (C=96^2) builds: the earlier kernel and this
  one at the rule's layout (``ops/beam_field.py::lut_tiles``) and at every
  cells a block in {64, 128, 256} (one a thread) and b a block in {2, 4},
  each bitwise against the plain version;
- kernel 2: the corr lookup at the staged SMALL (2x130 048 poses, the
  windowed 32x128x128 field) and BIG (2x1M, the 120x384x384 field)
  shapes, and ``gather_2d`` at the SMALL window table (2x130 048 pairs),
  the free mask of the "reject" retries (4x5000 and 4x100k pairs) and the
  range-table scorer's cell-major table (2x1500x360 pairs): the earlier
  kernel and this one at every P in {1, 2, 4}, each bitwise against the
  plain version.

- form (a) (the range-table scorer) at 2 x 1M and 2 x 1500 poses, and
  form (b) (the 3-D lidar scorer) at 2 x 100k poses x 5760 beams on the
  mixed cloud, every pose at START and the cloud ``[lidar3d]`` scores on a
  tracked scan (``chip_smoke.scored_cloud``), at G = 1, 2 and 4: commit
  4c0386c's ``scan_scores.cu`` (``--old-scan``: it and its
  ``stage_beams.cuh`` checked by sha256 like the sources above, built
  twice: as it is and with ``SCAN_ABLATION``'s throwaway edits) and this
  tree's, the earlier kernel and this one each bitwise against the plain
  version at the same G; beside (b), the distinct sectors and lines a
  warp load touches in each candidate layout of the volume
  (``voxel_sectors``).

This tree's kernels alone, with no earlier tree (``--kernels 7k,an``):

- ``7k``: kernel 7 at the fine and coarse builds of
  ``FilterConfig(sensor_model="beam", corr_window_cells=128)`` at its
  defaults (360 table bins, whose LUTs no block holds at once): the
  plan's chunks of bins (``ops/beam_field.py::lut_plan``) in one launch,
  other chunk counts and layouts, and the plan's chunks one launch each,
  each adding onto the partial sums in the output (a throwaway ablation:
  this tree's ``beam_field.cu`` built with ``LUT_LAUNCH_ABLATION``'s
  edits, which give the chunked kernel a bin range);
- ``an``: form (a)'s level form and per-pair f32 form at 2 x N poses, N
  from 1500 to 100k: the pose count where the level form overtakes
  (``ops/scan_scores.py::TABLE_LEVEL_MIN_POSES``).  Form a beside commit
  4c0386c's kernel also times this tree's per-pair form, and at 2 x 1500
  both with the count as the path passes it (int64, converted to int32 by
  a launch of its own each call).

Kernel 7 against the tree before its chunked form (``--kernels 7p``):

    git archive fc2823d mcmh_localization_tpu_torch/csrc | tar -x -C build/parent_field
    python3 chip_kernel_ab.py --old-field build/parent_field --kernels 7p

- ``7p``: kernel 7 at the beam point's fine and coarse builds (96 table
  bins, one chunk) at the rule's layout: commit fc2823d's
  ``beam_field.cu`` (sha256-checked, the C interface with the tile and
  without the chunk) and this tree's, each bitwise against the plain
  version.

``--kernels`` names the kernels to compare (all of the first list by
default); ``--old`` is needed for kernels 2 and 4-7, ``--old-scan`` for
forms a and b, ``--old-field`` for 7p.
Each case is timed in turns, the earlier kernel first and last (old, new
..., ... new, old), with ``chip_smoke.device_ms`` (median of 20 runs).  The
lines print the two readings of each kernel with the card's name and
power limit; the last line is a JSON object of them.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    MAP_CELLS,
    N_BEAMS,
    RES,
    SCAN_LEN,
    START,
    beam_point_config,
    check,
    circle_poses,
    device_ms,
    free_mask_indices,
    house_occupancy,
    lidar_scene,
    lut_inputs,
    mixed_cloud,
    nvidia_smi_line,
    rank_bound,
    scored_cloud,
    start_window,
)

LANES = (1, 2, 4, 8, 16, 32)
POSES = (1, 2, 4)
# kernel 7's layouts timed: (cells a block, b a block)
LUT_LAYOUTS = [(t, bp) for t in (64, 128, 256) for bp in (2, 4)]
# sha256 of commit 31a30c8's sources, the only ones whose C interface the
# bindings below match
OLD_SOURCES = {
    "likelihood.cu":
        "ba5ec1d8bffd6855b3917648eba45acb6c5bc7fc4f8c31ec0254d0d2c46cc534",
    "fused_score.cu":
        "3c357316a7fbaab0e8bb5c98dbb127d65ff0580bb791b7546d4ff3f08ad99178",
    "gather.cu":
        "5bd2ab6a417d6b9b90f9b48306d4cf943caecf87bd8fa0f3b50e9c208a6ffbef",
    "beam_field.cu":
        "f6819c434cacf1e441333c5c88c12cc08aa66ed108b8c0639c4167418b14f6ce",
    "rank.cu":
        "b13e5043a7d580947bea32a3c6a9f4cedd0c4901e96aa7377252ee1aa244581f",
}
# The earlier rank.cu is compiled inside this file, which also exposes its
# three device operations one at a time (its look-back words' memset, its
# running-max scan, its expansion), so kernel 4's time splits into them.
RANK_SPLIT_SHIM = r"""
#include "rank.cu"
extern "C" int ab_rank_memset(unsigned long long* scratch, int r, void* s) {
  return static_cast<int>(cudaMemsetAsync(
      scratch, 0, sizeof(unsigned long long) * (scan_tiles(r) + 1),
      static_cast<cudaStream_t>(s)));
}
extern "C" int ab_rank_scan(const int* bound, int r, int* mono,
                            unsigned long long* scratch, void* s) {
  const int tiles = scan_tiles(r);
  running_max_kernel<<<tiles, kScanThreads, 0, static_cast<cudaStream_t>(s)>>>(
      bound, r, mono, scratch, reinterpret_cast<unsigned int*>(scratch + tiles));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int ab_rank_expand(const int* mono, int r, int num_out,
                              const int* count, int* out, void* s) {
  expand_kernel<false><<<(num_out + kExpTile - 1) / kExpTile, kExpThreads, 0,
                         static_cast<cudaStream_t>(s)>>>(
      mono, r, nullptr, 0, num_out, count, nullptr, out);
  return static_cast<int>(cudaGetLastError());
}
"""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# sha256 of commit 4c0386c's kernel 2 fused forms (a) and (b) before their
# redesign: scan_scores.cu and the stage_beams.cuh it includes
OLD_SCAN_SOURCES = {
    "scan_scores.cu":
        "d252384b8add405e8f2ad4c00683f5d5e0f9c4248bc9510a0f993933335d6254",
    "stage_beams.cuh":
        "59e155fac0a33effa1f95d034367bdf333625a1b533db7caa5802568ee992bde",
}
# Throwaway ablations of those two forms, as edits of that scan_scores.cu
# (each pattern occurs once there): form (a) without the mixture's exp and
# log and with its second division a multiply (what the mixture costs);
# form (b) with the volume read replaced by a value made from its address
# (the index math kept: the issue floor).
SCAN_ABLATION = (
    ("const float z = __fdiv_rn(__fsub_rn(b.x, __ldg(row + k)), a.sigma);",
     "const float z = __fmul_rn(__fsub_rn(b.x, __ldg(row + k)), a.sigma);"),
    ("const float e = expf(__fmul_rn(-0.5f, __fmul_rn(z, z)));",
     "const float e = __fmul_rn(-0.5f, __fmul_rn(z, z));"),
    ("acc = __fadd_rn(acc, logf(fmaxf(prob, a.log_floor)));",
     "acc = __fadd_rn(acc, fmaxf(prob, a.log_floor));"),
    ("acc = __fadd_rn(acc, __ldg(volume + row * a.w + vx));",
     "acc = __fadd_rn(acc, __int2float_rn(static_cast<int>(row * a.w + vx)"
     " & 1));"),
)


# sha256 of commit fc2823d's kernel 7, the last before its chunked form
PARENT_FIELD_SOURCES = {
    "beam_field.cu":
        "3d2f7fae36522712949b91fcf2ffbb06fe40e0e1571a1715c4ab3d85e3abce95",
    "thread_runs.cuh":
        "752b197a88cecdb1584f3c053a85b4dc8340a399d9412ec0ac65f82f0eaf603e",
}
# Throwaway ablation of this tree's kernel 7: its chunked instance takes a
# bin range [g_lo, g_hi) and, past the first chunk, starts each sum from
# the output, so ``ab_lut_field_chunk`` (appended) runs one chunk a launch.
LUT_LAUNCH_ABLATION = (
    ("int c, int kg, bool vec_q, bool vec_s,",
     "int c, int kg, int g_lo, int g_hi, bool vec_q, bool vec_s,"),
    ("for (int p = 0; p < BPAR; ++p) acc[p] = 0.0f;",
     "for (int p = 0; p < BPAR; ++p) {\n"
     "    const int cl = c0 + static_cast<int>(threadIdx.x);\n"
     "    acc[p] = g_lo > 0 && cl < c && p < n_b\n"
     "                 ? out[static_cast<long long>(b0 + p) * c + cl]\n"
     "                 : 0.0f;\n  }"),
    ("for (int g0 = 0; g0 < k; g0 += kg) {",
     "for (int g0 = g_lo; g0 < g_hi; g0 += kg) {"),
    ("if (g0 > 0) __syncthreads();", "if (g0 > g_lo) __syncthreads();"),
    ("const int gn = min(kg, k - g0);", "const int gn = min(kg, g_hi - g0);"),
    ("qt, s, b, k, nq, c, kg, vec_q, vec_s, wd.origin, plane,",
     "qt, s, b, k, nq, c, kg, 0, k, vec_q, vec_s, wd.origin, plane,"),
)
LUT_LAUNCH_SHIM = r"""
// one launch of the chunked kernel over bins [g_lo, g_hi)
template <int BPAR>
int ab_chunk(const signed char* qt, const float* s, int b, int k, int nq,
             int c, int threads, int kg, int g_lo, int g_hi, float* out,
             cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(float)) * slot_floats(kg, nq) *
                       BPAR + kg * threads;
  cudaError_t err = allow_smem<BPAR, true>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_q = c % 16 == 0 && aligned_to(qt, 16);
  const bool vec_s = (k * nq) % 4 == 0 && (kg * nq) % 4 == 0 &&
                     (g_lo * nq) % 4 == 0 && aligned_to(s, 16);
  dim3 grid((c + threads - 1) / threads, (b + BPAR - 1) / BPAR);
  lut_field_kernel<BPAR, true><<<grid, threads, smem, st>>>(
      qt, s, b, k, nq, c, kg, g_lo, g_hi, vec_q, vec_s, nullptr,
      static_cast<long long>(c), 0, 0, out);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int ab_lut_field_chunk(const signed char* qt, const float* s,
                                  int b, int k, int nq, int c, int threads,
                                  int bpar, int kg, int g_lo, int g_hi,
                                  float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bpar == 4 ? ab_chunk<4>(qt, s, b, k, nq, c, threads, kg, g_lo, g_hi,
                                 out, st)
                   : ab_chunk<2>(qt, s, b, k, nq, c, threads, kg, g_lo, g_hi,
                                 out, st);
}
"""


def checked_sources(csrc: Path, digests: dict, commit: str, flag: str):
    """Refuses (before any build) a tree whose sources are not ``commit``'s."""
    for name, digest in digests.items():
        path = csrc / name
        got = hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() \
            else "missing"
        if got != digest:
            raise SystemExit(f"chip_kernel_ab: {path} is not commit {commit}'s "
                             f"(sha256 {got}); {flag} must hold that tree")


def build_library(so: Path, sources: list, include: Path) -> ctypes.CDLL:
    """``sources`` built by nvcc into the shared library ``so``, loaded."""
    from mcmh_localization_tpu_torch.ops import _cuda

    so.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(include), "-shared",
         "-o", str(so), *(str(x) for x in sources)],
        capture_output=True, text=True)
    check(res.returncode == 0, f"nvcc failed:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(so))


def parent_field_library(csrc: Path) -> ctypes.CDLL:
    """Commit fc2823d's kernel 7, built and bound; any other sources raise
    before the build."""
    from mcmh_localization_tpu_torch.ops import _cuda

    checked_sources(csrc, PARENT_FIELD_SOURCES, "fc2823d", "--old-field")
    lib = build_library(_cuda.BUILD_DIR.parent / "torch_kernels_ab"
                        / "libmcmh_field_parent.so", [csrc / "beam_field.cu"],
                        csrc)
    lib.mcmh_lut_field.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P]
    lib.mcmh_lut_field.restype = ctypes.c_int
    return lib


def chunk_launch_library() -> ctypes.CDLL:
    """This tree's kernel 7 with ``LUT_LAUNCH_ABLATION``'s edits and
    ``ab_lut_field_chunk``, built and bound."""
    from mcmh_localization_tpu_torch.ops import _cuda

    csrc = ROOT / "mcmh_localization_tpu_torch" / "csrc"
    src = (csrc / "beam_field.cu").read_text()
    for pattern, repl in LUT_LAUNCH_ABLATION:
        check(src.count(pattern) == 1, f"ablation pattern not found once: "
              f"{pattern}")
        src = src.replace(pattern, repl)
    out = _cuda.BUILD_DIR.parent / "torch_kernels_ab"
    out.mkdir(parents=True, exist_ok=True)
    ablated = out / "beam_field_chunk_launch.cu"
    ablated.write_text(src + LUT_LAUNCH_SHIM)
    lib = build_library(out / "libmcmh_field_chunk_launch.so", [ablated],
                        csrc)
    lib.ab_lut_field_chunk.argtypes = [_P, _P, *[_I] * 9, _P, _P]
    lib.ab_lut_field_chunk.restype = ctypes.c_int
    return lib


def old_library(csrc: Path) -> ctypes.CDLL:
    """Commit 31a30c8's kernels 2, 4, 5, 6 and 7, built and bound; any other
    sources raise before the build."""
    from mcmh_localization_tpu_torch.ops import _cuda

    for name, digest in OLD_SOURCES.items():
        path = csrc / name
        got = hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() \
            else "missing"
        if got != digest:
            raise SystemExit(f"chip_kernel_ab: {path} is not commit 31a30c8's "
                             f"(sha256 {got}); --old must hold that tree")
    so = _cuda.BUILD_DIR.parent / "torch_kernels_ab" / "libmcmh_old.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    shim = so.with_name("rank_split.cu")
    shim.write_text(RANK_SPLIT_SHIM)
    res = subprocess.run(
        [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(csrc), "-shared",
         "-o", str(so), str(shim),
         *(str(csrc / name) for name in OLD_SOURCES if name != "rank.cu")],
        capture_output=True, text=True)
    check(res.returncode == 0, f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, args in (
            ("mcmh_window_score", [_P, _P, _P, _I, _P, _P, _cuda.WindowArgs,
                                   _P, _P]),
            ("mcmh_window_escapees", [_P, _I, _cuda.WindowArgs, _P, _P]),
            ("mcmh_likelihood_scores", [_P, _I, _P, _P, _P, _I, _P, _I, _I,
                                        _F, _F, _F, _I, _P, _I, _F, _P, _P]),
            ("mcmh_gather_2d", [_P, _I, _I, _P, _P, _I, _P, _P]),
            ("mcmh_corr_lookup", [_P, _I, _I, _I, _P, _I, _P, _F, _F, _F, _F,
                                  _F, *[_I] * 10, _F, _F, _P, _P]),
            ("mcmh_lut_field", [_P, _P, _I, _I, _I, _I, _P, _P]),
            ("mcmh_rank_scratch_words", [_I]),
            ("mcmh_rank_in_sorted", [_P, _I, _I, _P, _P, _P, _P, _P]),
            ("ab_rank_memset", [_P, _I, _P]),
            ("ab_rank_scan", [_P, _I, _P, _P, _P]),
            ("ab_rank_expand", [_P, _I, _I, _P, _P, _P])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def old_scan_libraries(csrc: Path) -> tuple:
    """Commit 4c0386c's forms (a) and (b), built and bound twice: as they
    are, and with ``SCAN_ABLATION``'s edits; any other sources raise before
    the build."""
    from mcmh_localization_tpu_torch.ops import _cuda

    for name, digest in OLD_SCAN_SOURCES.items():
        path = csrc / name
        got = hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() \
            else "missing"
        if got != digest:
            raise SystemExit(f"chip_kernel_ab: {path} is not commit 4c0386c's "
                             f"(sha256 {got}); --old-scan must hold that tree")
    out = _cuda.BUILD_DIR.parent / "torch_kernels_ab"
    out.mkdir(parents=True, exist_ok=True)
    src = (csrc / "scan_scores.cu").read_text()
    for pattern, repl in SCAN_ABLATION:
        check(src.count(pattern) == 1, f"ablation pattern not found once: "
              f"{pattern}")
        src = src.replace(pattern, repl)
    ablated = out / "scan_scores_ablated.cu"
    ablated.write_text(src)
    jobs = [(out / "libmcmh_scan_old.so", csrc / "scan_scores.cu"),
            (out / "libmcmh_scan_ablated.so", ablated)]
    procs = [subprocess.Popen(
        [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(csrc), "-shared",
         "-o", str(so), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for so, cu in jobs]
    libs = []
    for (so, _), proc in zip(jobs, procs):
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.mcmh_table_scores.argtypes = [
            _P, _I, _P, _P, _P, _I, _P, _P, _cuda.TableArgs, _I, _P, _P]
        lib.mcmh_voxel_scores.argtypes = [
            _P, _I, _P, _P, _P, _P, _I, _P, _P, _cuda.VoxelArgs, _I, _I, _P,
            _P]
        for fn in (lib.mcmh_table_scores, lib.mcmh_voxel_scores):
            fn.restype = ctypes.c_int
        libs.append(lib)
    return tuple(libs)


def table_scorer_indices(gm, n: int, angles, n_theta: int, gen, cov):
    """(y, x) int32: the (cell, theta bin) pairs ``raycast_table_scores``
    reads from the cell-major range table for n poses around START and
    every beam (``models/range_table.py::raycast_table_scores``)."""
    from mcmh_localization_tpu_torch.filter.init import init_gaussian
    from mcmh_localization_tpu_torch.ops.gather import PI_F32
    from mcmh_localization_tpu_torch.utils.f32 import divide

    p = init_gaussian(START, cov, n, gm, generator=gen)
    mx, my = gm.world_to_grid(p[:, 0], p[:, 1])
    cell = my.clamp(0, gm.height - 1) * gm.width + mx.clamp(0, gm.width - 1)
    k = torch.floor(divide(p[:, 2][:, None] + angles[None, :] + PI_F32,
                           2.0 * math.pi / n_theta)).to(torch.int32) % n_theta
    m = angles.shape[0]
    return (cell[:, None].expand(n, m).reshape(-1).to(torch.int32).contiguous(),
            k.reshape(-1).contiguous())


def voxel_sectors(parts, u, v, zrow, live, geo, lanes: int,
                  n_poses: int = 4096) -> dict:
    """{layout: (sectors, lines)}: the mean distinct 32-byte sectors and
    128-byte lines a warp load of form (b) touches, over the reads of the
    first ``n_poses`` poses at ``lanes`` lanes a pose (a warp's 32 lanes
    read 32 / G poses x G consecutive live beams at once; a load with no
    read in the volume is left out), in each candidate layout of the
    volume: f32 and 16-bit row-major planes, and 16-bit planes of 4 x 4
    quads (a sector each), a line four of them as an 8 x 8 tile or as four
    bricks in a row (the level form's layout)."""
    p = parts[:n_poses]
    ul, vl = u[live], v[live]
    plane = (zrow[live] // geo.h).long()
    c, s = torch.cos(p[:, 2])[:, None], torch.sin(p[:, 2])[:, None]
    lx = p[:, 0][:, None] + c * ul[None, :] - s * vl[None, :]
    ly = p[:, 1][:, None] + s * ul[None, :] + c * vl[None, :]
    vx = torch.floor((lx - geo.origin_x) * geo.inv).long()
    vy = torch.floor((ly - geo.origin_y) * geo.inv).long()
    inb = (vx >= 0) & (vx < geo.w) & (vy >= 0) & (vy < geo.h)
    m = ul.numel()
    steps = -(-m // lanes)
    pad = steps * lanes - m
    hp, wp = -(-geo.h // 8) * 8, -(-geo.w // 8) * 8
    z = plane[None, :].expand_as(vx)
    # the 4 x 4 quads' sectors: a line is four of them, as an 8 x 8 tile
    # or as four bricks in a row
    quads = ((z * (hp // 4) + (vy >> 2)) * (wp // 4) + (vx >> 2)) * 32
    layouts = {
        "f32 row-major": (((z * geo.h + vy) * geo.w + vx) * 4, None),
        "u16 row-major": (((z * geo.h + vy) * geo.w + vx) * 2, None),
        "u16 8x8 tiles of 4x4 sectors": (
            quads, (z * (hp // 8) + (vy >> 3)) * (wp // 8) + (vx >> 3)),
        "u16 4x4 bricks, row-major": (quads, quads // 128),
    }
    out = {}
    for name, (addr, lines) in layouts.items():
        per = []
        for ids in (addr // 32, addr // 128 if lines is None else lines):
            ids = torch.where(inb, ids, -1)
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
            # (warps, 32 / G poses, steps, G) -> (warps, steps, 32)
            ids = ids.reshape(-1, 32 // lanes, steps, lanes).permute(
                0, 2, 1, 3).reshape(-1, 32)
            srt = ids.sort(dim=1).values
            first = torch.ones_like(srt[:, :1], dtype=torch.bool)
            new = torch.cat([first, srt[:, 1:] != srt[:, :-1]], dim=1)
            distinct = (new & (srt >= 0)).sum(dim=1)
            used = distinct > 0
            per.append(float(distinct[used].double().mean()))
        out[name] = tuple(per)
    return out


def in_turns(calls: dict) -> dict:
    """{name: [first, second]} device ms: the calls in order, then in
    reverse order."""
    order = list(calls) + list(reversed(calls))
    got = {name: [] for name in calls}
    for name in order:
        got[name].append(device_ms(calls[name]))
    return got


def report(tag: str, times: dict, results: list) -> None:
    first = next(iter(times))
    old = sum(times[first]) / 2
    for name, (a, b) in times.items():
        mean = (a + b) / 2
        print(f"[ab] {tag} {name}: {a:.4f} / {b:.4f} ms "
              f"({old / mean:.2f}x the {first}) on {nvidia_smi_line()}")
    results.append({"case": tag, "ms": times})


def bitwise_calls(tag: str, calls: dict, want: torch.Tensor) -> None:
    """Each call's output equal to ``want`` (the plain version's)."""
    for name, call in calls.items():
        check(torch.equal(call(), want), f"{tag} {name} != plain")
    print(f"[ab] {tag}: every variant bitwise")


def compare_form_a(libs, gm, beam, ranges, angles, cov, gen,
                   results) -> None:
    """Form (a), the range-table scorer, at the staged beam BIG program's 2 x
    1M poses and the [beam] table run's 2 x 1500 (mixed clouds, the house
    scan at START, the beam point's 96-bin table, "sum"): commit 4c0386c's
    kernel, its ablation without the mixture's exp, log and second
    division, and this tree's (the table in its uint8 level form), at the
    lanes the rule gives; the earlier kernel and this one bitwise against
    the plain version (whose level form is bitwise its per-pair form)."""
    from mcmh_localization_tpu_torch.models.range_table import (
        beam_mixture,
        table_cell_major,
    )
    from mcmh_localization_tpu_torch.ops import _cuda, scan_scores
    from mcmh_localization_tpu_torch.ops.likelihood import lanes_per_particle

    old, ablated = libs
    cfg = beam.config
    dev = ranges.device
    stream = torch.cuda.current_stream().cuda_stream
    tcm = table_cell_major(beam.log_field.table)
    table = scan_scores.table_levels(tcm)
    per_pair = scan_scores.TableLevels(None, None, tcm)
    valid = torch.isfinite(ranges) & (ranges < cfg.max_range)
    cnt = valid.sum().to(torch.int32)
    geo = scan_scores.TableGeometry(gm.origin_xy[0], gm.origin_xy[1], gm.res,
                                    gm.height, gm.width,
                                    cfg.beam_table_n_theta)
    mix = beam_mixture(cfg)
    targs = scan_scores.table_args(geo, mix, "sum")
    for n in (1_000_000, 1500):
        parts = mixed_cloud(2 * n, gm, cov, gen)
        g = lanes_per_particle(2 * n)
        out = torch.empty(2 * n, device=dev)

        def old_call(lib, lanes=g):
            def call():
                check(lib.mcmh_table_scores(
                    parts.data_ptr(), 2 * n, ranges.data_ptr(),
                    angles.data_ptr(), valid.data_ptr(), ranges.shape[0],
                    tcm.data_ptr(), cnt.data_ptr(), targs, lanes,
                    out.data_ptr(), stream) == 0, "launch failed")
                return out
            return call

        args = (parts, ranges, angles, valid, table, geo, mix, cnt, "sum")
        calls = {"old": old_call(old),
                 "new": lambda: scan_scores.table_scores(*args),
                 "new, per-pair form": functools.partial(
                     scan_scores.table_scores, parts, ranges, angles, valid,
                     per_pair, geo, mix, cnt, "sum")}
        tag = (f"table_scores N=2x{n} M={ranges.shape[0]} "
               f"({int(cnt)} valid) K={geo.n_theta} G={g}")
        want = scan_scores.table_scores_plain(*args)
        check(torch.equal(want, scan_scores.table_scores_plain(
            parts, ranges, angles, valid, per_pair, geo, mix, cnt, "sum")),
            f"{tag}: the level form's plain version != the per-pair form's")
        bitwise_calls(tag, calls, want)
        calls["ablation: no exp, log or second division"] = old_call(ablated)
        if n == 1500:
            # the count as raycast_table_scores passes it: int64, which the
            # wrapper converts with a launch of its own each call
            cnt64 = valid.sum()
            calls["old, with the int64 count's conversion"] = (
                lambda call=old_call(old): (cnt64.to(torch.int32), call())[1])
            calls["new, per-pair form, int64 count"] = functools.partial(
                scan_scores.table_scores, parts, ranges, angles, valid,
                per_pair, geo, mix, cnt64, "sum")
            check(torch.equal(calls["new, per-pair form, int64 count"](),
                              want), f"{tag}: int64 count != plain")
        report(tag, in_turns(calls), results)
        del parts


def compare_lut_chunks(gm, ranges, angles, results) -> None:
    """Kernel 7 at the fine (B = K = 360 over 128^2 cells) and coarse (36
    over 96^2) builds of ``FilterConfig(sensor_model="beam",
    corr_window_cells=128)`` at its defaults, where a block cannot stage
    all 360 bins: the plan's layout and chunks (``lut_plan``), the same
    chunks with one launch a chunk, more and smaller chunks (more blocks an
    SM), and two b over 128 cells a block, in one chunk where that fits;
    each bitwise against the plain version.  One launch a chunk runs
    ``chunk_launch_library``'s ablation."""
    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.filter.step import make_model
    from mcmh_localization_tpu_torch.ops import _cuda
    from mcmh_localization_tpu_torch.ops.beam_field import (
        MAX_SMEM_BYTES,
        LutTile,
        lut_chunks,
        lut_field_plain,
        lut_plan,
        lut_smem_bytes,
    )

    new = _cuda.library()
    per_launch_lib = chunk_launch_library()
    stream = torch.cuda.current_stream().cuda_stream
    model = make_model(FilterConfig(sensor_model="beam", corr_window_cells=128,
                                    initialized=True, initial_pose=START), gm)
    for tag, qt, s_lut in lut_inputs(gm, model, ranges, angles):
        b, k, nq = s_lut.shape
        c = qt.shape[1]
        out = torch.empty((b, c), device=ranges.device)

        def call_of(tile, chunk, per_launch=False):
            def call():
                if not per_launch:
                    check(new.mcmh_lut_field(
                        qt.data_ptr(), s_lut.data_ptr(), b, k, nq, c, *tile,
                        chunk, out.data_ptr(), stream) == 0, "launch failed")
                for g0, g1 in lut_chunks(k, chunk) if per_launch else ():
                    check(per_launch_lib.ab_lut_field_chunk(
                        qt.data_ptr(), s_lut.data_ptr(), b, k, nq, c, *tile,
                        chunk, g0, g1, out.data_ptr(), stream) == 0,
                        "launch failed")
                return out
            return call

        plan = lut_plan(b, k, nq, c)
        calls = {f"plan {tuple(plan.tile)} {len(lut_chunks(k, plan.chunk))} "
                 f"chunks of {plan.chunk}": call_of(*plan),
                 "plan, one launch a chunk (ablation)": call_of(
                     *plan, per_launch=True)}
        for tile in (plan.tile, LutTile(128, 2)):
            for n in (1, 2, 3, 4, 6, 8, 12, 16):
                chunk = -(-(-(-k // n)) // 4) * 4
                if (lut_smem_bytes(chunk, nq, tile) <= MAX_SMEM_BYTES
                        and (tile, chunk) != tuple(plan)):
                    calls[f"{tuple(tile)} {len(lut_chunks(k, chunk))} chunks "
                          f"of {chunk}"] = call_of(tile, chunk)
        tag = f"lut_field K=360 {tag} B={b} K={k} nq={nq} C={c}"
        bitwise_calls(tag, calls, lut_field_plain(qt, s_lut))
        report(tag, in_turns(calls), results)


def compare_lut_parent(lib, gm, beam, ranges, angles, results) -> None:
    """Kernel 7 at the beam point's fine and coarse builds (96 table bins,
    all staged at once): commit fc2823d's kernel and this tree's, at the
    rule's layout, through their C entry points on the same inputs; each
    bitwise against the plain version."""
    from mcmh_localization_tpu_torch.ops import _cuda
    from mcmh_localization_tpu_torch.ops.beam_field import (
        lut_field_plain,
        lut_plan,
    )

    new = _cuda.library()
    stream = torch.cuda.current_stream().cuda_stream
    for tag, qt, s_lut in lut_inputs(gm, beam, ranges, angles):
        b, k, nq = s_lut.shape
        c = qt.shape[1]
        out = torch.empty((b, c), device=ranges.device)
        plan = lut_plan(b, k, nq, c)
        check(plan.chunk == k, f"lut_field {tag}: the plan chunks 96 bins")

        def parent():
            check(lib.mcmh_lut_field(qt.data_ptr(), s_lut.data_ptr(), b, k,
                                     nq, c, *plan.tile, out.data_ptr(),
                                     stream) == 0, "launch failed")
            return out

        def this_tree():
            check(new.mcmh_lut_field(qt.data_ptr(), s_lut.data_ptr(), b, k,
                                     nq, c, *plan.tile, plan.chunk,
                                     out.data_ptr(), stream) == 0,
                  "launch failed")
            return out

        calls = {"fc2823d": parent, "this tree": this_tree}
        tag = (f"lut_field {tag} B={b} K={k} nq={nq} C={c} "
               f"{tuple(plan.tile)}")
        bitwise_calls(tag, calls, lut_field_plain(qt, s_lut))
        report(tag, in_turns(calls), results)


def compare_form_a_sizes(gm, beam, ranges, angles, cov, gen, results) -> None:
    """Form (a)'s two forms of this tree, the level form (uint8 index and
    per-scan LUT) and the per-pair f32 table, in turns at 2 x N poses for N
    from the [beam] table run's 1500 up to 100k (mixed clouds, the house
    scan at START, the beam point's 96-bin table, "sum"): where the level
    form overtakes (``scan_scores.TABLE_LEVEL_MIN_POSES``); each bitwise
    against the plain version."""
    from mcmh_localization_tpu_torch.models.range_table import (
        beam_mixture,
        table_cell_major,
    )
    from mcmh_localization_tpu_torch.ops import scan_scores
    from mcmh_localization_tpu_torch.ops.likelihood import lanes_per_particle

    cfg = beam.config
    tcm = table_cell_major(beam.log_field.table)
    forms = {"level form": scan_scores.table_levels(tcm),
             "per-pair form": scan_scores.TableLevels(None, None, tcm)}
    valid = torch.isfinite(ranges) & (ranges < cfg.max_range)
    cnt = valid.sum().to(torch.int32)
    geo = scan_scores.TableGeometry(gm.origin_xy[0], gm.origin_xy[1], gm.res,
                                    gm.height, gm.width,
                                    cfg.beam_table_n_theta)
    mix = beam_mixture(cfg)
    for n in (1500, 5000, 10_000, 20_000, 50_000, 100_000):
        parts = mixed_cloud(2 * n, gm, cov, gen)
        calls = {name: functools.partial(
            scan_scores.table_scores, parts, ranges, angles, valid, table,
            geo, mix, cnt, "sum") for name, table in forms.items()}
        tag = (f"table_scores N=2x{n} M={ranges.shape[0]} ({int(cnt)} valid) "
               f"K={geo.n_theta} G={lanes_per_particle(2 * n)}, this tree's "
               "two forms")
        bitwise_calls(tag, calls, scan_scores.table_scores_plain(
            parts, ranges, angles, valid, forms["per-pair form"], geo, mix,
            cnt, "sum"))
        report(tag, in_turns(calls), results)


def compare_form_b(libs, dev, gen, results) -> None:
    """Form (b), the 3-D lidar scorer, at the [lidar3d] shape (2 x 100k
    poses, 5760 beams, the building's log-mixture volume) on three clouds:
    the [kernel] mixed cloud, every pose at START, and the cloud the
    [lidar3d] filter scores on a tracked scan (captured after two laps, in
    its slot order).  At G = 1, 2 and 4: commit 4c0386c's kernel (the f32
    volume), its ablation with the volume read replaced by a value made
    from the read's address, and this tree's (the level form); the earlier
    kernel and this one bitwise against the plain version at the same G.  Beside them the distinct
    sectors and lines a warp load touches in each candidate layout."""
    from mcmh_localization_tpu_torch.models.sensor3d import (
        scan_beams,
        voxel_geometry,
    )
    from mcmh_localization_tpu_torch.ops import _cuda, scan_scores

    old, ablated = libs
    new = _cuda.library()
    stream = torch.cuda.current_stream().cuda_stream
    rot = math.pi / SCAN_LEN
    delta = (rot, 0.05, rot)
    vm, nav, cfg, lidar, directions, scans = lidar_scene(
        dev, circle_poses(delta))
    deltas = torch.tensor([delta] * SCAN_LEN, dtype=torch.float32, device=dev)
    st = lidar.init(0)
    for _ in range(2):
        st, _ = lidar.run(st, scans, directions, deltas)
    volume = lidar.log_field.log_volume
    levels = lidar.log_field.levels
    geo = voxel_geometry(vm)
    u, v, zrow, live, count = scan_beams(scans[0], directions, vm, cfg,
                                         cfg.lidar3d_sensor_z)
    cnt = count.to(torch.int32)
    vargs = scan_scores.voxel_args(geo, cfg.score_aggregation)
    n = 2 * 100_000
    clouds = {
        "mixed": mixed_cloud(n, nav, torch.diag(torch.tensor(
            cfg.initial_cov)), torch.Generator(device=dev).manual_seed(17)),
        "all at START": torch.tensor(START, device=dev).expand(n, 3)
        .contiguous(),
        "resampled": scored_cloud(lidar, st, scans[0], directions,
                                  deltas[0]).contiguous(),
    }
    m = u.shape[0]
    print(f"[ab] voxel_scores: {int(live.sum())} live of {m} beams "
          f"({int(count)} valid), volume {tuple(volume.shape)} in "
          f"{levels.levels.numel()} levels")
    for cname, parts in clouds.items():
        check(parts.shape == (n, 3), f"{cname} cloud {tuple(parts.shape)}")
        out = torch.empty(n, device=dev)
        for g in (1, 2, 4):
            def old_call(lib, lanes=g):
                def call():
                    check(lib.mcmh_voxel_scores(
                        parts.data_ptr(), n, u.data_ptr(), v.data_ptr(),
                        zrow.data_ptr(), live.data_ptr(), m,
                        volume.data_ptr(), cnt.data_ptr(), vargs, lanes,
                        _cuda.SM_COUNT, out.data_ptr(), stream) == 0,
                        "launch failed")
                    return out
                return call

            def new_call(lanes=g):
                check(new.mcmh_voxel_scores(
                    parts.data_ptr(), n, u.data_ptr(), v.data_ptr(),
                    zrow.data_ptr(), live.data_ptr(), m, None,
                    levels.index.data_ptr(), levels.levels.data_ptr(),
                    levels.levels.numel(), cnt.data_ptr(), vargs, lanes,
                    _cuda.SM_COUNT, out.data_ptr(), stream) == 0,
                    "launch failed")
                return out

            args = (parts, u, v, zrow, live, levels, geo, count,
                    cfg.score_aggregation)
            calls = {"old": old_call(old), "new": new_call}
            tag = (f"voxel_scores {cname} cloud N={n} G={g} (rule: "
                   f"G={scan_scores.voxel_lanes(n)})")
            bitwise_calls(tag, calls, scan_scores.voxel_scores_plain(
                *args, lanes=g))
            calls["ablation: the read a constant"] = old_call(ablated)
            report(tag, in_turns(calls), results)
        for g in (1, 2):
            sectors = voxel_sectors(parts, u, v, zrow, live, geo, g)
            for layout, (sec, line) in sectors.items():
                print(f"[ab] voxel_scores {cname} cloud G={g} {layout}: "
                      f"{sec:.2f} sectors, {line:.2f} lines a warp load")
            results.append({"case": f"voxel sectors {cname} G={g}",
                            "sectors_lines": sectors})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path,
                    help="a tree holding commit 31a30c8's "
                         "mcmh_localization_tpu_torch/csrc (kernels 2, 4-7)")
    ap.add_argument("--old-scan", type=Path,
                    help="a tree holding commit 4c0386c's "
                         "mcmh_localization_tpu_torch/csrc (forms a and b)")
    ap.add_argument("--old-field", type=Path,
                    help="a tree holding commit fc2823d's "
                         "mcmh_localization_tpu_torch/csrc (kernel 7p)")
    ap.add_argument("--kernels", default="2,4,5,6,7,a,b",
                    help="the kernels to compare: 2, 4-7 by number, kernel "
                         "2's fused forms as a and b (default all); this "
                         "tree's alone: 7k (kernel 7's chunks at 360 table "
                         "bins) and an (form (a)'s two forms over N); 7p "
                         "(kernel 7 against fc2823d's)")
    args = ap.parse_args(argv)
    names = set(args.kernels.split(","))
    alone = names & {"7k", "an"}
    forms = names & {"a", "b"}
    parent_field = "7p" in names
    kernels = {int(k) for k in names - forms - alone - {"7p"}}
    if kernels and args.old is None:
        ap.error("--old is needed for kernels 2 and 4-7")
    if forms and args.old_scan is None:
        ap.error("--old-scan is needed for forms a and b")
    if parent_field and args.old_field is None:
        ap.error("--old-field is needed for 7p")
    if not torch.cuda.is_available():
        print("chip_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    print(f"[device] {smi}")

    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.filter.init import init_gaussian
    from mcmh_localization_tpu_torch.filter.step import make_model, state_size
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map
    from mcmh_localization_tpu_torch.models.corr_field import (
        coarse_shape,
        window_geometry,
    )
    from mcmh_localization_tpu_torch.models.range_table import (
        _beam_geometry,
        table_cell_major,
    )
    from mcmh_localization_tpu_torch.models.sensor import (
        BLIND_SCORE,
        log_likelihood_field,
        raycast,
    )
    from mcmh_localization_tpu_torch.ops import _cuda
    from mcmh_localization_tpu_torch.ops._cuda import poses_per_thread
    from mcmh_localization_tpu_torch.ops.beam_field import (
        lut_field_plain,
        lut_tiles,
    )
    from mcmh_localization_tpu_torch.ops.fused_score import (
        window_args,
        window_escapees,
        window_escapees_plain,
        window_score,
        window_score_plain,
    )
    from mcmh_localization_tpu_torch.ops.gather import (
        LookupGeometry,
        corr_lookup_indices,
        corr_lookup_plain,
        gather_2d_plain,
        lookup_args,
    )
    from mcmh_localization_tpu_torch.ops.likelihood import (
        lanes_per_particle,
        likelihood_scores_plain,
    )
    from mcmh_localization_tpu_torch.ops.rank import (
        rank_in_sorted,
        rank_in_sorted_plain,
    )

    old = (old_library(args.old / "mcmh_localization_tpu_torch" / "csrc")
           if kernels else None)
    old_scan = (old_scan_libraries(args.old_scan / "mcmh_localization_tpu_torch"
                                   / "csrc") if forms else None)
    field_parent = (parent_field_library(
        args.old_field / "mcmh_localization_tpu_torch" / "csrc")
        if parent_field else None)
    dev = torch.device("cuda")
    half = MAP_CELLS * RES / 2
    gm = build_grid_map(house_occupancy(), RES, (-half, -half), device=dev)
    cfg = FilterConfig(mode="AMHAMCL", initialized=True, initial_pose=START,
                       corr_window_cells=128, corr_theta_window_bins=32)
    angles = torch.linspace(-math.pi, math.pi, N_BEAMS, device=dev)
    ranges = raycast(torch.tensor(START[:2], device=dev), START[2] + angles,
                     gm, cfg.max_range, hit_unknown=True)
    valid = torch.isfinite(ranges) & (ranges < cfg.max_range)
    safe_r = torch.where(valid, ranges, 0.0)
    u = (safe_r * torch.cos(angles)).contiguous()
    v = (safe_r * torch.sin(angles)).contiguous()
    log_field = log_likelihood_field(gm, cfg).contiguous()
    cnt = valid.sum().to(torch.int32)
    denom = cnt.clamp(min=1).to(torch.float32)
    cov = torch.diag(torch.tensor(cfg.initial_cov))
    gen = torch.Generator(device=dev).manual_seed(17)
    stream = torch.cuda.current_stream().cuda_stream
    results: list = []
    h, w = log_field.shape
    m = u.shape[0]
    print(f"[ab] scan: {int(cnt)} valid beams of {m}")
    win, tw = cfg.corr_window_cells, cfg.corr_theta_window_bins
    ox0, oy0, kstart = start_window(gm, cfg.corr_n_theta, win, tw)
    kc, hc, wc = coarse_shape(cfg, h, w)

    if 4 in kernels:
        # kernel 4: the earlier kernel whole and its three device operations
        # apart, beside this tree's, on the raw bound of a 1M draw
        n4 = 1_000_000
        cnt4 = torch.tensor(n4, dtype=torch.int32, device=dev)
        words = old.mcmh_rank_scratch_words(n4)
        mono = torch.empty(n4, dtype=torch.int32, device=dev)
        scratch = torch.empty(words, dtype=torch.int64, device=dev)
        for kind in ("uniform", "heavy middle"):
            bound = rank_bound(kind, n4, n4, gen)
            for num_out in (n4, 131_072):
                out = torch.empty(num_out, dtype=torch.int32, device=dev)

                def old_whole():
                    check(old.mcmh_rank_in_sorted(
                        bound.data_ptr(), n4, num_out, cnt4.data_ptr(),
                        mono.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                        stream) == 0, "launch failed")
                    return out

                def old_memset():
                    check(old.ab_rank_memset(scratch.data_ptr(), n4, stream) == 0,
                          "launch failed")

                def old_scan():
                    old_memset()
                    check(old.ab_rank_scan(bound.data_ptr(), n4, mono.data_ptr(),
                                           scratch.data_ptr(), stream) == 0,
                          "launch failed")

                def old_expand():
                    check(old.ab_rank_expand(mono.data_ptr(), n4, num_out,
                                             cnt4.data_ptr(), out.data_ptr(),
                                             stream) == 0, "launch failed")
                    return out

                tag = f"rank_in_sorted {kind} R={n4} num_out={num_out}"
                want = rank_in_sorted_plain(bound, num_out, cnt4)
                check(torch.equal(old_whole(), want), f"{tag}: old != plain")
                old_scan()
                check(torch.equal(old_expand(), want), f"{tag}: old split != plain")
                split = {"memset": device_ms(old_memset),
                         "memset+scan": device_ms(old_scan),
                         "expansion": device_ms(old_expand)}
                print(f"[ab] {tag} old split: memset {split['memset']:.4f}, scan "
                      f"{split['memset+scan'] - split['memset']:.4f} (with the "
                      f"memset {split['memset+scan']:.4f}), expansion "
                      f"{split['expansion']:.4f} ms on {smi}")
                results.append({"case": tag + " old split", "ms": split})
                calls = {"old": old_whole,
                         "new": lambda: rank_in_sorted(bound, num_out, cnt4)}
                bitwise_calls(tag, calls, want)
                report(tag, in_turns(calls), results)

    new = _cuda.library()
    beam = (make_model(beam_point_config(), gm)
            if kernels & {2, 7} or "a" in forms or "an" in alone
            or parent_field else None)
    if 6 in kernels:
        # kernel 6
        def exact_call(lib, parts, scale, div, lanes=None):
            out = torch.empty(parts.shape[0], device=dev)
            tail = () if lanes is None else (lanes,)

            def call():
                code = lib.mcmh_likelihood_scores(
                    parts.data_ptr(), parts.shape[0], u.data_ptr(), v.data_ptr(),
                    valid.data_ptr(), m, log_field.data_ptr(), h, w,
                    gm.origin_xy[0], gm.origin_xy[1], scale, int(div),
                    cnt.data_ptr(), 0, BLIND_SCORE, *tail, out.data_ptr(), stream)
                check(code == 0, f"launch failed ({code})")
                return out
            return call

        for n6 in (100_000, 1500):
            parts = init_gaussian(START, cov, 2 * n6, gm, generator=gen).contiguous()
            for div in (False, True):
                scale = gm.res if div else gm.inv_res
                a6 = (parts, u, v, valid, log_field, gm.origin_xy[0],
                      gm.origin_xy[1], scale, div, cnt, "mean")
                calls = {"old": exact_call(old, parts, scale, div)}
                ref = likelihood_scores_plain(*a6)
                err_old = float((calls["old"]().clone() - ref).abs().max())
                for g in LANES:
                    calls[f"G={g}"] = exact_call(new, parts, scale, div, g)
                    got = calls[f"G={g}"]().clone()
                    check(torch.equal(got, likelihood_scores_plain(*a6, lanes=g)),
                          f"exact N=2x{n6} div={div} G={g}: kernel != plain")
                tag = (f"likelihood_scores N=2x{n6} form={'div' if div else 'mul'}"
                       f" (rule: G={lanes_per_particle(2 * n6)})")
                print(f"[ab] {tag}: every G bitwise; the earlier kernel within "
                      f"{err_old:.3g} of the plain version")
                report(tag, in_turns(calls), results)

    if 5 in kernels:
        # kernel 5
        def window_calls(parts, geo, fine_t, coarse_t):
            out = torch.empty(parts.shape[0], device=dev)
            denom_fill = torch.stack([denom, torch.full((), -100.0, device=dev)])
            wa = window_args(geo)
            ptrs = (fine_t.data_ptr(), coarse_t.data_ptr(), parts.data_ptr(),
                    parts.shape[0])

            def call_old():
                check(old.mcmh_window_score(
                    *ptrs, denom_fill.data_ptr(), cnt.data_ptr(), wa,
                    out.data_ptr(), stream) == 0, "launch failed")
                return out

            def call_new(p):
                def call():
                    check(new.mcmh_window_score(
                        *ptrs, denom.data_ptr(), 0.0, None, -100.0, cnt.data_ptr(),
                        wa, p, out.data_ptr(), stream) == 0, "launch failed")
                    return out
                return call

            return {"old": call_old, **{f"P={p}": call_new(p) for p in POSES}}

        def escapee_calls(parts, geo):
            out = torch.zeros(1, dtype=torch.int32, device=dev)
            wa = window_args(geo)
            ptrs = (parts.data_ptr(), parts.shape[0], wa)

            def call_of(p):
                def call():
                    out.zero_()
                    code = (old.mcmh_window_escapees(*ptrs, out.data_ptr(), stream)
                            if p is None else new.mcmh_window_escapees(
                                *ptrs, p, out.data_ptr(), stream))
                    check(code == 0, "launch failed")
                    return out
                return call

            return {"old": call_of(None), **{f"P={p}": call_of(p) for p in POSES}}

        geo = window_geometry(gm, cfg, cfg.corr_n_theta, tw, win,
                              win)._replace(ox0=ox0, oy0=oy0, kstart=kstart)
        fine_t = torch.randn((win * tw, win), generator=gen, device=dev)
        coarse_t = torch.randn((hc * kc, wc), generator=gen, device=dev)
        big = mixed_cloud(2_000_000, gm, cov, gen)
        bw, btw, bk, bkc = 64, 24, 96, 24
        box0, boy0, bkstart = start_window(gm, bk, bw, btw)
        geo_b = _beam_geometry(gm, bk, btw, bkstart, bw, (box0, boy0),
                               (4, bkc, hc, wc))
        cases = [
            ("corr op forms N=2x1000000", big, geo, fine_t, coarse_t),
            ("corr op forms, misaligned base N=200003", big[1:200_004], geo,
             fine_t, coarse_t),
            ("beam op forms N=2x100000", mixed_cloud(200_000, gm, cov, gen),
             geo_b, torch.randn((bw * btw, bw), generator=gen, device=dev),
             torch.randn((hc * bkc, wc), generator=gen, device=dev)),
        ]
        for tag, parts, g, ft, ct in cases:
            calls = window_calls(parts, g, ft, ct)
            ref = window_score_plain(ft, ct, parts, g, denom, -100.0, count=cnt)
            for name, call in calls.items():
                check(torch.equal(call(), ref), f"window_score {tag} {name} != plain")
            tag = f"window_score {tag} (rule: P={poses_per_thread(parts.shape[0])})"
            print(f"[ab] {tag}: every P bitwise")
            report(tag, in_turns(calls), results)
        for tag, parts in (("N=2x1000000", big),
                           ("misaligned base N=200003", big[1:200_004])):
            calls = escapee_calls(parts, geo)
            want = int(window_escapees_plain(parts, geo))
            for name, call in calls.items():
                check(int(call()) == want, f"window_escapees {tag} {name} != plain")
            print(f"[ab] window_escapees {tag}: {want} escapees at every P")
            if not tag.startswith("misaligned"):
                report(f"window_escapees {tag} (rule: P="
                       f"{poses_per_thread(parts.shape[0])})", in_turns(calls),
                       results)

        # the calls as the wrappers make them at 2x1M: the earlier wrapper's
        # device work (a stack of the two scalars, then its kernel; a zeroed
        # counter, then its count) beside this tree's wrappers
        old_score = window_calls(big, geo, fine_t, coarse_t)["old"]
        old_count = escapee_calls(big, geo)["old"]
        score = {
            "old": lambda: (torch.stack([denom, torch.full((), -100.0,
                                                           device=dev)]),
                            old_score())[1],
            "new": lambda: window_score(fine_t, coarse_t, big, geo, denom, -100.0,
                                        count=cnt)}
        escape = {"old": old_count, "new": lambda: window_escapees(big, geo)}
        check(torch.equal(score["new"](), window_score_plain(
            fine_t, coarse_t, big, geo, denom, -100.0, count=cnt)),
            "window_score wrapper != plain")
        check(int(escape["new"]()) == int(window_escapees_plain(big, geo)),
              "window_escapees wrapper != plain")
        report("window_score corr op forms N=2x1000000, through the wrappers",
               in_turns(score), results)
        report("window_escapees N=2x1000000, through the wrappers",
               in_turns(escape), results)
        # yardsticks of the card's streaming rate on the same 24 MB of poses:
        # a read (sum) and a read and write (clone)
        report("yardsticks on the 2x1M poses",
               in_turns({"sum": lambda: big.sum(), "clone": big.clone}), results)

    if 7 in kernels:
        # kernel 7: the beam LUT field at the beam path's fine and coarse builds
        for tag, qt, s_lut in lut_inputs(gm, beam, ranges, angles):
            b, k, nq = s_lut.shape
            c = qt.shape[1]
            out = torch.empty((b, c), device=dev)

            def lut_call(lib, tile=None):
                extra = () if tile is None else tile

                def call():
                    check(lib.mcmh_lut_field(qt.data_ptr(), s_lut.data_ptr(), b, k,
                                             nq, c, *extra, out.data_ptr(),
                                             stream) == 0, "launch failed")
                    return out
                return call

            rule = lut_tiles(b, c)
            whole = (k,)  # every bin in one chunk
            calls = {"old": lut_call(old),
                     f"rule {tuple(rule)}": lut_call(new, (*rule, *whole))}
            calls.update({f"threads={t} bpar={bp}": lut_call(new, (t, bp,
                                                                   *whole))
                          for t, bp in LUT_LAYOUTS})
            tag = f"lut_field {tag} B={b} K={k} nq={nq} C={c}"
            bitwise_calls(tag, calls, lut_field_plain(qt, s_lut))
            report(tag, in_turns(calls), results)

    if 2 in kernels:
        # kernel 2: the corr lookup at the staged SMALL and BIG shapes
        def lookup_calls(field, parts, geo, agg):
            out = torch.empty(parts.shape[0], device=dev)
            args = lookup_args(field, parts, cnt, geo, agg, True)

            def call_of(p):
                def call():
                    tail = () if p is None else (p,)
                    code = (old if p is None else new).mcmh_corr_lookup(
                        *args, *tail, out.data_ptr(), stream)
                    check(code == 0, "launch failed")
                    return out
                return call

            return {"old": call_of(None), **{f"P={p}": call_of(p) for p in POSES}}

        n_small = 130_048
        geo_small = LookupGeometry(gm.origin_xy[0], gm.origin_xy[1], gm.inv_res,
                                   cfg.corr_n_theta, tw, win, win, h, w,
                                   kstart=kstart, window=(ox0, oy0))
        geo_big = LookupGeometry(gm.origin_xy[0], gm.origin_xy[1], gm.inv_res,
                                 cfg.corr_n_theta, cfg.corr_n_theta, h, w, h, w)
        field_small = torch.randn((tw, win, win), generator=gen, device=dev)
        small = init_gaussian(START, cov, 2 * n_small, gm, generator=gen)
        for tag, field, parts, geo, agg in (
                ("SMALL", field_small, small, geo_small, "mean"),
                ("BIG", torch.randn((cfg.corr_n_theta, h, w), generator=gen,
                                    device=dev),
                 init_gaussian(START, cov, 2_000_000, gm, generator=gen), geo_big,
                 "sum")):
            calls = lookup_calls(field, parts, geo, agg)
            tag = (f"corr_lookup {tag} N={parts.shape[0]} (rule: "
                   f"P={_cuda.poses_per_thread(parts.shape[0])})")
            bitwise_calls(tag, calls,
                          corr_lookup_plain(field, parts, cnt, geo, agg, True))
            report(tag, in_turns(calls), results)

        # kernel 2: gather_2d at the paths' shapes
        def gather_calls(table, y, x):
            out = torch.empty(y.numel(), device=dev)
            args = (table.data_ptr(), *table.shape, y.data_ptr(), x.data_ptr(),
                    y.numel())

            def call_of(p):
                def call():
                    tail = () if p is None else (p,)
                    code = (old if p is None else new).mcmh_gather_2d(
                        *args, *tail, out.data_ptr(), stream)
                    check(code == 0, "launch failed")
                    return out
                return call

            return {"old": call_of(None), **{f"P={p}": call_of(p) for p in POSES}}

        tbin, myc, mxc, _, _ = corr_lookup_indices(small, geo_small)
        gather_cases = [("SMALL window", field_small.reshape(tw * win, win),
                         (tbin * win + myc).to(torch.int32).contiguous(),
                         mxc.to(torch.int32).contiguous())]
        retries = FilterConfig().motion_retries
        for n_max in (state_size(FilterConfig()), 100_000):
            gather_cases.append((f"free mask, {retries} retries x {n_max}",
                                 gm.free_mask,
                                 *free_mask_indices(gm, retries * n_max, gen, cov)))
        gather_cases.append((
            "table scorer, 2 x 1500 poses x 360 beams",
            table_cell_major(beam.log_field.table),
            *table_scorer_indices(gm, 2 * 1500, angles,
                                  beam.config.beam_table_n_theta, gen, cov)))
        for tag, table, y, x in gather_cases:
            calls = gather_calls(table, y, x)
            tag = (f"gather_2d {tag} table {tuple(table.shape)} N={y.numel()} "
                   f"(rule: P={_cuda.poses_per_thread(y.numel())})")
            bitwise_calls(tag, calls, gather_2d_plain(table, y, x))
            report(tag, in_turns(calls), results)

    if parent_field:
        compare_lut_parent(field_parent, gm, beam, ranges, angles, results)
    if "7k" in alone:
        compare_lut_chunks(gm, ranges, angles, results)
    if "an" in alone:
        compare_form_a_sizes(gm, beam, ranges, angles, cov, gen, results)
    if "a" in forms:
        compare_form_a(old_scan, gm, beam, ranges, angles, cov, gen, results)
    if "b" in forms:
        compare_form_b(old_scan, dev, gen, results)

    del beam
    print(f"[ab] on {smi}")
    print(json.dumps({"device": smi, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
