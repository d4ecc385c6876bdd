#!/usr/bin/env python3
"""Kernel 7's chunk plans and form (a)'s two table forms of the PyTorch/CUDA
port, timed against each other on one NVIDIA GPU, in turns.

    python3 chip_kernel_ab.py [--kernels 7k,an]

On the inputs of ``chip_smoke.py`` (its house map, scan and clouds and its
beam point), every case is called on the same precomputed arguments and
checked bitwise against the plain version before it is timed:

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
  (``ops/scan_scores.py::TABLE_LEVEL_MIN_POSES``).

``--kernels`` names the comparisons to run (both by default).  Each case is
timed in turns, first to last and back (a, b, ..., b, a), with
``chip_smoke.device_ms`` (median of 20 runs).  The lines print the two
readings of each case with the card's name and power limit; the last line
is a JSON object of them.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
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
    START,
    beam_point_config,
    check,
    device_ms,
    house_occupancy,
    lut_inputs,
    mixed_cloud,
    nvidia_smi_line,
)

_P, _I = ctypes.c_void_p, ctypes.c_int

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
    first_ms = sum(times[first]) / 2
    for name, (a, b) in times.items():
        mean = (a + b) / 2
        print(f"[ab] {tag} {name}: {a:.4f} / {b:.4f} ms "
              f"({first_ms / mean:.2f}x the {first}) on {nvidia_smi_line()}")
    results.append({"case": tag, "ms": times})


def bitwise_calls(tag: str, calls: dict, want: torch.Tensor) -> None:
    """Each call's output equal to ``want`` (the plain version's)."""
    for name, call in calls.items():
        check(torch.equal(call(), want), f"{tag} {name} != plain")
    print(f"[ab] {tag}: every variant bitwise")


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="7k,an",
                    help="the comparisons to run: 7k (kernel 7's chunks at "
                         "360 table bins) and an (form (a)'s two forms "
                         "over N); both by default")
    args = ap.parse_args(argv)
    names = set(args.kernels.split(","))
    unknown = names - {"7k", "an"}
    if unknown:
        ap.error(f"unknown comparisons {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    print(f"[device] {smi}")

    from mcmh_localization_tpu_torch.config import FilterConfig
    from mcmh_localization_tpu_torch.filter.step import make_model
    from mcmh_localization_tpu_torch.maps.grid_map import build_grid_map
    from mcmh_localization_tpu_torch.models.sensor import raycast

    dev = torch.device("cuda")
    half = MAP_CELLS * RES / 2
    gm = build_grid_map(house_occupancy(), RES, (-half, -half), device=dev)
    cfg = FilterConfig(mode="AMHAMCL", initialized=True, initial_pose=START,
                       corr_window_cells=128, corr_theta_window_bins=32)
    angles = torch.linspace(-math.pi, math.pi, N_BEAMS, device=dev)
    ranges = raycast(torch.tensor(START[:2], device=dev), START[2] + angles,
                     gm, cfg.max_range, hit_unknown=True)
    cov = torch.diag(torch.tensor(cfg.initial_cov))
    gen = torch.Generator(device=dev).manual_seed(17)
    results: list = []
    if "7k" in names:
        compare_lut_chunks(gm, ranges, angles, results)
    if "an" in names:
        beam = make_model(beam_point_config(), gm)
        compare_form_a_sizes(gm, beam, ranges, angles, cov, gen, results)
        del beam
    print(f"[ab] on {smi}")
    print(json.dumps({"device": smi, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
