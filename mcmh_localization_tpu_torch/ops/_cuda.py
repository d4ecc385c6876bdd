"""Build, load and count the port's hand-written CUDA kernels.

The ``csrc/*.cu`` sources compile with plain ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
link into one shared library with a C interface, loaded with ``ctypes``.
The build runs at first use, into ``build/torch_kernels/`` at the root of
the checkout (listed in ``.gitignore``), under a file name that carries a
hash of the sources and flags: an edited source rebuilds, an unchanged one
loads the library already built.

Every wrapper in ``ops/`` launches on ``torch.cuda.current_stream()``,
raises when the launch reports an error, and adds one to its launch count
(``launch_counts``) for each kernel it launches, where it launches them and
nowhere else.  While a step is being captured into a CUDA graph
(``ops/graph.py``) nothing launches: the counts go to the capture's own
tally, and each replay adds them (``add_launches``, ``add_replayed``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("corr_field_build.cu", "gather.cu", "rank.cu", "fused_score.cu",
           "likelihood.cu", "take.cu", "beam_field.cu", "scan_scores.cu",
           "edt.cu", "graph_cond.cu", "bin_lut.cu", "trace_stamp.cu")
HEADERS = ("thread_runs.cuh", "stage_beams.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add contraction: the index math must round like the
    # plain PyTorch version (the kernels also use explicit _rn intrinsics)
    "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC",
)

# The threads a launch aims for, about one wave of the card's (an H100 SXM:
# 132 SMs of 2048): the rule behind likelihood.py::lanes_per_particle and
# poses_per_thread.
FILL_THREADS = 1 << 18
# The SMs of an H100 SXM: beam_field.py::lut_tiles spreads its blocks over
# them, and scan_scores.py's two scorers cap their grids at the blocks they
# hold at once.
SM_COUNT = 132


def poses_per_thread(n: int) -> int:
    """P, the consecutive items (poses, index pairs) one thread of the
    fused_score.cu and gather.cu kernels takes: the largest of 4, 2 and 1
    that still gives ``n / P`` at least ``FILL_THREADS`` threads (more
    bytes in flight a thread where the work fills the card even so).
    Nonincreasing as ``n`` falls."""
    for p in (4, 2):
        if n >= p * FILL_THREADS:
            return p
    return 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class WindowArgs(ctypes.Structure):
    """csrc/fused_score.cu's ``WindowArgs``, passed by value."""

    _fields_ = [(name, _F) for name in (
        "origin_x", "origin_y", "fine_scale", "theta_scale", "pi_f", "res_c",
        "kc_scale", "blind_score")] + [(name, _I) for name in (
            "n_theta", "nbins", "kstart", "fh", "fw", "h", "w", "ox0", "oy0",
            "kc", "hc", "wc", "fine_div", "theta_div", "clip_before_window")]


class TableArgs(ctypes.Structure):
    """csrc/scan_scores.cu's ``TableArgs``, passed by value."""

    _fields_ = [(name, _F) for name in (
        "origin_x", "origin_y", "res", "pi_f", "dtheta", "sigma", "hit_norm",
        "z_hit", "z_floor", "log_floor", "blind_score")] + [
            (name, _I) for name in ("h", "w", "n_theta", "sum_aggregation")]


class VoxelArgs(ctypes.Structure):
    """csrc/scan_scores.cu's ``VoxelArgs``, passed by value."""

    _fields_ = [(name, _F) for name in (
        "origin_x", "origin_y", "inv", "blind_score")] + [
            (name, _I) for name in ("h", "w", "sum_aggregation")]


_SIGNATURES = {
    "mcmh_corr_field_build": (_P, _I, _I, _P, _P, _I, _I, _P, _I, _I, _I, _P,
                              _P),
    "mcmh_gather_2d": (_P, _I, _I, _P, _P, _I, _I, _P, _P),
    "mcmh_corr_lookup": (
        _P, _I, _I, _I, _P, _I, _P, _F, _F, _F, _F, _F, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _I, _F, _F, _I, _P, _P,
    ),
    "mcmh_corr_lookup_at": (
        _P, _I, _I, _I, _P, _I, _P, _F, _F, _F, _F, _F, _I, _I, _I, _P, _I,
        _I, _I, _I, _F, _F, _I, _P, _P,
    ),
    "mcmh_rank_scratch_words": (_I,),
    "mcmh_rank_workspace_words": (_I,),
    "mcmh_rank_piece_capacity": (_I, _I),
    "mcmh_rank_epoch_limit": (),
    "mcmh_rank_in_sorted": (_P, _I, _I, _P, ctypes.c_uint, _P, _P, _P, _P, _P),
    "mcmh_expand_sorted": (_P, _I, _P, _I, _I, _P, _P, _P, _P, _P),
    "mcmh_window_score": (
        _P, _P, _P, _I, _P, _F, _P, _F, _P, WindowArgs, _I, _P, _P,
    ),
    "mcmh_window_score_at": (
        _P, _P, _P, _I, _P, _F, _P, _F, _P, _P, _I, WindowArgs, _I, _P, _P,
    ),
    "mcmh_window_escapees": (_P, _I, WindowArgs, _I, _P, _P),
    "mcmh_window_escapees_at": (_P, _I, _P, _I, WindowArgs, _I, _P, _P),
    "mcmh_likelihood_scores": (
        _P, _I, _P, _P, _P, _I, _P, _I, _I, _F, _F, _F, _I, _P, _I, _F, _I,
        _P, _P,
    ),
    "mcmh_take_rows": (_P, _I, _I, _P, _I, _P, _P),
    "mcmh_squared_edt": (_P, _I, _I, _P, _P, _P),
    "mcmh_lut_field": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    "mcmh_lut_field_at": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P,
                          _P),
    "mcmh_bin_lut": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "mcmh_table_scores": (_P, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P,
                          TableArgs, _I, _I, _P, _P),
    "mcmh_voxel_scores": (_P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P,
                          VoxelArgs, _I, _I, _P, _P),
    "mcmh_cond_begin": (_P, _P, _P, _P, _P),
    "mcmh_cond_end": (_P,),
    "mcmh_trace_stamp": (_P, _I, _I, _P),
}

_lib = None
build_log = ""          # nvcc's output of the last build (ptxas -v lines)
build_seconds = 0.0     # wall time of the last build; 0.0 when it was cached
_launches: dict[str, int] = {}
# where check_launch counts: None, the launches; a dict, the tally of the
# capture scope being recorded (ops/graph.py)
_sink: dict[str, int] | None = None
# the replayed captures' conditional bodies: (taken counters, the launches
# of each body, each body's name), resolved into the counts when they are
# read
_replayed: list = []


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build only where the CUDA toolkit "
            "is installed"
        )
    return found


def library_path() -> Path:
    """The library file for the current sources and flags."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmcmh_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc -c`` per source, all started together, then one link."""
    global build_log, build_seconds
    import time

    so = library_path()
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{Path(src).stem}.o") for src in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    jobs = [(p.args, p.communicate()[0], p.returncode) for p in procs]
    if all(code == 0 for _, _, code in jobs):
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        jobs.append((res.args, res.stdout + res.stderr, res.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(log for _, log, _ in jobs)
    failed = [f"nvcc failed ({code}):\n{' '.join(cmd)}\n{log}"
              for cmd, log, code in jobs if code != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.mcmh_rank_epoch_limit.restype = ctypes.c_uint
        lib.mcmh_error_string.argtypes = [ctypes.c_int]
        lib.mcmh_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, code: int, kernels: int = 1) -> None:
    """Raise on a refused launch; otherwise count it: ``kernels`` is the
    number of kernels the call launched."""
    if code != 0:
        msg = library().mcmh_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}: {msg})")
    tally = _launches if _sink is None else _sink
    tally[name] = tally.get(name, 0) + kernels


def set_sink(sink: dict[str, int] | None) -> dict[str, int] | None:
    """Send check_launch's counts to ``sink`` (None: the launches); returns
    the sink it replaces."""
    global _sink
    prev, _sink = _sink, sink
    return prev


def add_launches(counts: dict[str, int], times: int = 1) -> None:
    """Add ``times`` replays of a captured scope's ``counts``."""
    for name, n in counts.items():
        _launches[name] = _launches.get(name, 0) + n * times


def add_replayed(taken: torch.Tensor, bodies: list, names: list) -> None:
    """Register a captured step's conditional bodies: ``taken`` (B,) int64
    on the card counts the replays that ran body i, ``bodies[i]`` its
    launches, ``names[i]`` its name (``ops/graph.py::Capture.names``).
    ``launch_counts`` reads the counters (one wait on the card),
    ``reset_launch_counts`` zeroes them on the card's queue."""
    if not any(t is taken for t, _, _ in _replayed):
        _replayed.append((taken, bodies, list(names)))


def body_counters() -> list:
    """[(taken, names)] of the registered captures' conditional bodies:
    the counters on the card and each body's name
    (``utils/profiling.py::collect`` sums the runs by name)."""
    return [(taken, names) for taken, _, names in _replayed]


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A wrapper's device rule: CPU tensors take the plain version (the
    caller checks that first); anything else must be CUDA, contiguous."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(
                f"{name}: tensors must all be on one CUDA device or all on "
                f"the CPU, got {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def launch_counts() -> dict[str, int]:
    out = dict(_launches)
    for taken, bodies, _ in _replayed:
        for n, counts in zip(taken.tolist(), bodies):
            for name, k in counts.items():
                if n * k:
                    out[name] = out.get(name, 0) + n * k
    return out


def reset_launch_counts() -> None:
    _launches.clear()
    for taken, _, _ in _replayed:
        taken.zero_()
