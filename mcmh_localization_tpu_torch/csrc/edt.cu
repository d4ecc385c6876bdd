// Exact squared Euclidean distance transform of a 2-D occupancy grid:
// out[y, i] = min over occupied (y', x') of (y - y')^2 + (i - x')^2, in cells.
//
// Replaces mcmh_localization_tpu/maps/edt.py::squared_edt_device, which JAX
// computes in XLA, not Pallas: two separable 1-D min-plus transforms in f32,
// each the O(n^2) broadcast d2[i] = min_j f[j] + (i - j)^2, chunked over
// columns.  Here the same two passes, in exact integers:
//
//   edt_columns: one thread a column sweeps down, then up, and keeps the
//     squared distance along the column to the nearest occupied cell, or
//     kNone where the column holds none.  Neighbouring threads take
//     neighbouring columns, so each row's reads and writes coalesce.
//   edt_rows: one block a row stages the row's pass-1 values in shared
//     memory (4 bytes a cell: 16 KB at W = 4096) and each thread takes the
//     min-plus over the whole row for R of its output cells, so one staged
//     value (read four at a time, a broadcast) serves R candidates.
//
// Candidates are v + (i - x)^2 in uint32.  With sides up to kMaxSide a real
// one stays below 2^31 - 1 (v <= (H-1)^2, (i-x)^2 <= (W-1)^2), and one from a
// kNone column (2^31 - 1) is at least kNone, so no branch skips it: a result
// of kNone or more means the map has no occupied cell, and every cell then
// reads 1e12, JAX's value.  The f32 result is the integer rounded to
// nearest, exact below 2^24.
//
// Bound: 5 bytes a cell (the bool in, the f32 out), 25 us at 4096^2 on
// HBM3.  The row pass's H * W^2 candidates (6.9e10 at 4096^2) are far above
// it: Felzenszwalb's O(W) lower envelope is the redesign.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kNone = 0x7fffffffu;
constexpr int kMaxSide = 32767;
constexpr int kThreads = 256;
constexpr float kEmpty = 1e12f;

__global__ void edt_columns(const unsigned char* __restrict__ occ, int h,
                            int w, unsigned* __restrict__ g) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  int last = -1;  // the nearest occupied row at or above y
#pragma unroll 8
  for (int y = 0; y < h; ++y) {
    const size_t e = static_cast<size_t>(y) * w + x;
    if (occ[e]) last = y;
    g[e] = last < 0 ? kNone : static_cast<unsigned>((y - last) * (y - last));
  }
  int next = -1;  // the nearest occupied row at or below y
#pragma unroll 8
  for (int y = h - 1; y >= 0; --y) {
    const size_t e = static_cast<size_t>(y) * w + x;
    if (occ[e]) next = y;
    if (next >= 0) {
      const unsigned d = static_cast<unsigned>((next - y) * (next - y));
      if (d < g[e]) g[e] = d;
    }
  }
}

// w4: w rounded up to a multiple of 4; the staged row's tail is kNone.
template <int R>
__global__ void edt_rows(const unsigned* __restrict__ g, int w, int w4,
                         float* __restrict__ out) {
  extern __shared__ uint4 staged4[];
  unsigned* staged = reinterpret_cast<unsigned*>(staged4);
  const size_t base = static_cast<size_t>(blockIdx.x) * w;
  for (int x = threadIdx.x; x < w4; x += blockDim.x)
    staged[x] = x < w ? g[base + x] : kNone;
  __syncthreads();
  const int step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < w; i0 += R * step) {
    unsigned best[R];
    int dx[R];  // i - x for this thread's R outputs at the current x
#pragma unroll
    for (int r = 0; r < R; ++r) {
      best[r] = 0xffffffffu;
      dx[r] = i0 + r * step;
    }
    for (int q = 0; q < w4 / 4; ++q) {
      const uint4 v = staged4[q];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int d = dx[r];
        best[r] = min(best[r], static_cast<unsigned>(d * d) + v.x);
        best[r] = min(best[r], static_cast<unsigned>((d - 1) * (d - 1)) + v.y);
        best[r] = min(best[r], static_cast<unsigned>((d - 2) * (d - 2)) + v.z);
        best[r] = min(best[r], static_cast<unsigned>((d - 3) * (d - 3)) + v.w);
        dx[r] = d - 4;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r * step;
      if (i < w)
        out[base + i] = best[r] >= kNone ? kEmpty : __uint2float_rn(best[r]);
    }
  }
}

template <int R>
cudaError_t launch_rows(const unsigned* g, int h, int w, int threads,
                        float* out, cudaStream_t stream) {
  const int w4 = (w + 3) / 4 * 4;
  const size_t smem = static_cast<size_t>(w4) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edt_rows<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  edt_rows<R><<<h, threads, smem, stream>>>(g, w, w4, out);
  return cudaGetLastError();
}

}  // namespace

// occ: (h, w) bool as bytes; g: (h, w) int32 scratch; out: (h, w) f32.
// Two launches on ``stream``; returns the first CUDA error, or
// cudaErrorInvalidValue for a side past kMaxSide.
extern "C" int mcmh_squared_edt(const unsigned char* occ, int h, int w,
                                unsigned* g, float* out, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (h > kMaxSide || w > kMaxSide)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  edt_columns<<<(w + kThreads - 1) / kThreads, kThreads, 0, s>>>(occ, h, w, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // one output a thread below kThreads columns; above, R outputs a thread
  // with R the power of two (at most 16) that covers the row in one sweep
  if (w <= kThreads) {
    err = launch_rows<1>(g, h, w, (w + 31) / 32 * 32, out, s);
  } else {
    const int k = (w + kThreads - 1) / kThreads;
    if (k <= 2) err = launch_rows<2>(g, h, w, kThreads, out, s);
    else if (k <= 4) err = launch_rows<4>(g, h, w, kThreads, out, s);
    else if (k <= 8) err = launch_rows<8>(g, h, w, kThreads, out, s);
    else err = launch_rows<16>(g, h, w, kThreads, out, s);
  }
  return static_cast<int>(err);
}
