// Sorted-rank resampling expansion.
//
//   rank_in_sorted: idx[m] = min(#{j : bound[j] <= v(m)}, R - 1)
//   expand_sorted:  out[m, :] = particles[idx[m], :]
//   with v(m) = min(m, cap), cap = min(count - 1, num_out - 1): output slots
//   at or past count repeat the last active slot, the tail rule of the TPU
//   kernel (rank_pallas.py::_kernel, `m = min(tile_m, cap)`).
//
// Replaces mcmh_localization_tpu/ops/rank_pallas.py::rank_in_sorted and
// ::expand_sorted.  ``bound`` is nondecreasing (ops/resampling.py::
// _segment_bounds), so each output slot finds its particle by a binary
// search: exact for any weights, with no window and no fallback (the TPU
// kernel's windowed merge and its lax.cond scatter fallback are TPU
// mechanics).
//
// Bound: num_out * ceil(log2 R) dependent 4-byte reads of ``bound`` (4 MB
// at R = 1M, resident in L2) plus the 12-byte particle copy per slot; the
// top levels of every search hit the same few lines.  One thread per
// output slot; the copy is bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int rank_of(const int* __restrict__ bound, int r,
                                       int v) {
  int lo = 0;
  int hi = r;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(bound + mid) <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return min(lo, r - 1);
}

__device__ __forceinline__ int slot_value(int m, int num_out,
                                          const int* __restrict__ count) {
  int cap = num_out - 1;
  if (count != nullptr) cap = min(*count - 1, cap);
  return min(m, cap);
}

__global__ void rank_in_sorted_kernel(const int* __restrict__ bound, int r,
                                      int num_out,
                                      const int* __restrict__ count,
                                      int* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= num_out) return;
  out[m] = rank_of(bound, r, slot_value(m, num_out, count));
}

__global__ void expand_sorted_kernel(const int* __restrict__ bound, int r,
                                     const float* __restrict__ particles,
                                     int c, int num_out,
                                     const int* __restrict__ count,
                                     float* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= num_out) return;
  const int idx = rank_of(bound, r, slot_value(m, num_out, count));
  const float* src = particles + static_cast<long long>(idx) * c;
  float* dst = out + static_cast<long long>(m) * c;
  for (int ci = 0; ci < c; ++ci) dst[ci] = src[ci];
}

}  // namespace

extern "C" int mcmh_rank_in_sorted(const int* bound, int r, int num_out,
                                   const int* count, int* out, void* stream) {
  if (num_out <= 0) return 0;
  rank_in_sorted_kernel<<<(num_out + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      bound, r, num_out, count, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcmh_expand_sorted(const int* bound, int r,
                                  const float* particles, int c, int num_out,
                                  const int* count, float* out, void* stream) {
  if (num_out <= 0) return 0;
  expand_sorted_kernel<<<(num_out + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      bound, r, particles, c, num_out, count, out);
  return static_cast<int>(cudaGetLastError());
}
