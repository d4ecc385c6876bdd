// Monotone row take: out[m, c] = src[idx[m], c].
//
// Replaces mcmh_localization_tpu/ops/take_pallas.py::take_rows_monotone,
// the take behind systematic_resample_particles(impl="mxu").  The TPU
// kernel DMAs a window of source rows per output tile and resolves the
// take with one-hot MXU products, falling back to an XLA gather when a
// tile's index span overflows the window; those are TPU mechanics.  Here
// one thread copies one element: the copy is bitwise for any indices, and
// nondecreasing indices make neighbouring threads read neighbouring (often
// the same) source rows, so the reads coalesce without a window.
//
// Bound: copying M * C * 4 bytes out and about as many in (12 MB each way
// at M = 1M, C = 3).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void take_rows_kernel(const float* __restrict__ src, int c,
                                 const int* __restrict__ idx, long long total,
                                 float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= total) return;
  const long long m = e / c;
  const int ci = static_cast<int>(e - m * c);
  out[e] = src[static_cast<long long>(__ldg(idx + m)) * c + ci];
}

}  // namespace

extern "C" int mcmh_take_rows(const float* src, int n, int c, const int* idx,
                              int m, float* out, void* stream) {
  (void)n;
  const long long total = static_cast<long long>(m) * c;
  if (total <= 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  take_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(src, c, idx, total,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}
