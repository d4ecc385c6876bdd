// Correlation-field build for the corr scorer (models/corr_field.py).
//
//   F[k, y, x] = sum_j padded[y + oy[k, j], x + ox[k, j]]     (K, h, w) f32
//
// Replaces mcmh_localization_tpu/ops/corr_field_pallas.py::corr_field_pallas
// (the TPU build of the full-map BIG field) and, on this card, also the
// SMALL program's windowed build (models/corr_field.py::_build_field_dft on
// the TPU): the wrapper slices the window region first, so one kernel
// serves both.  Invalid beams point at an all-zero band below the table and
// add 0.
//
// Bound: K*h*w*M adds, each one 4-byte read of the padded table (6.4e9
// adds for K=120, 384^2, M=360).  The table (~2 MB at 384^2 with a 102-cell
// pad) stays resident in L2, and neighbouring threads take neighbouring x,
// so every beam's reads of a warp are one coalesced 128-byte line.  The
// block stages its bin's M offsets in shared memory (as one flat offset
// oy*wp + ox) so the inner loop is one shared load, one global load and one
// add.  Sums run over j in order from 0.0 with round-to-nearest adds and
// no contraction, which is the plain PyTorch version's order.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 128;
constexpr int kBlockY = 2;
constexpr int kChunk = 1024;  // offsets staged per pass (any M works)

__global__ void corr_field_build_kernel(const float* __restrict__ padded,
                                        int wp,
                                        const int* __restrict__ ox,
                                        const int* __restrict__ oy, int m,
                                        float* __restrict__ out, int h,
                                        int w) {
  __shared__ int s_off[kChunk];
  const int k = blockIdx.z;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const bool live = x < w && y < h;
  const float* base = padded + static_cast<long long>(y) * wp + x;
  const int* oxk = ox + static_cast<long long>(k) * m;
  const int* oyk = oy + static_cast<long long>(k) * m;
  float acc = 0.0f;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    const int n = min(kChunk, m - j0);
    __syncthreads();
    for (int t = tid; t < n; t += nthreads) {
      s_off[t] = oyk[j0 + t] * wp + oxk[j0 + t];
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < n; ++t) {
        acc = __fadd_rn(acc, __ldg(base + s_off[t]));
      }
    }
  }
  if (live) {
    out[(static_cast<long long>(k) * h + y) * w + x] = acc;
  }
}

}  // namespace

extern "C" int mcmh_corr_field_build(const float* padded, int hp, int wp,
                                     const int* ox, const int* oy, int k,
                                     int m, float* out, int h, int w,
                                     void* stream) {
  (void)hp;
  if (k <= 0 || h <= 0 || w <= 0) return 0;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, k);
  corr_field_build_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      padded, wp, ox, oy, m, out, h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mcmh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
