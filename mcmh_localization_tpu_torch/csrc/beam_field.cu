// Beam score-field build for the ray-cast beam model
// (models/range_table.py::beam_field_scores and its coarse fallback).
//
//   out[b, c] = sum_{g=0}^{K-1} s[b, g, qt[g, c]]              (B, C) f32
//
// qt is the int8 quantized range table (K, C) with values in [0, nq) (the
// window or the coarse block centres of models/range_table.py::
// quantize_table's output); s the per-scan LUT (B, K, nq) f32.
//
// Replaces mcmh_localization_tpu/ops/beam_field_pallas.py::lut_field.  The
// TPU kernel builds a one-hot of qt in VMEM and multiplies it on the MXU
// against int8 hi/lo planes of s with int32 accumulation, because gathers
// serialize on a TPU.  Here the sum is a gather from a small table: the
// block stages s[b] (K * nq floats, 19.6 KB at K=96, nq=51) in shared
// memory, and each thread owns one cell and reads one byte of qt and one
// shared float per table bin.  No one-hot and no quantization of s.
//
// Bound: B * C * K shared-memory reads and adds (9.4e6 for the fine window
// at B=24, K=96, C=64^2) plus one read of qt per block row (K * C bytes,
// 393 KB, L2-resident across the B blocks that share it).  Neighbouring
// threads take neighbouring cells, so each g's qt reads of a warp are one
// coalesced 32-byte sector.  The adds run over g in ascending order from
// 0.0f with round-to-nearest adds, the plain PyTorch version's order, so
// the two agree bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void lut_field_kernel(const signed char* __restrict__ qt,
                                 const float* __restrict__ s, int k, int nq,
                                 int c, float* __restrict__ out) {
  extern __shared__ float s_lut[];
  const int b = blockIdx.y;
  const int kn = k * nq;
  const float* sb = s + static_cast<long long>(b) * kn;
  for (int t = threadIdx.x; t < kn; t += blockDim.x) s_lut[t] = sb[t];
  __syncthreads();
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= c) return;
  float acc = 0.0f;
  const signed char* q = qt + cell;
  for (int g = 0; g < k; ++g) {
    acc = __fadd_rn(acc, s_lut[g * nq + __ldg(q + static_cast<long long>(g) * c)]);
  }
  out[static_cast<long long>(b) * c + cell] = acc;
}

}  // namespace

// smem_bytes = k * nq * 4; the wrapper refuses sizes above the card's 227 KB
extern "C" int mcmh_lut_field(const signed char* qt, const float* s, int b,
                              int k, int nq, int c, float* out, void* stream) {
  if (b <= 0 || c <= 0) return 0;
  const size_t smem = static_cast<size_t>(k) * nq * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lut_field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((c + kThreads - 1) / kThreads, b);
  lut_field_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(qt, s, k, nq, c,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}
