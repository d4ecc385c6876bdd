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
// serialize on a TPU.  Here the sum is a gather from a small table in
// shared memory.  No one-hot and no quantization of s.
//
// Bound: B * K * C reads of 4 bytes from shared memory (37.7 MB for the
// fine window at B=24, K=96, C=64^2; 85 MB for the coarse 96^2), at 128
// bytes a clock an SM; the DRAM bytes (qt, s, out: 0.5-1.3 MB) and the
// adds are far below that.  A row of s[b, g] is nq = 51 words, so the 32
// random reads of a warp fall on at most two words of a bank; on the beam
// path's tables that costs nothing measurable (all indices 0, every read a
// broadcast, timed the same).  What holds the kernel back is latency: the
// fine build is 98 304 sums of 96 terms, a few warps an SM, and every
// block first stages its LUTs and its qt tile (50-100 KB) from L2.
// The first kernel (one output a thread, a block per 256 cells and one b)
// restaged all of s[b] in every block, re-read qt once per b as one byte a
// thread, and walked a chain of dependent global and shared loads with a
// runtime trip count.  The layout now:
//  - a block owns a tile of blockDim.x cells (one a thread) and BPAR
//    consecutive b (both from the caller, ops/beam_field.py::lut_tiles:
//    BPAR = 2 at the fine build, 4 at the coarse);
//  - it stages its qt tile (K rows of the tile's bytes, 16 a copy) and its
//    BPAR LUTs in shared memory with cp.async, and sums the BPAR outputs of
//    each cell in one pass over the bins, so one index read serves BPAR
//    LUTs;
//  - the bins go 8 at a time, the 8 index reads and the 8 * BPAR LUT reads
//    issued before the adds, so a thread keeps BPAR independent chains with
//    their loads in flight;
//  - a qt or s that is not aligned for 16-byte copies (or a C or K * nq
//    that is not a multiple of them) takes 4-byte copies, and a ragged last
//    tile reads zeros past C and stores nothing there.
// Each output still adds over g in ascending order from 0.0f with
// round-to-nearest adds, the plain PyTorch version's order, so the two
// agree bitwise.
// Tried and dropped (timed on an NVIDIA H100 80GB HBM3 at 700 W at the
// beam path's shapes, in turns with the first kernel; PERF.md §6): one b a
// block (slower at both builds); 2 or 4 cells a thread; a block walking two passes with the next LUTs landing in
// a two-stage ring while the current ones are summed (half the blocks);
// the indices held in registers for the whole walk (255 registers and
// spills); the staging in 2-8 chunks of bins, each summed as it lands
// (more chunks, slower).

#include <cuda_runtime.h>

#include "thread_runs.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kChunk = 8;  // bins whose loads issue together

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// floats of one LUT slot: K * nq rounded up to 16 bytes
__host__ __device__ __forceinline__ int slot_floats(int k, int nq) {
  return (k * nq + 3) & ~3;
}

template <int BPAR>
__global__ void __launch_bounds__(kMaxThreads) lut_field_kernel(
    const signed char* __restrict__ qt, const float* __restrict__ s, int nb,
    int k, int nq, int c, bool vec_q, bool vec_s, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tc = blockDim.x;
  const int kn = k * nq;
  const int slot = slot_floats(k, nq);
  float* lut = reinterpret_cast<float*>(smem);
  unsigned char* q_s = smem + sizeof(float) * slot * BPAR;
  const int c0 = blockIdx.x * tc;
  const int b0 = blockIdx.y * BPAR;
  const int n_b = min(BPAR, nb - b0);

  // the qt tile: K rows of tc bytes, 16 a copy (zeros past C)
  const int pieces = tc / 16;
  for (int idx = threadIdx.x; idx < k * pieces; idx += tc) {
    const int g = idx / pieces;
    const int cell = c0 + 16 * (idx - g * pieces);
    unsigned char* dst = q_s + g * tc + (cell - c0);
    const signed char* src = qt + static_cast<long long>(g) * c + cell;
    if (vec_q && cell + 16 <= c) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        dst[j] = cell + j < c ? static_cast<unsigned char>(__ldg(src + j)) : 0;
      }
    }
  }
  // the LUTs s[b0 .. b0 + n_b - 1], one slot each: 16-byte copies where vec
  for (int p = 0; p < n_b; ++p) {
    float* dst = lut + p * slot;
    const float* src = s + static_cast<long long>(b0 + p) * kn;
    if (vec_s) {
      for (int i = 4 * threadIdx.x; i < kn; i += 4 * tc) {
        cp_async16(dst + i, src + i);
      }
    } else {
      for (int i = threadIdx.x; i < kn; i += tc) cp_async4(dst + i, src + i);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // (slots past n_b are never stored: their sums read stale shared memory)
  const unsigned char* q_col = q_s + threadIdx.x;
  float acc[BPAR];
#pragma unroll
  for (int p = 0; p < BPAR; ++p) acc[p] = 0.0f;
  int g = 0;
  for (; g + kChunk <= k; g += kChunk) {
    unsigned q[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) q[u] = q_col[(g + u) * tc];
    float v[kChunk][BPAR];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float* row = lut + (g + u) * nq + q[u];
#pragma unroll
      for (int p = 0; p < BPAR; ++p) v[u][p] = row[p * slot];
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
#pragma unroll
      for (int p = 0; p < BPAR; ++p) acc[p] = __fadd_rn(acc[p], v[u][p]);
    }
  }
  for (; g < k; ++g) {
    const float* row = lut + g * nq + q_col[g * tc];
#pragma unroll
    for (int p = 0; p < BPAR; ++p) acc[p] = __fadd_rn(acc[p], row[p * slot]);
  }
  const int cell = c0 + threadIdx.x;
  if (cell < c) {
#pragma unroll
    for (int p = 0; p < BPAR; ++p) {
      if (p < n_b) out[static_cast<long long>(b0 + p) * c + cell] = acc[p];
    }
  }
}

// Lets a kernel take `smem` bytes of dynamic shared memory on the current
// device; the attribute is set once for each larger size, not every call.
template <int BPAR>
cudaError_t allow_smem(int smem) {
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(lut_field_kernel<BPAR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next call
    return err;
  }
  if (dev < kDevices) allowed[dev] = smem;
  return err;
}

template <int BPAR>
cudaError_t launch(const signed char* qt, const float* s, int b, int k,
                   int nq, int c, int threads, float* out,
                   cudaStream_t stream) {
  // the LUT slots and the qt tile (ops/beam_field.py::lut_smem_bytes)
  const int smem =
      static_cast<int>(sizeof(float)) * slot_floats(k, nq) * BPAR +
      k * threads;
  const cudaError_t err = allow_smem<BPAR>(smem);
  if (err != cudaSuccess) return err;
  const bool vec_q = c % 16 == 0 && aligned_to(qt, 16);
  const bool vec_s = (k * nq) % 4 == 0 && aligned_to(s, 16);
  dim3 grid((c + threads - 1) / threads, (b + BPAR - 1) / BPAR);
  lut_field_kernel<BPAR><<<grid, threads, smem, stream>>>(
      qt, s, b, k, nq, c, vec_q, vec_s, out);
  return cudaGetLastError();
}

}  // namespace

// threads: the cells a block, a multiple of 16 up to 256; bpar: the b a
// block, 2 or 4 (ops/beam_field.py::lut_tiles).
extern "C" int mcmh_lut_field(const signed char* qt, const float* s, int b,
                              int k, int nq, int c, int threads, int bpar,
                              float* out, void* stream) {
  if (b <= 0 || c <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || threads % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bpar) {
    case 2:
      return static_cast<int>(launch<2>(qt, s, b, k, nq, c, threads, out, st));
    case 4:
      return static_cast<int>(launch<4>(qt, s, b, k, nq, c, threads, out, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
