// The beam score field's bin-sum LUT matrix
// (models/range_table.py::_bin_lut_matrix, ops/bin_lut.py):
//
//   S[r, g, q] = sum_{j : idx[r, j] == g} lp[j, q]              (R, K, nq) f32
//
// idx (R, M) int32 holds each beam's table bin in [0, K) for each of the
// R field (or coarse) bins, lp (M, nq) the per-beam log mixture at each
// quantized range.  A bin that no beam falls in holds 0.
//
// Replaces the one-hot einsum at mcmh_localization_tpu/models/
// range_table.py:233-246 (XLA's, not a Pallas kernel).  The einsum sizes
// nothing on the host; the port's first form summed one rank level at a
// time and read the level count (the most beams in one bin) on the host,
// which a captured step cannot do.  Here the sum is a loop over the beams
// (ops/bin_lut.py's plain version is the same loop): one block owns one r
// and a tile of q columns, keeps the (K, tile) sums in shared memory and
// each thread owns one column, so no two threads add into one sum and no
// atomics fix the order: each sum
// adds its beams in ascending j, starting from the first one's value (the
// sums start at -0.0f, which adds to any x as x exactly), and a bin that
// no beam reached is written as +0.0f.  That is the plain version's
// order, so the two agree bitwise.
//
// Bound: the bytes, R * M * 4 of idx, M * nq * 4 of lp (read once from L2
// by every block) and R * K * nq * 4 of S written (26 MB at R = K = 360,
// nq = 51; 0.5 MB at the theta window's one offset row of K = 96 bins).
// The R * M * nq adds are far below the f32 rate.  Each thread's adds
// form one chain through shared memory; the loads of 8 beams' indices and
// LUT values are issued ahead of their 8 adds to keep them in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 8;  // beams whose loads issue together

__global__ void bin_lut_kernel(const int* __restrict__ idx,
                               const float* __restrict__ lp, int m, int k,
                               int nq, int qw, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);           // (K, qw)
  unsigned char* seen = smem + sizeof(float) * k * qw;   // (K,)
  const int r = blockIdx.x;
  const int q0 = blockIdx.y * qw;
  const int t = threadIdx.x;
  for (int e = t; e < k * qw; e += blockDim.x) acc[e] = -0.0f;
  for (int g = t; g < k; g += blockDim.x) seen[g] = 0;
  __syncthreads();

  const int* row = idx + static_cast<long long>(r) * m;
  const int q = q0 + t;
  const bool live = t < qw && q < nq;
  int j = 0;
  for (; j + kUnroll <= m; j += kUnroll) {
    int g[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      g[u] = __ldg(row + j + u);
      v[u] = live ? __ldg(lp + static_cast<long long>(j + u) * nq + q) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (g[u] < 0 || g[u] >= k) continue;  // no such bin: nothing to add
      if (live) acc[g[u] * qw + t] = __fadd_rn(acc[g[u] * qw + t], v[u]);
      if (t == 0) seen[g[u]] = 1;
    }
  }
  for (; j < m; ++j) {
    const int g = __ldg(row + j);
    if (g < 0 || g >= k) continue;
    if (live) {
      acc[g * qw + t] = __fadd_rn(acc[g * qw + t],
                                  __ldg(lp + static_cast<long long>(j) * nq + q));
    }
    if (t == 0) seen[g] = 1;
  }
  __syncthreads();

  // the block's (K, tile) slab of S: row g's tile is contiguous in out
  float* dst = out + static_cast<long long>(r) * k * nq;
  const int cols = min(qw, nq - q0);
  for (int e = t; e < k * cols; e += blockDim.x) {
    const int g = e / cols;
    const int c = e - g * cols;
    dst[static_cast<long long>(g) * nq + q0 + c] =
        seen[g] ? acc[g * qw + c] : 0.0f;
  }
}

// Lets the kernel take `smem` bytes of dynamic shared memory on the
// current device; the attribute is set once for each larger size, so a
// step captured after its warm-up sets nothing.
cudaError_t allow_smem(int smem) {
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(bin_lut_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next call
    return err;
  }
  if (dev < kDevices) allowed[dev] = smem;
  return err;
}

}  // namespace

// idx (R, M) int32, lp (M, nq) f32, out (R, K, nq) f32; qw: the q columns
// a block owns (ops/bin_lut.py::bin_lut_tile), threads: its threads (at
// least qw, a multiple of 32).  Shared memory: K * qw floats and K bytes.
extern "C" int mcmh_bin_lut(const int* idx, const float* lp, int r, int m,
                            int k, int nq, int qw, int threads, float* out,
                            void* stream) {
  if (r <= 0 || k <= 0 || nq <= 0) return 0;
  if (qw <= 0 || threads < qw || threads % 32 != 0 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(sizeof(float)) * k * qw + k;
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(r, (nq + qw - 1) / qw);
  bin_lut_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, lp, m, k, nq, qw, out);
  return static_cast<int>(cudaGetLastError());
}
