// Exact likelihood-field scorer.
//
// Replaces mcmh_localization_tpu/ops/likelihood_pallas.py::
// likelihood_field_scores_pallas, and on this card also the XLA path of
// models/sensor.py::likelihood_field_scores.  Per particle (x, y, theta)
// and beam j (u_j, v_j: the beam endpoint in the sensor frame):
//
//   lx = x + c * u_j - s * v_j,  ly = y + s * u_j + c * v_j
//   (mx, my) = i32((l - origin) OP scale)      OP: / res ("jnp" scorer) or
//                                                  * inv_res ("pallas")
//   total = sum over valid beams with (mx, my) in the map of field[my, mx]
//   out   = count > 0 ? (sum ? total : total / max(count, 1)) : blind
//
// Off-map beams count in the denominator and add 0.  The two JAX scorers
// compute the cell in the two OP forms, which differ by an ulp at cell
// edges, so the form is an argument.  c, s = cosf, sinf(theta) and the
// endpoint math round like the plain PyTorch version (round-to-nearest
// intrinsics, --fmad=false); only the order of the beam sum differs.
//
// Bound: M dependent 4-byte reads per particle (72M per scan at 2 x 100k
// particles, 360 beams) from the log field (576 KB at 384^2), which stays
// in L2 and, for a converged cloud, largely in L1.  One warp per particle:
// the lanes take the beams (lane-strided), then a shuffle reduction.  The
// block stages the scan's u, v and validity in shared memory once and its
// warps walk many particles.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlocks = 2048;
constexpr int kMaxBeams = 2048;  // shared staging: 3 * 4 * 2048 = 24 KB

__global__ void likelihood_scores_kernel(
    const float* __restrict__ particles, int n, const float* __restrict__ u,
    const float* __restrict__ v, const unsigned char* __restrict__ valid,
    int m, const float* __restrict__ field, int h, int w, float origin_x,
    float origin_y, float scale, int cell_div, const int* __restrict__ count,
    int sum_aggregation, float blind_score, float* __restrict__ out) {
  __shared__ float s_u[kMaxBeams];
  __shared__ float s_v[kMaxBeams];
  __shared__ unsigned char s_valid[kMaxBeams];
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    s_u[j] = u[j];
    s_v[j] = v[j];
    s_valid[j] = valid[j];
  }
  __syncthreads();
  const int n_valid = *count;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = blockIdx.x * kWarps + warp; i < n; i += gridDim.x * kWarps) {
    const float x = particles[3LL * i];
    const float y = particles[3LL * i + 1];
    const float theta = particles[3LL * i + 2];
    const float c = cosf(theta);
    const float s = sinf(theta);
    float acc = 0.0f;
    for (int j = lane; j < m; j += 32) {
      if (!s_valid[j]) continue;
      // JAX order: (x + c*u) - s*v and (y + s*u) + c*v
      const float lx = __fsub_rn(__fadd_rn(x, __fmul_rn(c, s_u[j])),
                                 __fmul_rn(s, s_v[j]));
      const float ly = __fadd_rn(__fadd_rn(y, __fmul_rn(s, s_u[j])),
                                 __fmul_rn(c, s_v[j]));
      const float dx = __fsub_rn(lx, origin_x);
      const float dy = __fsub_rn(ly, origin_y);
      const int mx = __float2int_rz(cell_div ? __fdiv_rn(dx, scale)
                                             : __fmul_rn(dx, scale));
      const int my = __float2int_rz(cell_div ? __fdiv_rn(dy, scale)
                                             : __fmul_rn(dy, scale));
      if (mx >= 0 && mx < w && my >= 0 && my < h) {
        acc = __fadd_rn(acc, __ldg(field + static_cast<long long>(my) * w + mx));
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (lane == 0) {
      float score = sum_aggregation
                        ? acc
                        : __fdiv_rn(acc, static_cast<float>(max(n_valid, 1)));
      out[i] = n_valid > 0 ? score : blind_score;
    }
  }
}

}  // namespace

extern "C" int mcmh_likelihood_scores(const float* particles, int n,
                                      const float* u, const float* v,
                                      const unsigned char* valid, int m,
                                      const float* field, int h, int w,
                                      float origin_x, float origin_y,
                                      float scale, int cell_div,
                                      const int* count, int sum_aggregation,
                                      float blind_score, float* out,
                                      void* stream) {
  if (n <= 0) return 0;
  if (m > kMaxBeams) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = (n + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  likelihood_scores_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      particles, n, u, v, valid, m, field, h, w, origin_x, origin_y, scale,
      cell_div, count, sum_aggregation, blind_score, out);
  return static_cast<int>(cudaGetLastError());
}
