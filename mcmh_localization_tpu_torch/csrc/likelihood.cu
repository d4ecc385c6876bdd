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
// edges, so the form is a template argument.  c, s = cosf, sinf(theta)
// and the endpoint math round like the plain PyTorch version
// (round-to-nearest intrinsics, --fmad=false).
//
// The sum order is fixed, and ops/likelihood.py::likelihood_scores_plain
// follows it, so the two are bitwise equal: G lanes share a pose (G a
// power of two in [1, 32], ops/likelihood.py::lanes_per_particle); lane g
// adds the compacted valid beams g, g + G, g + 2G, ... in ascending order
// from +0.0 (an off-map beam adds +0.0, which changes no bit of such a
// sum), then an xor butterfly over the group, offsets G/2 down to 1.
//
// Bound: one 4-byte field read and ~13 f32 operations per particle and
// valid beam (2 x 100k particles x 114 valid beams of 360: 0.0044 ms of
// operations on an H100 SXM at 700 W), from a 576 KB log field that stays
// in L2.  What holds it back is instruction issue and L1 wavefronts, not
// DRAM.  The layout:
//  - the block stages only the valid beams, as float2 (u, v) in shared
//    memory, compacted with a warp ballot and a block prefix in ascending
//    beam order; the loop runs over those (114 of 360 in a scan of the
//    smoke run's house map), with no branch on validity;
//  - G lanes a pose, G chosen from N so the grid fills the card: with
//    G = 1 a warp's 32 reads of one beam come from 32 neighbouring poses
//    of the cloud (a few cache lines), where one warp a pose read 32
//    beams along the scan contour (up to 32 lines); G = 32 where one
//    thread a pose would leave most SMs idle (2 x 1500 poses);
//  - the group's first lane loads the pose and computes cosf / sinf once;
//    the other lanes take them by shuffle.
//  - a scan of more than kBeamTile beams runs the kernel's tiled instance:
//    tiles of kBeamTile raw beams, each compacted as above, staged once per
//    group of poses, and lane g carries its sum across the tiles: it adds
//    the compacted beams whose rank among all the scan's valid beams is
//    g mod G, in ascending order (the ranks before a tile carried as a
//    running base), so the order and the sums stay those of one tile.  A
//    scan of at most kBeamTile beams runs the untiled instance, staged once
//    for all the block's poses.
// Tried and dropped (chip_kernel_ab.py, the kernels alone, multiply form,
// NVIDIA H100 80GB HBM3 at 700 W): the first kernel, one warp a pose striding
// over all M beams and skipping the invalid ones, 0.1611-0.1624 ms at
// 2 x 100k and 0.0070-0.0071 at 2 x 1500; the compacted beams at G = 32
// for 2 x 100k, 0.0918-0.0924 (a warp's reads follow the scan contour);
// G = 1 for 2 x 1500, 0.0128 (94 warps for 132 SMs).  The rule's G = 2 at
// 2 x 100k takes 0.0321-0.0324 ms (divide form 0.0503-0.0506), its G = 32
// at 2 x 1500 0.0055 (0.0062); PERF.md has the table over G.

#include <cuda_runtime.h>

#include "stage_beams.cuh"

namespace {

constexpr int kThreads = 256;
// raw beams a tile (ops/likelihood.py::BEAM_TILE): 16 KB of float2
constexpr int kBeamTile = 2048;
constexpr int kMaxBlocks = 4096;

// The first index >= t0 that lane g of G takes: j == g (mod G).
template <int G>
__device__ __forceinline__ int first_of_lane(int t0, int g) {
  return t0 + ((g - t0) & (G - 1));
}

// Lane g's sum over the staged beams j, j + G, ... below j_end, onto acc,
// for the pose (x, y) with heading (c, s).
template <int G, bool kDiv>
__device__ __forceinline__ float beam_sum(
    float acc, const float2* s_uv, int j, int j_end, float x, float y,
    float c, float s, const float* __restrict__ field, int h, int w,
    float origin_x, float origin_y, float scale) {
#pragma unroll 4
  for (; j < j_end; j += G) {
    const float2 b = s_uv[j];
    // JAX order: (x + c*u) - s*v and (y + s*u) + c*v
    const float lx =
        __fsub_rn(__fadd_rn(x, __fmul_rn(c, b.x)), __fmul_rn(s, b.y));
    const float ly =
        __fadd_rn(__fadd_rn(y, __fmul_rn(s, b.x)), __fmul_rn(c, b.y));
    const float dx = __fsub_rn(lx, origin_x);
    const float dy = __fsub_rn(ly, origin_y);
    const int mx = __float2int_rz(kDiv ? __fdiv_rn(dx, scale)
                                       : __fmul_rn(dx, scale));
    const int my = __float2int_rz(kDiv ? __fdiv_rn(dy, scale)
                                       : __fmul_rn(dy, scale));
    if (mx >= 0 && mx < w && my >= 0 && my < h) {
      acc = __fadd_rn(acc, __ldg(field + my * w + mx));
    }
  }
  return acc;
}

// kTiled: the scan has more than kBeamTile beams, staged a tile at a time
// for each group of poses; else it is staged once for the block's poses.
template <int G, bool kDiv, bool kTiled>
__global__ void __launch_bounds__(kThreads) likelihood_scores_kernel(
    const float* __restrict__ particles, int n, const float* __restrict__ u,
    const float* __restrict__ v, const unsigned char* __restrict__ valid,
    int m, const float* __restrict__ field, int h, int w, float origin_x,
    float origin_y, float scale, const int* __restrict__ count,
    int sum_aggregation, float blind_score, float* __restrict__ out) {
  extern __shared__ float2 s_uv[];
  int m_valid = 0;
  if constexpr (!kTiled) {
    m_valid = mcmh::stage_valid_beams<kThreads>(
        valid, m, s_uv, [=](int j) { return make_float2(u[j], v[j]); });
  }
  const int n_valid = __ldg(count);
  constexpr int kGroups = kThreads / G;  // poses a block takes at a time
  const int g = threadIdx.x & (G - 1);
  // block-uniform loop: every lane reaches the butterfly's shuffles
  for (long long i0 = static_cast<long long>(blockIdx.x) * kGroups; i0 < n;
       i0 += static_cast<long long>(gridDim.x) * kGroups) {
    const long long i = i0 + threadIdx.x / G;
    const bool active = i < n;
    float x = 0.0f, y = 0.0f, c = 1.0f, s = 0.0f;
    if (active && g == 0) {
      x = particles[3 * i];
      y = particles[3 * i + 1];
      const float theta = particles[3 * i + 2];
      c = cosf(theta);
      s = sinf(theta);
    }
    if (G > 1) {
      x = __shfl_sync(0xffffffffu, x, 0, G);
      y = __shfl_sync(0xffffffffu, y, 0, G);
      c = __shfl_sync(0xffffffffu, c, 0, G);
      s = __shfl_sync(0xffffffffu, s, 0, G);
    }
    float acc = 0.0f;
    if constexpr (!kTiled) {
      acc = beam_sum<G, kDiv>(acc, s_uv, g, active ? m_valid : 0, x, y, c, s,
                              field, h, w, origin_x, origin_y, scale);
    } else {
      int base = 0;  // valid beams staged before this tile
      for (int t0 = 0; t0 < m; t0 += kBeamTile) {
        // the valid beams of raw beams [t0, t0 + kBeamTile), compacted
        const int staged = mcmh::stage_valid_beams<kThreads>(
            valid + t0, min(kBeamTile, m - t0), s_uv,
            [=](int j) { return make_float2(u[t0 + j], v[t0 + j]); });
        acc = beam_sum<G, kDiv>(acc, s_uv, first_of_lane<G>(base, g) - base,
                                active ? staged : 0, x, y, c, s, field, h, w,
                                origin_x, origin_y, scale);
        base += staged;
        __syncthreads();  // s_uv is rewritten by the next tile
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (active && g == 0) {
      const float score =
          sum_aggregation ? acc
                          : __fdiv_rn(acc, static_cast<float>(max(n_valid, 1)));
      out[i] = n_valid > 0 ? score : blind_score;
    }
  }
}

template <int G, bool kDiv>
cudaError_t launch(const float* particles, int n, const float* u,
                   const float* v, const unsigned char* valid, int m,
                   const float* field, int h, int w, float origin_x,
                   float origin_y, float scale, const int* count,
                   int sum_aggregation, float blind_score, float* out,
                   cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  long long blocks = (static_cast<long long>(n) + kGroups - 1) / kGroups;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (m <= kBeamTile) {
    likelihood_scores_kernel<G, kDiv, false>
        <<<static_cast<int>(blocks), kThreads, m * sizeof(float2), stream>>>(
            particles, n, u, v, valid, m, field, h, w, origin_x, origin_y,
            scale, count, sum_aggregation, blind_score, out);
  } else {
    likelihood_scores_kernel<G, kDiv, true>
        <<<static_cast<int>(blocks), kThreads, kBeamTile * sizeof(float2),
           stream>>>(particles, n, u, v, valid, m, field, h, w, origin_x,
                     origin_y, scale, count, sum_aggregation, blind_score,
                     out);
  }
  return cudaGetLastError();
}

template <bool kDiv>
cudaError_t launch_lanes(int lanes, const float* particles, int n,
                         const float* u, const float* v,
                         const unsigned char* valid, int m,
                         const float* field, int h, int w, float origin_x,
                         float origin_y, float scale, const int* count,
                         int sum_aggregation, float blind_score, float* out,
                         cudaStream_t stream) {
#define MCMH_LANES_CASE(G)                                                  \
  case G:                                                                   \
    return launch<G, kDiv>(particles, n, u, v, valid, m, field, h, w,       \
                           origin_x, origin_y, scale, count,                \
                           sum_aggregation, blind_score, out, stream);
  switch (lanes) {
    MCMH_LANES_CASE(1)
    MCMH_LANES_CASE(2)
    MCMH_LANES_CASE(4)
    MCMH_LANES_CASE(8)
    MCMH_LANES_CASE(16)
    MCMH_LANES_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef MCMH_LANES_CASE
}

}  // namespace

extern "C" int mcmh_likelihood_scores(const float* particles, int n,
                                      const float* u, const float* v,
                                      const unsigned char* valid, int m,
                                      const float* field, int h, int w,
                                      float origin_x, float origin_y,
                                      float scale, int cell_div,
                                      const int* count, int sum_aggregation,
                                      float blind_score, int lanes,
                                      float* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cell_div ? launch_lanes<true>(lanes, particles, n, u, v, valid, m,
                                    field, h, w, origin_x, origin_y, scale,
                                    count, sum_aggregation, blind_score, out,
                                    st)
               : launch_lanes<false>(lanes, particles, n, u, v, valid, m,
                                     field, h, w, origin_x, origin_y, scale,
                                     count, sum_aggregation, blind_score, out,
                                     st);
  return static_cast<int>(err);
}
