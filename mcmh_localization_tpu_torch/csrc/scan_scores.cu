// Fused scan scorers: kernel 2's table read with the index math before it
// and the mixture and beam sum after it, on kernel 6's layout.
//
// Replaces the two JAX scorers that read one table value per (particle,
// beam) through mcmh_localization_tpu/ops/gather_pallas.py::gather_2d
// (gather_rows_lanes on the TPU), each followed by a Gaussian mixture, a
// log and a sum over beams as (N, M) arrays:
//
// (a) table_scores_kernel: models/range_table.py::raycast_table_scores, the
//     beam model's range-table scorer (the staged BIG program's, at 1M
//     poses).  Per pose: its cell by i32((p - origin) / res), clamped,
//     and in_map.  Per valid beam j (r_j, a_j):
//       k = floor((theta + a_j + pi_f) / (2 pi / K)) mod K
//       z = (r_j - table[cell, k]) / sigma
//       total += log(max(z_hit * (hit_norm * exp(-0.5 z^2)) + z_floor,
//                        log_floor))
//     An off-map pose adds nothing.  The two divisions are IEEE divisions
//     (XLA's, and utils/f32.py::divide's); exp and log are libdevice's
//     expf / logf (no fast math), the functions PyTorch's torch.exp and
//     torch.log call on the card.
// (b) voxel_scores_kernel: models/sensor3d.py::lidar3d_scores, the 3-D
//     lidar scorer.  Per pose and live beam j, with the
//     beam's sensor-frame (u_j, v_j) and voxel plane vz_j computed once a
//     scan (the endpoint height does not depend on a planar pose):
//       lx = (x + c u_j) - s v_j,  ly = (y + s u_j) + c v_j
//       (vx, vy) = floor((l - origin) * inv)        (world_to_voxel's form)
//       total += volume[vz_j, vy, vx] if (vx, vy) lies in the volume
//     The volume is the per-voxel log mixture, built once per (map,
//     config) from the distance volume by the same PyTorch ops the JAX
//     scorer applies to each read (models/sensor3d.py::lidar3d_log_volume):
//     a read then gives the f32 value that evaluating the mixture on the
//     read distance gives, the kernel needs no transcendental, and the
//     scorer is kernel 6 with one more coordinate.  A beam whose plane lies
//     outside the volume adds 0 to every pose and is not staged ("live" is
//     valid and in the volume's height); it still counts in the "mean"
//     denominator.
//
// Then both: out = count > 0 ? (sum ? total : total / max(count, 1)) : blind.
//
// Layout (csrc/likelihood.cu's): the block stages its scan's beams in
// shared memory, compacted in ascending beam order (stage_beams.cuh); G
// lanes take one pose (G from N, ops/likelihood.py::lanes_per_particle);
// the group's first lane loads the pose and computes its cell (a) or
// cosf / sinf (b) once, the others take them by shuffle; lane g adds the
// staged beams g, g + G, ... from +0.0 in ascending order, then an xor
// butterfly over the group, offsets G/2 down to 1.  ops/scan_scores.py's
// plain versions sum in that order (ops/likelihood.py::lane_sum), so
// kernel and plain version agree bitwise.  Every rounding is explicit
// (_rn intrinsics, --fmad=false).
//
// Bounds, on an H100 SXM at 700 W: (a) at the staged BIG program's 2 x 1M
// poses and a house scan's 114 valid beams of 360 is bound by operations
// (two divisions, an exp and a log a pair: counted as 14 operations,
// 0.048 ms at 67 TFLOP/s f32; the 57 MB cell-major table read once is
// 0.017 ms of DRAM); a pose's reads stay in its cell's 96-float row.  (b)
// at 2 x 100k poses and 5760 beams is bound by operations (13 a pair, as
// kernel 6), its 38 MB volume L2-resident.  The beams of (b) stage as
// float4 (16 bytes: 92 KB at 5760 beams), above the 48 KB default, so
// its launch opts in to the dynamic shared memory the beams need (up to
// 224 KB: 14336 beams) and caps the grid at the blocks that fit the SMs
// at once, each block striding over poses, so the staging is paid once a
// resident block.

#include <cuda_runtime.h>

#include "stage_beams.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
constexpr int kMaxTableBeams = 2048;   // float2: 16 KB
constexpr int kMaxVoxelBeams = 14336;  // float4: 224 KB
constexpr int kSmemPerSm = 232448;     // an H100's shared memory a block may use
constexpr int kDefaultSmem = 48 * 1024;

}  // namespace

// The scalar arguments of (a), passed by value (ops/_cuda.py::TableArgs).
struct TableArgs {
  float origin_x, origin_y, res, pi_f, dtheta, sigma, hit_norm, z_hit,
      z_floor, log_floor, blind_score;
  int h, w, n_theta, sum_aggregation;
};

// The scalar arguments of (b) (ops/_cuda.py::VoxelArgs).
struct VoxelArgs {
  float origin_x, origin_y, inv, blind_score;
  int h, w, sum_aggregation;
};

namespace {

template <int G>
__device__ __forceinline__ float group_sum(float acc) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  return acc;
}

__device__ __forceinline__ float aggregate(float total, int n_valid,
                                           int sum_aggregation,
                                           float blind_score) {
  const float score =
      sum_aggregation ? total
                      : __fdiv_rn(total, static_cast<float>(max(n_valid, 1)));
  return n_valid > 0 ? score : blind_score;
}

template <int G>
__global__ void __launch_bounds__(kThreads) table_scores_kernel(
    const float* __restrict__ particles, int n,
    const float* __restrict__ ranges, const float* __restrict__ angles,
    const unsigned char* __restrict__ valid, int m,
    const float* __restrict__ table, const int* __restrict__ count,
    TableArgs a, float* __restrict__ out) {
  extern __shared__ float2 s_ra[];
  const int m_valid = mcmh::stage_valid_beams<kThreads>(
      valid, m, s_ra,
      [=](int j) { return make_float2(ranges[j], angles[j]); });
  const int n_valid = __ldg(count);
  constexpr int kGroups = kThreads / G;
  const int g = threadIdx.x & (G - 1);
  for (long long i0 = static_cast<long long>(blockIdx.x) * kGroups; i0 < n;
       i0 += static_cast<long long>(gridDim.x) * kGroups) {
    const long long i = i0 + threadIdx.x / G;
    const bool active = i < n;
    float theta = 0.0f;
    int cell = 0;
    int in_map = 0;
    if (active && g == 0) {
      const float x = particles[3 * i];
      const float y = particles[3 * i + 1];
      theta = particles[3 * i + 2];
      const int mx =
          __float2int_rz(__fdiv_rn(__fsub_rn(x, a.origin_x), a.res));
      const int my =
          __float2int_rz(__fdiv_rn(__fsub_rn(y, a.origin_y), a.res));
      in_map = mx >= 0 && mx < a.w && my >= 0 && my < a.h;
      cell = min(max(my, 0), a.h - 1) * a.w + min(max(mx, 0), a.w - 1);
    }
    if (G > 1) {
      theta = __shfl_sync(0xffffffffu, theta, 0, G);
      cell = __shfl_sync(0xffffffffu, cell, 0, G);
      in_map = __shfl_sync(0xffffffffu, in_map, 0, G);
    }
    const float* __restrict__ row =
        table + static_cast<long long>(cell) * a.n_theta;
    float acc = 0.0f;
    const int j_end = in_map ? m_valid : 0;  // in_map only where active
#pragma unroll 2
    for (int j = g; j < j_end; j += G) {
      const float2 b = s_ra[j];
      // JAX order: (theta + a_j) + pi, floor of an IEEE division, floor mod
      const float t = __fadd_rn(__fadd_rn(theta, b.y), a.pi_f);
      int k = __float2int_rd(__fdiv_rn(t, a.dtheta)) % a.n_theta;
      k += k < 0 ? a.n_theta : 0;
      const float z = __fdiv_rn(__fsub_rn(b.x, __ldg(row + k)), a.sigma);
      const float e = expf(__fmul_rn(-0.5f, __fmul_rn(z, z)));
      const float prob =
          __fadd_rn(__fmul_rn(a.z_hit, __fmul_rn(a.hit_norm, e)), a.z_floor);
      acc = __fadd_rn(acc, logf(fmaxf(prob, a.log_floor)));
    }
    acc = group_sum<G>(acc);
    if (active && g == 0) {
      out[i] = aggregate(acc, n_valid, a.sum_aggregation, a.blind_score);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads) voxel_scores_kernel(
    const float* __restrict__ particles, int n, const float* __restrict__ u,
    const float* __restrict__ v, const int* __restrict__ zrow,
    const unsigned char* __restrict__ live, int m,
    const float* __restrict__ volume, const int* __restrict__ count,
    VoxelArgs a, float* __restrict__ out) {
  extern __shared__ float4 s_b[];
  const int m_live = mcmh::stage_valid_beams<kThreads>(
      live, m, s_b, [=](int j) {
        return make_float4(u[j], v[j], __int_as_float(zrow[j]), 0.0f);
      });
  const int n_valid = __ldg(count);
  constexpr int kGroups = kThreads / G;
  const int g = threadIdx.x & (G - 1);
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
    const int j_end = active ? m_live : 0;
#pragma unroll 4
    for (int j = g; j < j_end; j += G) {
      const float4 b = s_b[j];
      // JAX order: (x + c*u) - s*v and (y + s*u) + c*v
      const float lx =
          __fsub_rn(__fadd_rn(x, __fmul_rn(c, b.x)), __fmul_rn(s, b.y));
      const float ly =
          __fadd_rn(__fadd_rn(y, __fmul_rn(s, b.x)), __fmul_rn(c, b.y));
      const int vx = __float2int_rd(__fmul_rn(__fsub_rn(lx, a.origin_x), a.inv));
      const int vy = __float2int_rd(__fmul_rn(__fsub_rn(ly, a.origin_y), a.inv));
      if (vx >= 0 && vx < a.w && vy >= 0 && vy < a.h) {
        const long long row = static_cast<long long>(__float_as_int(b.z)) + vy;
        acc = __fadd_rn(acc, __ldg(volume + row * a.w + vx));
      }
    }
    acc = group_sum<G>(acc);
    if (active && g == 0) {
      out[i] = aggregate(acc, n_valid, a.sum_aggregation, a.blind_score);
    }
  }
}

template <int G>
cudaError_t launch_table(const float* particles, int n, const float* ranges,
                         const float* angles, const unsigned char* valid,
                         int m, const float* table, const int* count,
                         const TableArgs& a, float* out,
                         cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  long long blocks = (static_cast<long long>(n) + kGroups - 1) / kGroups;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  table_scores_kernel<G>
      <<<static_cast<int>(blocks), kThreads, m * sizeof(float2), stream>>>(
          particles, n, ranges, angles, valid, m, table, count, a, out);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_voxel(const float* particles, int n, const float* u,
                         const float* v, const int* zrow,
                         const unsigned char* live, int m,
                         const float* volume, const int* count,
                         const VoxelArgs& a, int sm_count, float* out,
                         cudaStream_t stream) {
  const int smem = m * static_cast<int>(sizeof(float4));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        voxel_scores_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  // the blocks that fit the SMs at once (each stages the whole scan), at
  // most 8 of 256 threads an SM
  int per_sm = kSmemPerSm / (smem + 1024);
  per_sm = per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm);
  constexpr int kGroups = kThreads / G;
  long long blocks = (static_cast<long long>(n) + kGroups - 1) / kGroups;
  const long long cap = static_cast<long long>(sm_count) * per_sm;
  if (blocks > cap) blocks = cap;
  voxel_scores_kernel<G>
      <<<static_cast<int>(blocks), kThreads, smem, stream>>>(
          particles, n, u, v, zrow, live, m, volume, count, a, out);
  return cudaGetLastError();
}

}  // namespace

#define MCMH_LANES_SWITCH(CALL) \
  switch (lanes) {              \
    case 1: return CALL(1);     \
    case 2: return CALL(2);     \
    case 4: return CALL(4);     \
    case 8: return CALL(8);     \
    case 16: return CALL(16);   \
    case 32: return CALL(32);   \
    default: return cudaErrorInvalidValue; \
  }

namespace {

cudaError_t table_lanes(int lanes, const float* particles, int n,
                        const float* ranges, const float* angles,
                        const unsigned char* valid, int m, const float* table,
                        const int* count, const TableArgs& a, float* out,
                        cudaStream_t st) {
#define MCMH_TABLE(G) \
  launch_table<G>(particles, n, ranges, angles, valid, m, table, count, a, out, st)
  MCMH_LANES_SWITCH(MCMH_TABLE)
#undef MCMH_TABLE
}

cudaError_t voxel_lanes(int lanes, const float* particles, int n,
                        const float* u, const float* v, const int* zrow,
                        const unsigned char* live, int m,
                        const float* volume, const int* count,
                        const VoxelArgs& a, int sm_count, float* out,
                        cudaStream_t st) {
#define MCMH_VOXEL(G)                                                     \
  launch_voxel<G>(particles, n, u, v, zrow, live, m, volume, count, a,    \
                  sm_count, out, st)
  MCMH_LANES_SWITCH(MCMH_VOXEL)
#undef MCMH_VOXEL
}

}  // namespace

#undef MCMH_LANES_SWITCH

extern "C" int mcmh_table_scores(const float* particles, int n,
                                 const float* ranges, const float* angles,
                                 const unsigned char* valid, int m,
                                 const float* table, const int* count,
                                 TableArgs a, int lanes, float* out,
                                 void* stream) {
  if (n <= 0) return 0;
  if (m > kMaxTableBeams) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(table_lanes(lanes, particles, n, ranges, angles,
                                      valid, m, table, count, a, out,
                                      static_cast<cudaStream_t>(stream)));
}

extern "C" int mcmh_voxel_scores(const float* particles, int n,
                                 const float* u, const float* v,
                                 const int* zrow, const unsigned char* live,
                                 int m, const float* volume, const int* count,
                                 VoxelArgs a, int lanes, int sm_count,
                                 float* out, void* stream) {
  if (n <= 0) return 0;
  if (m > kMaxVoxelBeams) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(voxel_lanes(lanes, particles, n, u, v, zrow, live,
                                      m, volume, count, a, sm_count, out,
                                      static_cast<cudaStream_t>(stream)));
}
