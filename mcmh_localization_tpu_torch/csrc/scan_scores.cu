// Fused scan scorers: kernel 2's table read with the index math before it
// and the mixture and beam sum after it.
//
// Replaces the two JAX scorers that read one table value per (particle,
// beam) through mcmh_localization_tpu/ops/gather_pallas.py::gather_2d
// (gather_rows_lanes on the TPU), each followed by a Gaussian mixture, a
// log and a sum over beams as (N, M) arrays:
//
// (a) models/range_table.py::raycast_table_scores, the beam model's
//     range-table scorer (the staged BIG program's, at 1M poses).  Per
//     pose: its cell by i32((p - origin) / res), clamped, and in_map.  Per
//     valid beam j (r_j, a_j):
//       k = floor((theta + a_j + pi_f) / (2 pi / K)) mod K
//       z = (r_j - table[cell, k]) / sigma
//       total += log(max(z_hit * (hit_norm * exp(-0.5 z^2)) + z_floor,
//                        log_floor))
//     An off-map pose adds nothing.  The two divisions are IEEE divisions
//     (XLA's, and utils/f32.py::divide's); exp and log are libdevice's
//     expf / logf (no fast math), the functions PyTorch's torch.exp and
//     torch.log call on the card.
// (b) models/sensor3d.py::lidar3d_scores, the 3-D lidar scorer.  Per pose
//     and live beam j, with the beam's sensor-frame (u_j, v_j) and voxel
//     plane vz_j computed once a scan (the endpoint height does not depend
//     on a planar pose):
//       lx = (x + c u_j) - s v_j,  ly = (y + s u_j) + c v_j
//       (vx, vy) = floor((l - origin) * inv)        (world_to_voxel's form)
//       total += volume[vz_j, vy, vx] if (vx, vy) lies in the volume
//     The volume is the per-voxel log mixture, built once per (map,
//     config) from the distance volume by the same PyTorch ops the JAX
//     scorer applies to each read (models/sensor3d.py::lidar3d_log_volume):
//     a read gives the f32 value that evaluating the mixture on the read
//     distance gives.  A beam whose plane lies outside the volume adds 0 to
//     every pose and is not staged ("live" is valid and in the volume's
//     height); it still counts in the "mean" denominator.
//
// Then both: out = count > 0 ? (sum ? total : total / max(count, 1)) : blind.
//
// Both tables hold few distinct values, so each is stored as 8- or 16-bit
// indices into its f32 levels (ops/scan_scores.py::table_levels,
// voxel_levels: levels[index] is the table bit for bit), chosen when the
// sensor table is built:
// - (a) the range table holds the ray march's quantized ranges (about 51
//   levels at max_range 5): a cell-major uint8 (int16 past 256 levels)
//   index table (14 MB at K = 96 on a 384^2 map, L2-resident) and a
//   per-scan LUT of the log mixture over the valid beams x levels,
//   computed by a first launch in the pair's own op order (lut_kernel)
//   and copied into shared memory by each block of the scorer.  Each
//   group copies its pose's index row into shared memory once (a row
//   read per pair would fetch a 32-byte sector from L2 each), so a pair
//   is its bin (two adds, the IEEE division, a floor and one conditional
//   add or subtract for the mod), a shared byte read and a shared LUT
//   read: bitwise the value the per-pair mixture gives, since each level
//   is bitwise the value the pair reads.
//   A table with more than 1024 levels keeps the per-pair form
//   (table_pairs_kernel).
// - (b) beyond about 6.5 sigma from a surface every voxel holds the same
//   value, so a [lidar3d] volume holds about a thousand levels: 16-bit
//   indices (19.2 MB for 400 x 400 x 60, half the f32 volume's L2
//   footprint), each plane in 4 x 4 bricks of one 32-byte sector each, so
//   endpoints near in x or y share a sector, and the levels in shared
//   memory.  The voxel's floor is an exact add (floor_small), not a
//   quarter-rate float-to-int conversion, and its bounds one unsigned
//   compare a coordinate.  A volume with more than 4096 levels keeps the
//   f32 form (read as it is, row-major planes, the floor by conversion).
//
// Layout (csrc/likelihood.cu's): the block stages its scan's beams in
// shared memory, compacted in ascending beam order (stage_beams.cuh); G
// lanes take one pose (G from N: ops/likelihood.py::lanes_per_particle
// for (a), ops/scan_scores.py::voxel_lanes for (b)); the group's first
// lane loads the pose and computes its cell (a) or cosf / sinf (b) once,
// the others take them by shuffle; lane g adds the staged beams g, g + G,
// ... from +0.0 in ascending order, then an xor butterfly over the group,
// offsets G/2 down to 1.  ops/scan_scores.py's plain versions sum in that
// order (ops/likelihood.py::lane_sum), so kernel and plain version agree
// bitwise.  Every rounding is explicit (_rn intrinsics, --fmad=false).
// (b) stages its beams in tiles of kVoxelTile raw beams, (a) its beams in
// tiles of kTableTile raw beams and, in the level form, the LUT rows of
// each tile's valid beams in tiles of kLutFloats floats, all in ascending
// order: lane g adds the valid beams whose rank among all the scan's
// valid beams is g mod G (the ranks before a tile carried as a running
// base), so a lane's sum carries across tiles in one tile's order, any
// scan length takes the same sums, and a block needs at most about 60 KB,
// so an SM holds several.  A scan of at most one tile is staged once for
// all the block's poses (in the per-pair form, by a template instance of
// its own).
//
// Bounds, on an H100 SXM at 700 W: (a) at the staged BIG program's 2 x 1M
// poses and a house scan's 114 valid beams of 360 is bound by operations
// (the level form: 6 a pair, and the mixture's 10 once an entry of the
// scan's LUT: 0.020 ms at 67 TFLOP/s f32; the table read once is below
// it); (b) at 2 x 100k poses and 5760 beams by operations (13 a pair, as
// kernel 6), its volume L2-resident.  What sets their pace on the card is
// issue and the L2's sector rate (PERF.md §6).

#include <cuda_runtime.h>

#include "stage_beams.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
constexpr int kTableTile = 2048;       // raw beams a tile of (a): 16 KB of float2
constexpr int kVoxelTile = 512;        // raw beams a tile of (b): 8 KB
constexpr int kMaxVoxelLevels = 4096;  // (b)'s levels in shared memory: 16 KB
constexpr int kMaxTableLevels = 1024;
constexpr int kLutFloats = 6144;       // (a)'s LUT rows a tile: 24 KB
constexpr int kRowBytes = 32 * 1024;   // (a)'s pose rows of the index table
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

// The first index >= t0 that lane g of G takes: j == g (mod G).
template <int G>
__device__ __forceinline__ int first_of_lane(int t0, int g) {
  return t0 + ((g - t0) & (G - 1));
}

// The blocks that fit the SMs at once with ``smem`` bytes each, at most 8
// of kThreads threads an SM.
__host__ int resident_blocks(int smem, int sm_count) {
  int per_sm = kSmemPerSm / (smem + 1024);
  per_sm = per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm);
  return sm_count * per_sm;
}

__host__ cudaError_t allow_smem(const void* kernel, int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The per-pair log mixture of (a) at range r and table value d, in the
// JAX op order (and PyTorch's: ops/scan_scores.py::_pair_mixture).
__device__ __forceinline__ float pair_mixture(float r, float d,
                                              const TableArgs& a) {
  const float z = __fdiv_rn(__fsub_rn(r, d), a.sigma);
  const float e = expf(__fmul_rn(-0.5f, __fmul_rn(z, z)));
  const float prob =
      __fadd_rn(__fmul_rn(a.z_hit, __fmul_rn(a.hit_norm, e)), a.z_floor);
  return logf(fmaxf(prob, a.log_floor));
}

// floor((theta + a_j + pi) / dtheta) mod K, in the JAX order: for
// headings and beam angles in [-pi, pi] the quotient lies in [-K, 2K) and
// one conditional add or subtract gives the floor mod; anything else takes
// the mod.
__device__ __forceinline__ int theta_bin(float theta, float angle,
                                         const TableArgs& a) {
  const float t = __fadd_rn(__fadd_rn(theta, angle), a.pi_f);
  int k = __float2int_rd(__fdiv_rn(t, a.dtheta));
  k -= k >= a.n_theta ? a.n_theta : 0;
  k += k < 0 ? a.n_theta : 0;
  if (static_cast<unsigned>(k) >= static_cast<unsigned>(a.n_theta)) {
    k %= a.n_theta;
    k += k < 0 ? a.n_theta : 0;
  }
  return k;
}

// The pose of (a): its heading, its cell row of the table and in_map, from
// the group's first lane.
template <int G>
__device__ __forceinline__ void table_pose(const float* __restrict__ particles,
                                           long long i, bool active, int g,
                                           const TableArgs& a, float& theta,
                                           int& cell, int& in_map) {
  theta = 0.0f;
  cell = 0;
  in_map = 0;
  if (active && g == 0) {
    const float x = particles[3 * i];
    const float y = particles[3 * i + 1];
    theta = particles[3 * i + 2];
    const int mx = __float2int_rz(__fdiv_rn(__fsub_rn(x, a.origin_x), a.res));
    const int my = __float2int_rz(__fdiv_rn(__fsub_rn(y, a.origin_y), a.res));
    in_map = mx >= 0 && mx < a.w && my >= 0 && my < a.h;
    cell = min(max(my, 0), a.h - 1) * a.w + min(max(mx, 0), a.w - 1);
  }
  if (G > 1) {
    theta = __shfl_sync(0xffffffffu, theta, 0, G);
    cell = __shfl_sync(0xffffffffu, cell, 0, G);
    in_map = __shfl_sync(0xffffffffu, in_map, 0, G);
  }
}

// (a), the per-pair form: the f32 table read and the mixture a pair.
// kTiled: the scan has more than kTableTile beams, staged a tile at a time
// for each group of poses; else it is staged once for the block's poses
// (a template instance of its own, as kernel 6's, so a scan of one tile
// runs the single-staging code).
template <int G, bool kTiled>
__global__ void __launch_bounds__(kThreads) table_pairs_kernel(
    const float* __restrict__ particles, int n,
    const float* __restrict__ ranges, const float* __restrict__ angles,
    const unsigned char* __restrict__ valid, int m,
    const float* __restrict__ table, const int* __restrict__ count,
    TableArgs a, float* __restrict__ out) {
  extern __shared__ float2 s_ra[];
  // the valid beams of raw beams [t0, t0 + kTableTile), compacted
  auto stage = [=](int t0) {
    return mcmh::stage_valid_beams<kThreads>(
        valid + t0, min(kTableTile, m - t0), s_ra,
        [=](int j) { return make_float2(ranges[t0 + j], angles[t0 + j]); });
  };
  int m_valid = 0;
  if constexpr (!kTiled) m_valid = stage(0);
  const int n_valid = __ldg(count);
  constexpr int kGroups = kThreads / G;
  const int g = threadIdx.x & (G - 1);
  for (long long i0 = static_cast<long long>(blockIdx.x) * kGroups; i0 < n;
       i0 += static_cast<long long>(gridDim.x) * kGroups) {
    const long long i = i0 + threadIdx.x / G;
    const bool active = i < n;
    float theta;
    int cell, in_map;
    table_pose<G>(particles, i, active, g, a, theta, cell, in_map);
    const float* __restrict__ row =
        table + static_cast<long long>(cell) * a.n_theta;
    // lane g's sum over the staged valid beams j == base + g (mod G)
    auto pairs = [&](float acc, int j0, int staged) {
      const int j_end = in_map ? staged : 0;  // in_map only where active
#pragma unroll 2
      for (int j = j0; j < j_end; j += G) {
        const float2 b = s_ra[j];
        const int k = theta_bin(theta, b.y, a);
        acc = __fadd_rn(acc, pair_mixture(b.x, __ldg(row + k), a));
      }
      return acc;
    };
    float acc = 0.0f;
    if constexpr (!kTiled) {
      acc = pairs(acc, g, m_valid);
    } else {
      int base = 0;  // valid beams staged before this tile
      for (int t0 = 0; t0 < m; t0 += kTableTile) {
        const int staged = stage(t0);
        acc = pairs(acc, first_of_lane<G>(base, g) - base, staged);
        base += staged;
        __syncthreads();  // s_ra is rewritten by the next tile
      }
    }
    acc = group_sum<G>(acc);
    if (active && g == 0) {
      out[i] = aggregate(acc, n_valid, a.sum_aggregation, a.blind_score);
    }
  }
}

// (a)'s per-scan LUT over the valid beams in ascending order: lut[i * nq +
// q] = the mixture of the i-th valid beam at level q.  Each block compacts
// the scan's ranges in tiles of kTableTile raw beams in shared memory and
// computes its entries of each tile's rows.
__global__ void __launch_bounds__(kThreads) lut_kernel(
    const float* __restrict__ ranges, const unsigned char* __restrict__ valid,
    int m, const float* __restrict__ levels, int nq, TableArgs a,
    float* __restrict__ lut) {
  extern __shared__ float s_r[];
  const int stride = gridDim.x * kThreads;
  const int e0 = blockIdx.x * kThreads + threadIdx.x;
  int base = 0;  // valid beams staged before this tile
  for (int t0 = 0; t0 < m; t0 += kTableTile) {
    const int staged = mcmh::stage_valid_beams<kThreads>(
        valid + t0, min(kTableTile, m - t0), s_r,
        [=](int j) { return ranges[t0 + j]; });
    // this thread's entries of the rows [base, base + staged)
    const int lo = base * nq;
    int e = e0 < lo ? e0 + (lo - e0 + stride - 1) / stride * stride : e0;
    for (; e < (base + staged) * nq; e += stride) {
      const int i = e / nq;
      lut[e] = pair_mixture(s_r[i - base], __ldg(levels + (e - i * nq)), a);
    }
    base += staged;
    __syncthreads();  // s_r is rewritten by the next tile
  }
}

// (a), the LUT form.  Shared memory: a tile's valid beams' angles,
// compacted, a tile of ``rows`` LUT rows of nq floats and, with
// kStageRows, each group's pose row of the index table (``row_words``
// 32-bit words a row, an odd count, so that lanes reading the same bin of
// different rows hit different banks).  A pair's index read is then a
// shared-memory byte read, where from the table each would fetch its own
// 32-byte sector from L2.
template <int G, class Idx, bool kStageRows>
__global__ void __launch_bounds__(kThreads) table_lut_kernel(
    const float* __restrict__ particles, int n,
    const float* __restrict__ angles, const unsigned char* __restrict__ valid,
    int m, const Idx* __restrict__ index, const float* __restrict__ lut,
    int nq, int rows, int row_words, const int* __restrict__ count,
    TableArgs a, float* __restrict__ out) {
  extern __shared__ float s_a[];
  float* s_lp = s_a + min(m, kTableTile);
  unsigned int* s_rows = reinterpret_cast<unsigned int*>(s_lp + rows * nq);
  // the valid beams' angles of raw beams [t0, t0 + kTableTile), compacted
  auto stage_angles = [=](int t0) {
    return mcmh::stage_valid_beams<kThreads>(
        valid + t0, min(kTableTile, m - t0), s_a,
        [=](int j) { return angles[t0 + j]; });
  };
  // the LUT rows of the valid beams [t0, t1): one contiguous copy
  auto stage_rows = [&](int t0, int t1) {
    const float* __restrict__ src = lut + t0 * nq;
#pragma unroll 8
    for (int e = threadIdx.x; e < (t1 - t0) * nq; e += kThreads) {
      s_lp[e] = __ldg(src + e);
    }
  };
  const bool one_beam_tile = m <= kTableTile;
  const int m_one = one_beam_tile ? stage_angles(0) : 0;
  // the scan's whole LUT in one tile: staged once for all the poses
  const bool one_tile = one_beam_tile && m_one <= rows;
  if (one_tile) {
    stage_rows(0, m_one);
    __syncthreads();
  }
  const int n_valid = __ldg(count);
  const int row_bytes = a.n_theta * static_cast<int>(sizeof(Idx));
  constexpr int kGroups = kThreads / G;
  const int g = threadIdx.x & (G - 1);
  unsigned int* my_row = s_rows + (threadIdx.x / G) * row_words;
  for (long long i0 = static_cast<long long>(blockIdx.x) * kGroups; i0 < n;
       i0 += static_cast<long long>(gridDim.x) * kGroups) {
    const long long i = i0 + threadIdx.x / G;
    const bool active = i < n;
    float theta;
    int cell, in_map;
    table_pose<G>(particles, i, active, g, a, theta, cell, in_map);
    const Idx* __restrict__ row =
        index + static_cast<long long>(cell) * a.n_theta;
    if constexpr (kStageRows) {
      // the group copies its pose's row: 4-byte words where the row holds
      // whole words (and so starts on one), else bytes
      __syncwarp();  // the group's lanes are done with the previous row
      if (in_map && (row_bytes & 3) == 0) {
        const unsigned int* src = reinterpret_cast<const unsigned int*>(row);
        for (int w = g; w < (row_bytes >> 2); w += G) my_row[w] = __ldg(src + w);
      } else if (in_map) {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(row);
        unsigned char* dst = reinterpret_cast<unsigned char*>(my_row);
        for (int b = g; b < row_bytes; b += G) dst[b] = __ldg(src + b);
      }
      __syncwarp();
    }
    const Idx* pose_row = row;
    if constexpr (kStageRows) pose_row = reinterpret_cast<const Idx*>(my_row);
    float acc = 0.0f;
    int base = 0;  // valid beams staged before this beam tile
    for (int r0 = 0; r0 < m; r0 += kTableTile) {
      const int staged = one_beam_tile ? m_one : stage_angles(r0);
      // the LUT rows of the valid beams [base, base + staged), ``rows`` at
      // a time
      for (int t0 = base; t0 < base + staged; t0 += rows) {
        const int t1 = min(t0 + rows, base + staged);
        if (!one_tile) {
          stage_rows(t0, t1);
          __syncthreads();
        }
        const int j_end = in_map ? t1 : 0;  // in_map only where active
#pragma unroll 8
        for (int j = first_of_lane<G>(t0, g); j < j_end; j += G) {
          const int k = theta_bin(theta, s_a[j - base], a);
          int q;
          if constexpr (kStageRows) {
            q = static_cast<int>(pose_row[k]);
          } else {
            q = static_cast<int>(__ldg(pose_row + k));
          }
          acc = __fadd_rn(acc, s_lp[(j - t0) * nq + q]);
        }
        if (!one_tile) __syncthreads();  // s_lp is rewritten by the next tile
      }
      base += staged;
      if (!one_beam_tile) __syncthreads();  // s_a is rewritten by the next tile
    }
    acc = group_sum<G>(acc);
    if (active && g == 0) {
      out[i] = aggregate(acc, n_valid, a.sum_aggregation, a.blind_score);
    }
  }
}

// (b)'s two reads: the f32 form (row-major planes) and the level form
// (16-bit indices in planes of 4 x 4 bricks, the levels in shared memory).
// ``plane_of`` is what a staged beam carries for its plane vz, ``read`` the
// value at (vy, vx) of that plane.
struct VolumeF32 {
  const float* volume;
  long long plane;  // H * W
  int w;
  __device__ __forceinline__ int plane_of(int vz) const { return vz; }
  __device__ __forceinline__ float read(int vz, int vy, int vx) const {
    return __ldg(volume + vz * plane + vy * w + vx);
  }
};

struct VolumeLevels {
  const unsigned short* index;
  const float* levels;  // in shared memory
  int plane;            // Hp * Wp: the plane padded to whole 4 x 4 bricks
  int wp;
  __device__ __forceinline__ int plane_of(int vz) const { return vz * plane; }
  __device__ __forceinline__ float read(int base, int vy, int vx) const {
    // the 4 x 4 brick (one 32-byte sector), then the voxel in it:
    // ((vy >> 2) * Wp / 4 + (vx >> 2)) * 16 + (vy & 3) * 4 + (vx & 3)
    const int off = base + (vy & ~3) * wp +
                    ((((vx & ~3) | (vy & 3)) << 2) | (vx & 3));
    return levels[__ldg(index + off)];
  }
};

// floor(f) for |f| < 2^22: f + 1.5 * 2^23 rounded down is exact, and its
// low mantissa bits are floor(f) (no float-to-int conversion, which issues
// at a quarter of the f32 rate).  Past that range, and for inf and NaN,
// the result lies outside [0, 2^22), so an unsigned compare against a
// bound below 2^22 is the in-bounds test of floor(f).
__device__ __forceinline__ int floor_small(float f) {
  return __float_as_int(__fadd_rd(f, 12582912.0f)) - 0x4B400000;
}

// (b): the beams staged in tiles of kVoxelTile raw beams (one tile, staged
// once, when m fits), the volume read by ``Reader``.  With kSmallPlanes (H
// and W below 2^22: ops/scan_scores.py::voxel_levels gives the level form
// only then) the floor is floor_small's; otherwise world_to_voxel's floor
// to int.
template <int G, bool kSmallPlanes, class Reader>
__device__ __forceinline__ void voxel_scores_body(
    const float* __restrict__ particles, int n, const float* __restrict__ u,
    const float* __restrict__ v, const int* __restrict__ zrow,
    const unsigned char* __restrict__ live, int m, const Reader& rd,
    const int* __restrict__ count, const VoxelArgs& a, float4* s_b,
    float* __restrict__ out) {
  const int h = a.h;
  auto stage = [&](int t0) {
    return mcmh::stage_valid_beams<kThreads>(
        live + t0, min(kVoxelTile, m - t0), s_b, [=](int j) {
          return make_float4(u[t0 + j], v[t0 + j],
                             __int_as_float(rd.plane_of(zrow[t0 + j] / h)),
                             0.0f);
        });
  };
  const bool one_tile = m <= kVoxelTile;
  const int m_one = one_tile ? stage(0) : 0;
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
    int base = 0;  // live beams staged before this tile
    for (int t0 = 0; t0 < m; t0 += kVoxelTile) {
      const int staged = one_tile ? m_one : stage(t0);
      const int j_end = active ? staged : 0;
#pragma unroll 8
      for (int j = first_of_lane<G>(base, g) - base; j < j_end; j += G) {
        const float4 b = s_b[j];
        // JAX order: (x + c*u) - s*v and (y + s*u) + c*v
        const float lx =
            __fsub_rn(__fadd_rn(x, __fmul_rn(c, b.x)), __fmul_rn(s, b.y));
        const float ly =
            __fadd_rn(__fadd_rn(y, __fmul_rn(s, b.x)), __fmul_rn(c, b.y));
        const float fx = __fmul_rn(__fsub_rn(lx, a.origin_x), a.inv);
        const float fy = __fmul_rn(__fsub_rn(ly, a.origin_y), a.inv);
        if constexpr (kSmallPlanes) {
          const int vx = floor_small(fx);
          const int vy = floor_small(fy);
          if (static_cast<unsigned>(vx) < static_cast<unsigned>(a.w) &&
              static_cast<unsigned>(vy) < static_cast<unsigned>(a.h)) {
            acc = __fadd_rn(acc, rd.read(__float_as_int(b.z), vy, vx));
          }
        } else {
          const int vx = __float2int_rd(fx);
          const int vy = __float2int_rd(fy);
          if (vx >= 0 && vx < a.w && vy >= 0 && vy < a.h) {
            acc = __fadd_rn(acc, rd.read(__float_as_int(b.z), vy, vx));
          }
        }
      }
      base += staged;
      if (!one_tile) __syncthreads();  // s_b is rewritten by the next tile
    }
    acc = group_sum<G>(acc);
    if (active && g == 0) {
      out[i] = aggregate(acc, n_valid, a.sum_aggregation, a.blind_score);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads) voxel_f32_kernel(
    const float* __restrict__ particles, int n, const float* __restrict__ u,
    const float* __restrict__ v, const int* __restrict__ zrow,
    const unsigned char* __restrict__ live, int m,
    const float* __restrict__ volume, const int* __restrict__ count,
    VoxelArgs a, float* __restrict__ out) {
  extern __shared__ float4 s_b[];
  const VolumeF32 rd{volume, static_cast<long long>(a.h) * a.w, a.w};
  voxel_scores_body<G, false>(particles, n, u, v, zrow, live, m, rd, count, a,
                              s_b, out);
}

template <int G>
__global__ void __launch_bounds__(kThreads) voxel_levels_kernel(
    const float* __restrict__ particles, int n, const float* __restrict__ u,
    const float* __restrict__ v, const int* __restrict__ zrow,
    const unsigned char* __restrict__ live, int m,
    const unsigned short* __restrict__ index,
    const float* __restrict__ levels, int n_levels,
    const int* __restrict__ count, VoxelArgs a, float* __restrict__ out) {
  extern __shared__ float4 s_b[];
  float* s_lv = reinterpret_cast<float*>(s_b + min(m, kVoxelTile));
  for (int q = threadIdx.x; q < n_levels; q += kThreads) s_lv[q] = levels[q];
  __syncthreads();
  const int hp = (a.h + 3) & ~3;
  const int wp = (a.w + 3) & ~3;
  const VolumeLevels rd{index, s_lv, hp * wp, wp};
  voxel_scores_body<G, true>(particles, n, u, v, zrow, live, m, rd, count, a,
                             s_b, out);
}

template <int G>
cudaError_t launch_table_pairs(const float* particles, int n,
                               const float* ranges, const float* angles,
                               const unsigned char* valid, int m,
                               const float* table, const int* count,
                               const TableArgs& a, float* out,
                               cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  long long blocks = (static_cast<long long>(n) + kGroups - 1) / kGroups;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (m <= kTableTile) {
    table_pairs_kernel<G, false>
        <<<static_cast<int>(blocks), kThreads, m * sizeof(float2), stream>>>(
            particles, n, ranges, angles, valid, m, table, count, a, out);
  } else {
    table_pairs_kernel<G, true>
        <<<static_cast<int>(blocks), kThreads, kTableTile * sizeof(float2),
           stream>>>(particles, n, ranges, angles, valid, m, table, count, a,
                     out);
  }
  return cudaGetLastError();
}

template <int G, class Idx, bool kStageRows>
cudaError_t launch_table_lut_as(const float* particles, int n,
                                const float* angles,
                                const unsigned char* valid, int m,
                                const Idx* index, const float* lut, int nq,
                                int rows, int row_words, const int* count,
                                const TableArgs& a, int sm_count, float* out,
                                cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const int smem = ((m < kTableTile ? m : kTableTile) + rows * nq +
                    (kStageRows ? kGroups * row_words : 0)) *
                   static_cast<int>(sizeof(float));
  const void* kernel =
      reinterpret_cast<const void*>(table_lut_kernel<G, Idx, kStageRows>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // the blocks that fit the SMs at once: each stages the scan's LUT once
  long long blocks = (static_cast<long long>(n) + kGroups - 1) / kGroups;
  const long long cap = resident_blocks(smem, sm_count);
  if (blocks > cap) blocks = cap;
  table_lut_kernel<G, Idx, kStageRows>
      <<<static_cast<int>(blocks), kThreads, smem, stream>>>(
          particles, n, angles, valid, m, index, lut, nq, rows, row_words,
          count, a, out);
  return cudaGetLastError();
}

template <int G, class Idx>
cudaError_t launch_table_lut(const float* particles, int n,
                             const float* ranges, const float* angles,
                             const unsigned char* valid, int m,
                             const Idx* index, const float* levels, int nq,
                             float* lut, const int* count, const TableArgs& a,
                             int sm_count, float* out, cudaStream_t stream) {
  const int tile = m < kTableTile ? m : kTableTile;
  int lut_blocks = (m * nq + kThreads - 1) / kThreads;
  lut_blocks = lut_blocks < 1 ? 1 : (lut_blocks > kMaxBlocks ? kMaxBlocks
                                                             : lut_blocks);
  lut_kernel<<<lut_blocks, kThreads, tile * static_cast<int>(sizeof(float)),
               stream>>>(ranges, valid, m, levels, nq, a, lut);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = tile < kLutFloats / nq ? tile : kLutFloats / nq;
  // a pose row in shared memory: whole words, an odd count
  const int row_words =
      ((a.n_theta * static_cast<int>(sizeof(Idx)) + 3) / 4) | 1;
  constexpr int kGroups = kThreads / G;
  if (kGroups * row_words * static_cast<int>(sizeof(float)) <= kRowBytes) {
    return launch_table_lut_as<G, Idx, true>(
        particles, n, angles, valid, m, index, lut, nq, rows, row_words,
        count, a, sm_count, out, stream);
  }
  return launch_table_lut_as<G, Idx, false>(
      particles, n, angles, valid, m, index, lut, nq, rows, 0, count, a,
      sm_count, out, stream);
}

template <int G>
cudaError_t launch_voxel(const float* particles, int n, const float* u,
                         const float* v, const int* zrow,
                         const unsigned char* live, int m,
                         const float* volume, const unsigned short* index,
                         const float* levels, int n_levels, const int* count,
                         const VoxelArgs& a, int sm_count, float* out,
                         cudaStream_t stream) {
  const int tile = m < kVoxelTile ? m : kVoxelTile;
  const int smem = tile * static_cast<int>(sizeof(float4)) +
                   (index ? n_levels * static_cast<int>(sizeof(float)) : 0);
  const void* kernel =
      index ? reinterpret_cast<const void*>(voxel_levels_kernel<G>)
            : reinterpret_cast<const void*>(voxel_f32_kernel<G>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // the blocks that fit the SMs at once, each striding over poses
  constexpr int kGroups = kThreads / G;
  long long blocks = (static_cast<long long>(n) + kGroups - 1) / kGroups;
  const long long cap = resident_blocks(smem, sm_count);
  if (blocks > cap) blocks = cap;
  if (index) {
    voxel_levels_kernel<G><<<static_cast<int>(blocks), kThreads, smem,
                             stream>>>(particles, n, u, v, zrow, live, m,
                                       index, levels, n_levels, count, a,
                                       out);
  } else {
    voxel_f32_kernel<G><<<static_cast<int>(blocks), kThreads, smem, stream>>>(
        particles, n, u, v, zrow, live, m, volume, count, a, out);
  }
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

cudaError_t table_dispatch(int lanes, const float* particles, int n,
                        const float* ranges, const float* angles,
                        const unsigned char* valid, int m, const float* table,
                        const void* index, int index_bytes,
                        const float* levels, int nq, float* lut,
                        const int* count, const TableArgs& a, int sm_count,
                        float* out, cudaStream_t st) {
  if (index == nullptr) {
#define MCMH_PAIRS(G)                                                    \
  launch_table_pairs<G>(particles, n, ranges, angles, valid, m, table,   \
                        count, a, out, st)
    MCMH_LANES_SWITCH(MCMH_PAIRS)
#undef MCMH_PAIRS
  }
  if (index_bytes == 1) {
    const auto* idx = static_cast<const unsigned char*>(index);
#define MCMH_LUT(G)                                                          \
  launch_table_lut<G>(particles, n, ranges, angles, valid, m, idx, levels,  \
                      nq, lut, count, a, sm_count, out, st)
    MCMH_LANES_SWITCH(MCMH_LUT)
  }
  const auto* idx = static_cast<const short*>(index);
  MCMH_LANES_SWITCH(MCMH_LUT)
#undef MCMH_LUT
}

cudaError_t voxel_dispatch(int lanes, const float* particles, int n,
                        const float* u, const float* v, const int* zrow,
                        const unsigned char* live, int m,
                        const float* volume, const unsigned short* index,
                        const float* levels, int n_levels, const int* count,
                        const VoxelArgs& a, int sm_count, float* out,
                        cudaStream_t st) {
#define MCMH_VOXEL(G)                                                     \
  launch_voxel<G>(particles, n, u, v, zrow, live, m, volume, index,       \
                  levels, n_levels, count, a, sm_count, out, st)
  MCMH_LANES_SWITCH(MCMH_VOXEL)
#undef MCMH_VOXEL
}

}  // namespace

#undef MCMH_LANES_SWITCH

// Form (a): ``index`` null takes the per-pair form on the f32 ``table``;
// otherwise ``index`` holds (H*W, K) level indices of ``index_bytes`` bytes
// (1: uint8, 2: int16) into the nq f32 ``levels``, and ``lut`` is scratch
// of m * nq floats.  Launches two kernels (the LUT, the scorer) in the
// LUT form, one in the per-pair form.
extern "C" int mcmh_table_scores(const float* particles, int n,
                                 const float* ranges, const float* angles,
                                 const unsigned char* valid, int m,
                                 const float* table, const void* index,
                                 int index_bytes, const float* levels, int nq,
                                 float* lut, const int* count, TableArgs a,
                                 int lanes, int sm_count, float* out,
                                 void* stream) {
  if (n <= 0) return 0;
  if (index != nullptr && (nq < 1 || nq > kMaxTableLevels ||
                           (index_bytes != 1 && index_bytes != 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(table_dispatch(
      lanes, particles, n, ranges, angles, valid, m, table, index,
      index_bytes, levels, nq, lut, count, a, sm_count, out,
      static_cast<cudaStream_t>(stream)));
}

// Form (b): ``index`` null reads the f32 ``volume`` (D, H, W); otherwise
// ``index`` holds the 16-bit level index of every voxel in tiled planes
// (ops/scan_scores.py::tile_planes) into the n_levels f32 ``levels``.
extern "C" int mcmh_voxel_scores(const float* particles, int n,
                                 const float* u, const float* v,
                                 const int* zrow, const unsigned char* live,
                                 int m, const float* volume,
                                 const unsigned short* index,
                                 const float* levels, int n_levels,
                                 const int* count, VoxelArgs a, int lanes,
                                 int sm_count, float* out, void* stream) {
  if (n <= 0) return 0;
  if (index != nullptr && (n_levels < 1 || n_levels > kMaxVoxelLevels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(voxel_dispatch(lanes, particles, n, u, v, zrow, live,
                                      m, volume, index, levels, n_levels,
                                      count, a, sm_count, out,
                                      static_cast<cudaStream_t>(stream)));
}
