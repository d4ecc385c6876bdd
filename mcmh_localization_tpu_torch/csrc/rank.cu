// Sorted-rank resampling expansion over a segment bound that may dip.
//
//   M = running max of bound                      (the monotone bound)
//   rank_in_sorted: idx[m] = min(#{j : M[j] <= v(m)}, R - 1)
//   expand_sorted:  out[m, :] = particles[idx[m], :]
//   with v(m) = min(m, cap), cap = min(count - 1, num_out - 1): output slots
//   at or past count repeat the last active slot, the tail rule of the TPU
//   kernel (rank_pallas.py::_kernel, `m = min(tile_m, cap)`).
//
// Replaces mcmh_localization_tpu/ops/rank_pallas.py::rank_in_sorted and
// ::expand_sorted, and the running max that ops/resampling.py::
// _segment_bounds applies before them there (jax.lax.cummax: a parallel
// cumsum can dip by an ulp, and ceil turns the dip into bound[i+1] <
// bound[i]).  The rank of v in M is the index of the first raw bound[j] > v,
// so the running max never has to leave the card as a separate pass.
//
// Two launches on one stream:
//  1. running_max_kernel: a single-pass max-scan of the raw bound with
//     decoupled look-back.  Tiles take their index from a counter in launch
//     order, publish their aggregate and then their inclusive prefix in one
//     64-bit status word each (flag << 32 | value), and one warp looks back
//     through its predecessors' words, 32 at a time, for its own prefix.
//     8 bytes per particle (read bound, write M).
//  2. expand_kernel: tiles of kExpTile output slots.  Two searches per
//     tile (one warp each, 32 probes a step) find its first and last
//     particle (j0, j1); the block walks
//     the segment starts M[j - 1] of the particles in (j0, j1] in parallel,
//     marks each start with its particle (a shared-memory max: of several
//     empty segments that start at one slot the last one wins), and fills
//     forward with a block max-scan.  Rows are gathered in slot order
//     (monotone, so the reads coalesce), staged in shared memory and
//     stored as 16-byte vectors.
//
// Bound: bytes.  Each input read once and each output written once is
// 4 R (bound) + 4 C R (particles) + 4 C num_out (out): 28 MB at R = num_out
// = 1M, C = 3; M adds 8 MB of scratch traffic.  The copy is bitwise.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// Large tiles keep the look-back short: every tile of a 1M bound is
// resident at once, and a tile's prefix waits on ~tiles / 32 rounds of
// predecessors' words.
constexpr int kScanThreads = 512;
constexpr int kScanItems = 16;  // consecutive bounds per thread
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kExpThreads = 256;
constexpr int kExpItems = 4;  // consecutive slots per thread in the fill
constexpr int kExpTile = kExpThreads * kExpItems;
constexpr int kMaxCols = 4;  // shared staging: kExpTile x kMaxCols f32

constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ int warp_inclusive_max(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = max(x, y);
  }
  return x;
}

// Exclusive max-scan across the block of one value per thread (identity
// INT_MIN); *total receives the block's max.  s_warp: 32 shared ints.
__device__ int block_exclusive_max(int x, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int incl = warp_inclusive_max(x);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int wv = warp_inclusive_max(lane < nwarps ? s_warp[lane] : INT_MIN);
    s_warp[lane] = wv;
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = INT_MIN;
  if (warp > 0) excl = max(excl, s_warp[warp - 1]);
  *total = s_warp[nwarps - 1];
  __syncthreads();  // s_warp may be reused after the return
  return excl;
}

__global__ void __launch_bounds__(kScanThreads)
running_max_kernel(const int* __restrict__ bound, int r,
                   int* __restrict__ mono,
                   unsigned long long* __restrict__ status,
                   unsigned int* __restrict__ counter) {
  __shared__ int s_warp[32];
  __shared__ int s_tile;
  __shared__ int s_prefix;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  const int tile = s_tile;
  const long long base =
      static_cast<long long>(tile) * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems];
  const bool vec = (reinterpret_cast<uintptr_t>(bound) & 15) == 0;
  if (vec && base + kScanItems <= r) {
    const int4* src = reinterpret_cast<const int4*>(bound + base);
#pragma unroll
    for (int i = 0; i < kScanItems / 4; ++i) {
      const int4 q = __ldg(src + i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      v[i] = base + i < r ? __ldg(bound + base + i) : INT_MIN;
    }
  }
#pragma unroll
  for (int i = 1; i < kScanItems; ++i) v[i] = max(v[i], v[i - 1]);
  int agg;
  const int excl = block_exclusive_max(v[kScanItems - 1], s_warp, &agg);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int prefix = INT_MIN;
    if (tile == 0) {
      if (lane == 0) atomicExch(status, kPrefix | static_cast<unsigned int>(agg));
    } else {
      if (lane == 0) {
        atomicExch(status + tile, kAggregate | static_cast<unsigned int>(agg));
      }
      // decoupled look-back, 32 predecessors at a time: every earlier tile
      // has started (the counter hands out indices in order), so each of
      // their words becomes nonzero; stop at the nearest inclusive prefix
      for (int end = tile - 1;; end -= 32) {
        const int t = end - lane;
        unsigned long long s = kPrefix | static_cast<unsigned int>(INT_MIN);
        if (t >= 0) {
          // plain device-coherent reads: polling with atomics would queue
          // every waiting warp on the same few L2 lines
          const volatile unsigned long long* word = status + t;
          while (((s = *word) >> 32) == 0) __nanosleep(64);
        }
        const unsigned int done = __ballot_sync(0xffffffffu, (s >> 32) == 2);
        const int first = done ? __ffs(done) - 1 : 32;
        int val = lane <= first ? static_cast<int>(static_cast<unsigned int>(s))
                                : INT_MIN;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          val = max(val, __shfl_xor_sync(0xffffffffu, val, d));
        }
        prefix = max(prefix, val);
        if (done) break;
      }
      if (lane == 0) {
        atomicExch(status + tile,
                   kPrefix | static_cast<unsigned int>(max(prefix, agg)));
      }
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const int pre = max(s_prefix, excl);
  if (base + kScanItems <= r) {  // mono comes from torch.empty: aligned
    int4* dst = reinterpret_cast<int4*>(mono + base);
#pragma unroll
    for (int i = 0; i < kScanItems / 4; ++i) {
      dst[i] = make_int4(max(pre, v[4 * i]), max(pre, v[4 * i + 1]),
                         max(pre, v[4 * i + 2]), max(pre, v[4 * i + 3]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (base + i < r) mono[base + i] = max(pre, v[i]);
    }
  }
}

// min(#{j : mono[j] <= v}, r - 1) over the nondecreasing mono, by one
// warp: each step probes 32 points of the interval (four dependent reads
// at r = 1M where a binary search makes twenty).
__device__ int warp_rank_of(const int* __restrict__ mono, int r, int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0;  // mono[j] <= v for j < lo; mono[j] > v for j >= hi
  int hi = r;
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const int probe = lo + static_cast<int>(span * (lane + 1) / 33);
    const unsigned int le = __ballot_sync(0xffffffffu, mono[probe] <= v);
    const int c = __popc(le);  // the probes at or below v form a prefix
    const int new_lo = c > 0 ? __shfl_sync(0xffffffffu, probe, c - 1) + 1 : lo;
    const int new_hi = c < 32 ? __shfl_sync(0xffffffffu, probe, c & 31) : hi;
    lo = new_lo;
    hi = new_hi;
  }
  const unsigned int le =
      __ballot_sync(0xffffffffu, lo + lane < hi && mono[lo + lane] <= v);
  return min(lo + __popc(le), r - 1);
}

template <bool kRows>
__global__ void __launch_bounds__(kExpThreads)
expand_kernel(const int* __restrict__ mono, int r,
              const float* __restrict__ particles, int c, int num_out,
              const int* __restrict__ count, float* __restrict__ out_rows,
              int* __restrict__ out_idx) {
  __shared__ int s_idx[kExpTile];
  __shared__ int s_warp[32];
  __shared__ int s_j[2];
  __shared__ __align__(16) float s_rows[kRows ? kExpTile * kMaxCols : 1];
  const int m0 = blockIdx.x * kExpTile;
  const int n = min(kExpTile, num_out - m0);
  int cap = num_out - 1;
  if (count != nullptr) cap = min(*count - 1, cap);
  if (threadIdx.x < 64) {  // warp 0 the first slot, warp 1 the last
    const int last = threadIdx.x >> 5;
    const int j = warp_rank_of(mono, r, min(last ? m0 + n - 1 : m0, cap));
    if ((threadIdx.x & 31) == 0) s_j[last] = j;
  }
  for (int p = threadIdx.x; p < kExpTile; p += kExpThreads) s_idx[p] = INT_MIN;
  __syncthreads();
  const int j0 = s_j[0];
  const int j1 = s_j[1];
  if (threadIdx.x == 0) s_idx[0] = j0;
  // particle j in (j0, j1] starts at slot value M[j - 1], which lies in
  // (v(m0), v(m0 + n - 1)] <= cap, where a slot's value is its index
  for (int j = j0 + 1 + threadIdx.x; j <= j1; j += kExpThreads) {
    atomicMax(&s_idx[mono[j - 1] - m0], j);
  }
  __syncthreads();
  // fill forward: each thread scans kExpItems consecutive slots
  int v[kExpItems];
  const int p0 = threadIdx.x * kExpItems;
#pragma unroll
  for (int i = 0; i < kExpItems; ++i) v[i] = s_idx[p0 + i];
#pragma unroll
  for (int i = 1; i < kExpItems; ++i) v[i] = max(v[i], v[i - 1]);
  int total;
  const int pre = block_exclusive_max(v[kExpItems - 1], s_warp, &total);
#pragma unroll
  for (int i = 0; i < kExpItems; ++i) s_idx[p0 + i] = max(pre, v[i]);
  __syncthreads();
  if (!kRows) {
    for (int p = threadIdx.x; p < n; p += kExpThreads) {
      out_idx[m0 + p] = s_idx[p];
    }
    return;
  }
  const int nf = n * c;
  for (int q = threadIdx.x; q < nf; q += kExpThreads) {
    const int p = q / c;
    s_rows[q] = particles[static_cast<long long>(s_idx[p]) * c + (q - p * c)];
  }
  __syncthreads();
  float* dst = out_rows + static_cast<long long>(m0) * c;
  const bool aligned = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  const int nv = aligned ? nf / 4 : 0;
  const float4* src4 = reinterpret_cast<const float4*>(s_rows);
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < nv; q += kExpThreads) dst4[q] = src4[q];
  for (int q = 4 * nv + threadIdx.x; q < nf; q += kExpThreads) {
    dst[q] = s_rows[q];
  }
}

int scan_tiles(int r) { return (r + kScanTile - 1) / kScanTile; }

// The running max into ``mono``; ``scratch``: mcmh_rank_scratch_words(r)
// 64-bit words, zeroed here on the stream.
cudaError_t launch_running_max(const int* bound, int r, int* mono,
                               unsigned long long* scratch,
                               cudaStream_t stream) {
  const int tiles = scan_tiles(r);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(unsigned long long) * (tiles + 1), stream);
  if (err != cudaSuccess) return err;
  running_max_kernel<<<tiles, kScanThreads, 0, stream>>>(
      bound, r, mono, scratch,
      reinterpret_cast<unsigned int*>(scratch + tiles));
  return cudaGetLastError();
}

}  // namespace

extern "C" int mcmh_rank_scratch_words(int r) { return scan_tiles(r) + 1; }

extern "C" int mcmh_rank_in_sorted(const int* bound, int r, int num_out,
                                   const int* count, int* mono,
                                   unsigned long long* scratch, int* out,
                                   void* stream) {
  if (num_out <= 0) return 0;
  if (r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_running_max(bound, r, mono, scratch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<false><<<(num_out + kExpTile - 1) / kExpTile, kExpThreads, 0,
                         s>>>(mono, r, nullptr, 0, num_out, count, nullptr,
                              out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcmh_expand_sorted(const int* bound, int r,
                                  const float* particles, int c, int num_out,
                                  const int* count, int* mono,
                                  unsigned long long* scratch, float* out,
                                  void* stream) {
  if (num_out <= 0) return 0;
  if (r <= 0 || c <= 0 || c > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_running_max(bound, r, mono, scratch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<true><<<(num_out + kExpTile - 1) / kExpTile, kExpThreads, 0,
                        s>>>(mono, r, particles, c, num_out, count, out,
                             nullptr);
  return static_cast<int>(cudaGetLastError());
}
