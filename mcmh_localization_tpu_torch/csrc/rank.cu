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
// expand_sorted (kernel 3): a memset of the look-back words and two
// launches on one stream:
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
//  Bound: bytes.  Each input read once and each output written once is
//  4 R (bound) + 4 C R (particles) + 4 C num_out (out): 28 MB at R = num_out
//  = 1M, C = 3; M adds 8 MB of scratch traffic.  The copy is bitwise.
//
// rank_in_sorted (kernel 4): one launch, no memset, M kept on chip where
// the weights allow.  Bound: bytes, 4 R + 4 num_out (8 MB at 1M / 1M).
//  * Each block takes a ticket from a counter that wraps to 0 after the
//    grid's last block (atomicInc), so it needs no zeroing; so does the
//    count of finished tiles.  The first `tiles` tickets scan tiles of
//    kRankTile particles with the decoupled look-back above; their status
//    words, the piece count and the go word carry the call's epoch (a host
//    counter), so words of earlier calls read as unset and nothing is
//    zeroed between calls.
//  * A scan tile holds its particles' M in registers.  Particle j owns the
//    output slots of [M[j-1], M[j]) (j = 0 from -inf, j = R-1 to +inf),
//    clipped to [0, cap], plus the tail past cap for the particle owning
//    cap: a contiguous slot range, and the tile's particles together own the
//    contiguous range [L, H).  A "light" tile (H - L <= kWindow slots, every
//    tile under near-uniform weights) fills it itself: segment starts
//    marked in shared memory, a block max-scan, coalesced stores.
//  * A "heavy" tile (one particle, or a few, owning many slots) would write
//    at one SM's store rate.  It writes its M to global scratch and cuts
//    [L, H) into kPiece-slot pieces, each listed with its first and last
//    owner (a search in shared memory), for the helper blocks: the last
//    kHelpers tickets, which wait for the go word (set by the last tile to
//    finish), then split the list among them.
//  What holds it back: the look-back.  A tile's prefix waits on a chain of
//  predecessors that advances 32 tiles a round trip, eight hops over the
//  245 tiles of a 1M bound; the kernel reads about a fifth of its bound
//  (0.0124 ms at 1M / 1M on an H100 80GB HBM3 at 700 W, against 0.0024).  A piece with one owner is a plain fill; any
//    other is expanded as expand_kernel does, from the tile's M in L2.
#include <cuda_runtime.h>

#include <algorithm>
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

__global__ void __launch_bounds__(kExpThreads)
expand_kernel(const int* __restrict__ mono, int r,
              const float* __restrict__ particles, int c, int num_out,
              const int* __restrict__ count, float* __restrict__ out_rows) {
  __shared__ int s_idx[kExpTile];
  __shared__ int s_warp[32];
  __shared__ int s_j[2];
  __shared__ __align__(16) float s_rows[kExpTile * kMaxCols];
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

// ---------------------------------------------------------------------------
// kernel 4: rank_in_sorted in one launch (see the header)

constexpr int kRankThreads = 256;
constexpr int kRankItems = 16;  // consecutive particles per thread
constexpr int kRankTile = kRankThreads * kRankItems;
constexpr int kWindow = 8192;   // slots a light tile fills itself
constexpr int kWindowPadded = kWindow + kWindow / 32;
constexpr int kPiece = 4096;    // slots a helper expands at a time
constexpr int kPieceItems = kPiece / kRankThreads;
constexpr int kHelpers = 264;   // two blocks for each of the card's 132 SMs
constexpr unsigned int kEpochLimit = 1u << 30;

// workspace words: the ticket counter, the finished-tile counter (both
// wrap to 0 after the call's last increment), the go word (the epoch once
// every tile has finished), the piece count, then one status word a tile
constexpr int kTicket = 0;
constexpr int kDone = 1;
constexpr int kGo = 2;
constexpr int kPieces = 3;
constexpr int kStatus = 4;

// a status word: epoch << 34 | flag << 32 | value
__device__ __forceinline__ unsigned long long status_word(
    unsigned int epoch, unsigned long long flag, int value) {
  return (static_cast<unsigned long long>(epoch) << 34) | (flag << 32) |
         static_cast<unsigned int>(value);
}

__device__ __forceinline__ unsigned long long status_flag(
    unsigned long long s, unsigned int epoch) {
  return (s >> 34) == epoch ? (s >> 32) & 3 : 0;
}

// add k to an epoch-tagged counter (epoch << 32 | count; a word of another
// epoch counts 0); returns the count before.  Only heavy tiles add, once
// each: a compare-and-swap loop that many blocks ran at once would queue
// them all on one L2 line
__device__ unsigned int bump_counter(unsigned long long* word,
                                     unsigned int epoch, unsigned int k) {
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(word);
  while (true) {
    const unsigned int cnt =
        (old >> 32) == epoch ? static_cast<unsigned int>(old) : 0u;
    const unsigned long long want =
        (static_cast<unsigned long long>(epoch) << 32) | (cnt + k);
    const unsigned long long seen = atomicCAS(word, old, want);
    if (seen == old) return cnt;
    old = seen;
  }
}

// the block's min of lo and max of hi, in every thread (s_warp: 32 ints)
__device__ void block_min_max(int* lo, int* hi, int* s_warp) {
  int a = *lo;
  int b = *hi;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    a = min(a, __shfl_xor_sync(0xffffffffu, a, d));
    b = max(b, __shfl_xor_sync(0xffffffffu, b, d));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_warp[warp] = a;
    s_warp[16 + warp] = b;
  }
  __syncthreads();
  a = INT_MAX;
  b = INT_MIN;
  for (int w = 0; w < (kRankThreads >> 5); ++w) {
    a = min(a, s_warp[w]);
    b = max(b, s_warp[16 + w]);
  }
  __syncthreads();
  *lo = a;
  *hi = b;
}

// slot k of a light tile's window in shared memory, one pad word every 32:
// a thread's marks (about 16 apart) and its scan reads (32 apart) then
// fall in distinct banks
__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

// the largest local particle whose slot range starts at or before s
__device__ int owner_of(const int* s_start, int s) {
  int lo = 0;
  int hi = kRankTile;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (s_start[mid] <= s) lo = mid; else hi = mid;
  }
  return lo;
}

// one scan tile: its running max, then its slots (light) or its pieces
// (heavy); returns after the tile counts itself finished
__device__ void rank_scan_tile(const int* __restrict__ bound, int r,
                               int num_out, int cap, int tile, int tiles,
                               unsigned int epoch, unsigned long long* ws,
                               int* __restrict__ mono, int4* pieces,
                               int* __restrict__ out, int* s_warp, int* s_buf,
                               int* s_misc) {
  unsigned long long* status = ws + kStatus;
  const int base = tile * kRankTile;
  const int t0 = base + threadIdx.x * kRankItems;
  int v[kRankItems];
  const bool vec = (reinterpret_cast<uintptr_t>(bound) & 15) == 0;
  if (vec && t0 + kRankItems <= r) {
    const int4* src = reinterpret_cast<const int4*>(bound + t0);
#pragma unroll
    for (int i = 0; i < kRankItems / 4; ++i) {
      const int4 q = __ldg(src + i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRankItems; ++i) {
      v[i] = t0 + i < r ? __ldg(bound + t0 + i) : INT_MIN;
    }
  }
#pragma unroll
  for (int i = 1; i < kRankItems; ++i) v[i] = max(v[i], v[i - 1]);
  int agg;
  const int excl = block_exclusive_max(v[kRankItems - 1], s_warp, &agg);
  // decoupled look-back by one warp, 32 predecessors a round (as
  // running_max_kernel; a block-wide round of 256 was timed slower: it
  // waits for every predecessor's aggregate)
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int prefix = INT_MIN;
    if (tile == 0) {
      if (lane == 0) atomicExch(status, status_word(epoch, 2, agg));
    } else {
      if (lane == 0) atomicExch(status + tile, status_word(epoch, 1, agg));
      for (int end = tile - 1;; end -= 32) {
        const int t = end - lane;
        unsigned long long s = status_word(epoch, 2, INT_MIN);
        if (t >= 0) {
          // plain device-coherent reads: polling with atomics would queue
          // every waiting warp on the same few L2 lines
          const volatile unsigned long long* word = status + t;
          while (status_flag(s = *word, epoch) == 0) __nanosleep(64);
        }
        const unsigned int done =
            __ballot_sync(0xffffffffu, status_flag(s, epoch) == 2);
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
        atomicExch(status + tile, status_word(epoch, 2, max(prefix, agg)));
      }
    }
    if (lane == 0) s_misc[0] = prefix;
  }
  __syncthreads();
  // M of this thread's particles, and each one's slot range [lo, hi) and
  // start (the lo of a particle with no slots is where the next one's
  // begin, or INT_MAX past cap: nondecreasing, for owner_of)
  int prev = max(s_misc[0], excl);
  int lo[kRankItems];
  int hi[kRankItems];
  int tile_lo = INT_MAX;
  int tile_hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < kRankItems; ++i) {
    v[i] = max(prev, v[i]);
    const int j = t0 + i;
    const int a = prev;  // M[j - 1]; INT_MIN for j = 0
    const int b = j == r - 1 ? INT_MAX : v[i];
    if (j >= r || a > cap) {
      lo[i] = INT_MAX;
      hi[i] = INT_MAX;
    } else {
      lo[i] = max(a, 0);
      hi[i] = b > cap ? num_out : b;
      if (hi[i] > lo[i]) {
        tile_lo = min(tile_lo, lo[i]);
        tile_hi = max(tile_hi, hi[i]);
      }
    }
    prev = v[i];
  }
  block_min_max(&tile_lo, &tile_hi, s_warp);
  if (tile_lo < tile_hi && tile_hi - tile_lo <= kWindow) {
    // light: mark each particle's first slot, fill forward, store
    const int n = tile_hi - tile_lo;
    for (int k = threadIdx.x; k < kWindowPadded; k += kRankThreads) {
      s_buf[k] = -1;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRankItems; ++i) {
      if (hi[i] > lo[i] && lo[i] != INT_MAX) {
        s_buf[padded(lo[i] - tile_lo)] = threadIdx.x * kRankItems + i;
      }
    }
    __syncthreads();
    constexpr int kPer = kWindow / kRankThreads;
    int x[kPer];
    const int k0 = threadIdx.x * kPer;
#pragma unroll
    for (int q = 0; q < kPer; ++q) x[q] = s_buf[padded(k0 + q)];
#pragma unroll
    for (int q = 1; q < kPer; ++q) x[q] = max(x[q], x[q - 1]);
    int total;
    const int pre = block_exclusive_max(x[kPer - 1], s_warp, &total);
#pragma unroll
    for (int q = 0; q < kPer; ++q) s_buf[padded(k0 + q)] = max(pre, x[q]);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += kRankThreads) {
      out[tile_lo + k] = base + s_buf[padded(k)];
    }
  } else if (tile_lo < tile_hi) {
    // heavy: M to scratch, [L, H) to the piece list
    if (t0 + kRankItems <= r) {
      int4* dst = reinterpret_cast<int4*>(mono + t0);
#pragma unroll
      for (int i = 0; i < kRankItems / 4; ++i) {
        dst[i] = make_int4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRankItems; ++i) {
        if (t0 + i < r) mono[t0 + i] = v[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kRankItems; ++i) {
      s_buf[threadIdx.x * kRankItems + i] = lo[i];
    }
    const int n_pieces = (tile_hi - tile_lo + kPiece - 1) / kPiece;
    if (threadIdx.x == 0) {
      s_misc[1] = static_cast<int>(bump_counter(ws + kPieces, epoch, n_pieces));
    }
    __syncthreads();
    const int pos = s_misc[1];
    for (int p = threadIdx.x; p < n_pieces; p += kRankThreads) {
      const int s0 = tile_lo + p * kPiece;
      const int s1 = min(tile_hi, s0 + kPiece);
      pieces[pos + p] = make_int4(s0, s1, base + owner_of(s_buf, s0),
                                  base + owner_of(s_buf, s1 - 1));
    }
  }
  // the tile's slots, M and pieces are written: count it finished; the
  // last tile to finish (its increment wraps the counter to 0) lets the
  // helpers go
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int before = atomicInc(
        reinterpret_cast<unsigned int*>(ws + kDone), tiles - 1);
    if (before == static_cast<unsigned int>(tiles - 1)) {
      __threadfence();
      atomicExch(ws + kGo, static_cast<unsigned long long>(epoch));
    }
  }
}

// one helper block: wait for every tile, then expand its share of pieces
__device__ void rank_helper(int helper, int helpers,
                            unsigned int epoch, unsigned long long* ws,
                            const int* mono, const int4* pieces,
                            int* __restrict__ out, int* s_warp, int* s_idx,
                            int* s_misc) {
  if (threadIdx.x == 0) {
    const volatile unsigned long long* go = ws + kGo;
    while (*go != epoch) __nanosleep(128);
    __threadfence();
    const unsigned long long n =
        *reinterpret_cast<volatile unsigned long long*>(ws + kPieces);
    s_misc[0] = (n >> 32) == epoch ? static_cast<int>(static_cast<unsigned int>(n)) : 0;
  }
  __syncthreads();
  const int n_pieces = s_misc[0];
  for (int p = helper; p < n_pieces; p += helpers) {
    const int4 e = __ldcg(pieces + p);  // (s0, s1, first owner, last owner)
    const int m0 = e.x;
    const int n = e.y - e.x;
    if (e.z == e.w) {  // one owner: a fill
      for (int k = threadIdx.x; k < n; k += kRankThreads) out[m0 + k] = e.z;
      continue;
    }
    // as expand_kernel: particle j in (first, last] starts at slot M[j - 1]
    for (int k = threadIdx.x; k < kPiece; k += kRankThreads) s_idx[k] = INT_MIN;
    __syncthreads();
    if (threadIdx.x == 0) s_idx[0] = e.z;
    for (int j = e.z + 1 + threadIdx.x; j <= e.w; j += kRankThreads) {
      atomicMax(&s_idx[__ldcg(mono + j - 1) - m0], j);
    }
    __syncthreads();
    int x[kPieceItems];
    const int k0 = threadIdx.x * kPieceItems;
#pragma unroll
    for (int q = 0; q < kPieceItems; ++q) x[q] = s_idx[k0 + q];
#pragma unroll
    for (int q = 1; q < kPieceItems; ++q) x[q] = max(x[q], x[q - 1]);
    int total;
    const int pre = block_exclusive_max(x[kPieceItems - 1], s_warp, &total);
#pragma unroll
    for (int q = 0; q < kPieceItems; ++q) s_idx[k0 + q] = max(pre, x[q]);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += kRankThreads) out[m0 + k] = s_idx[k];
    __syncthreads();  // s_idx is reused by the next piece
  }
}

// two blocks an SM at least (at most 128 registers a thread): every tile
// of a 1M bound, and the first helpers, resident at once
__global__ void __launch_bounds__(kRankThreads, 2)
rank_kernel(const int* __restrict__ bound, int r, int num_out,
            const int* __restrict__ count, int tiles, int helpers,
            unsigned int epoch, unsigned long long* ws, int* mono,
            int4* pieces, int* __restrict__ out) {
  __shared__ int s_warp[32];
  __shared__ int s_misc[2];
  __shared__ int s_ticket;
  __shared__ int s_buf[kWindowPadded];
  if (threadIdx.x == 0) {
    s_ticket = static_cast<int>(atomicInc(
        reinterpret_cast<unsigned int*>(ws + kTicket), tiles + helpers - 1));
  }
  __syncthreads();
  const int ticket = s_ticket;
  int cap = num_out - 1;
  if (count != nullptr) cap = min(*count - 1, cap);
  if (ticket < tiles) {
    rank_scan_tile(bound, r, num_out, cap, ticket, tiles, epoch, ws, mono,
                   pieces, out, s_warp, s_buf, s_misc);
  } else {
    rank_helper(ticket - tiles, helpers, epoch, ws, mono, pieces,
                out, s_warp, s_buf, s_misc);
  }
}

int rank_tiles(int r) { return (r + kRankTile - 1) / kRankTile; }

int rank_piece_capacity(int r, int num_out) {
  return (num_out + kPiece - 1) / kPiece + rank_tiles(r);
}

}  // namespace

extern "C" int mcmh_rank_scratch_words(int r) { return scan_tiles(r) + 1; }

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
  expand_kernel<<<(num_out + kExpTile - 1) / kExpTile, kExpThreads, 0, s>>>(
      mono, r, particles, c, num_out, count, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcmh_rank_workspace_words(int r) {
  return kStatus + rank_tiles(r);
}

extern "C" int mcmh_rank_piece_capacity(int r, int num_out) {
  return rank_piece_capacity(r, num_out);
}

extern "C" unsigned int mcmh_rank_epoch_limit() { return kEpochLimit; }

// ``ws``: mcmh_rank_workspace_words(r) 64-bit words, zeroed once when
// allocated and kept across calls on one stream; ``epoch``: in
// [1, mcmh_rank_epoch_limit()), one more than the previous call's on this
// workspace; ``mono``: R ints and ``pieces``: mcmh_rank_piece_capacity
// int4s of scratch, uninitialized.
extern "C" int mcmh_rank_in_sorted(const int* bound, int r, int num_out,
                                   const int* count, unsigned int epoch,
                                   unsigned long long* ws, int* mono,
                                   int* pieces, int* out, void* stream) {
  if (num_out <= 0) return 0;
  if (r <= 0 || epoch == 0 || epoch >= kEpochLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = rank_tiles(r);
  const int helpers = std::min(kHelpers, rank_piece_capacity(r, num_out));
  rank_kernel<<<tiles + helpers, kRankThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      bound, r, num_out, count, tiles, helpers, epoch, ws, mono,
      reinterpret_cast<int4*>(pieces), out);
  return static_cast<int>(cudaGetLastError());
}
