// A scan's valid beams staged in shared memory, compacted in ascending beam
// order: the layout of the exact scorer (likelihood.cu) and of the two fused
// scan scorers (scan_scores.cu).  A block's loop over poses then runs over
// the staged beams only, with no branch on validity.
#pragma once

#include <cuda_runtime.h>

namespace mcmh {

// Stores load(j) for each beam j < m with valid[j] != 0 at s_beams[i], i
// the beam's rank among the valid beams (a warp ballot and a block prefix);
// returns the number of valid beams.  Every thread of the block (kThreads
// threads, a multiple of 32) calls it; the staged beams are visible to the
// whole block when it returns.
template <int kThreads, class T, class Load>
__device__ __forceinline__ int stage_valid_beams(
    const unsigned char* __restrict__ valid, int m, T* s_beams, Load load) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int base = 0;
  for (int j0 = 0; j0 < m; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const bool live = j < m && valid[j] != 0;
    const unsigned int mask = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int before = base;
    int total = base;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int c = s_warp[k];
      before += k < warp ? c : 0;
      total += c;
    }
    if (live) s_beams[before + __popc(mask & ((1u << lane) - 1u))] = load(j);
    base = total;
    __syncthreads();  // s_warp is rewritten by the next pass
  }
  return base;
}

}  // namespace mcmh
