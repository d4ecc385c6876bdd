// Helpers of the kernels that take a run of P consecutive particles (or
// index pairs) a thread: csrc/fused_score.cu and csrc/gather.cu.  P comes
// from the caller (ops/_cuda.py::poses_per_thread); a base that is not
// aligned for vector loads and a ragged last run are handled here, inside
// the kernels.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// floor_mod for b > 0 without the integer division where a lies in
// [-b, 2b), as every bin index of a heading in [-pi, pi] does.
__device__ __forceinline__ int wrap_mod(int a, int b) {
  if (a >= b) a -= b;
  if (a < 0) a += b;
  return (a >= 0 && a < b) ? a : floor_mod(a, b);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The poses of particles i0 .. i0 + P - 1 into p (x, y, theta each):
// 16-byte loads where P is a multiple of 4, the base is aligned and the
// run lies inside N, else one 4-byte load a value (nothing past N).
template <int P>
__device__ __forceinline__ void load_poses(const float* __restrict__ particles,
                                           long long i0, int n, bool vec,
                                           float (&p)[3 * P]) {
  if constexpr (P % 4 == 0) {
    if (vec && i0 + P <= n) {
      const float4* q = reinterpret_cast<const float4*>(particles + 3 * i0);
#pragma unroll
      for (int k = 0; k < 3 * P / 4; ++k) {
        const float4 t = __ldg(q + k);
        p[4 * k] = t.x;
        p[4 * k + 1] = t.y;
        p[4 * k + 2] = t.z;
        p[4 * k + 3] = t.w;
      }
      return;
    }
  }
  const long long end = 3LL * n - 3 * i0;
#pragma unroll
  for (int k = 0; k < 3 * P; ++k) {
    p[k] = k < end ? __ldg(particles + 3 * i0 + k) : 0.0f;
  }
}

// a[i0 .. i0 + P - 1] into v: one vector load where P is 2 or 4, the base
// is aligned to it (vec) and the run lies inside N, else one 4-byte load a
// value (0 past N).
template <int P>
__device__ __forceinline__ void load_run(const int* __restrict__ a,
                                         long long i0, int n, bool vec,
                                         int (&v)[P]) {
  if (vec && i0 + P <= n) {
    if constexpr (P == 4) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(a + i0));
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
      return;
    } else if constexpr (P == 2) {
      const int2 t = __ldg(reinterpret_cast<const int2*>(a + i0));
      v[0] = t.x;
      v[1] = t.y;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = i0 + k < n ? __ldg(a + i0 + k) : 0;
}

// out[i0 .. i0 + P - 1] = v, one vector store where the run is whole (the
// output is the wrapper's allocation: aligned).
template <int P>
__device__ __forceinline__ void store_run(float* __restrict__ out,
                                          long long i0, int n,
                                          const float (&v)[P]) {
  if (i0 + P <= n) {
    if constexpr (P % 4 == 0) {
#pragma unroll
      for (int k = 0; k < P; k += 4) {
        *reinterpret_cast<float4*>(out + i0 + k) =
            make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      }
      return;
    } else if constexpr (P == 2) {
      *reinterpret_cast<float2*>(out + i0) = make_float2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (i0 + k < n) out[i0 + k] = v[k];
  }
}

inline bool aligned_to(const void* ptr, unsigned long long bytes) {
  return (reinterpret_cast<unsigned long long>(ptr) % bytes) == 0;
}

// blocks of `threads` threads for n items at p a thread
inline int blocks_for(int n, int p, int threads) {
  const long long per = (static_cast<long long>(n) + p - 1) / p;
  return static_cast<int>((per + threads - 1) / threads);
}

}  // namespace
