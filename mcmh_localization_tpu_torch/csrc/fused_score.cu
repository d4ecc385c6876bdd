// Windowed field score with the coarse out-of-window fallback.
//
// Replaces mcmh_localization_tpu/ops/fused_score_pallas.py::
// fused_window_score_gather, the lookup of the single-program windowed corr
// scorer (models/corr_field.py, the corr_coarse_factor > 0 path) and of the
// beam score field.  Per particle (px, py, pth):
//
//   mx, my  = i32((p - origin) OP fine_scale)     OP: * (corr) or / (beam)
//   tbin    = i32((pth + pi) THOP theta_scale) mod n_theta
//   k_rel   = (tbin - kstart) mod n_theta; in_theta = k_rel < nbins
//   covered = in the (fh, fw) window at (oy0, ox0) and in_theta
//   value   = covered ? fine[clip(myw) * nbins + k_rel, clip(mxw)]
//                     : coarse[cy * kc + ck, cx]
//   out     = count > 0 ? (in_map ? value / denom : fill) : blind
//
// with the coarse cell (cx, cy) = i32((p - origin) / res_c) clipped and
// ck = i32((pth + pi) * kc_scale) mod kc.  Both tables are theta-minor (row
// = y * bins + k), as the TPU kernel takes them.  The TPU kernel's one-hot
// MXU reads over bf16 hi/lo planes and its chunk windows are TPU mechanics:
// here the read is one exact f32 load, and every op form copies the JAX
// call site in f32 with round-to-nearest intrinsics (built with
// --fmad=false), so the kernel is bitwise equal to the plain version.
//
// Bound: 12 bytes of pose in and 4 bytes out per particle from DRAM, and
// one 4-byte read from the two tables (2 MB fine + 1.3 MB coarse at the
// single-program flagship's shapes), which stay in L2: 0.0106 ms at 2 x 1M
// particles on an H100 SXM at 700 W.  The first kernel took one particle a
// thread behind a chain of dependent round trips (the count, then the
// pose, then the table, then the denominator, then the store) with 12
// bytes in flight a thread, and its wrapper launched two more kernels a
// call to stack the denominator and the fill.
// The layout:
//  - each thread takes P consecutive particles, P from N by the caller
//    (ops/_cuda.py::poses_per_thread): 4 where N still gives the
//    card about a wave of threads (the 48 bytes of four poses are three
//    16-byte loads, issued together, then the four table reads, then one
//    16-byte store), else 2 or 1, so a cloud of 2 x 100k still spreads
//    over the card;
//  - the count, denominator and fill are read once a thread after the pose
//    loads were issued, or come by value; the blind case is a select at
//    the end;
//  - the bin indices wrap without an integer division (wrap_mod);
//  - a pose array whose base is not 16-byte aligned (a view such as
//    parts[1:]) takes the same kernel with 4-byte pose loads, and the last
//    thread of a ragged N reads and writes its 1-3 particles one by one;
//    the output is the wrapper's own allocation and always aligned.
// mcmh_window_escapees_at counts the in-map particles the window does not
// cover (the coarse-build gate) in the same layout, with one atomic add
// per block.
// Both entries read the window's (oy0, ox0) corner and its first theta bin
// kstart (0 without a theta window) from three ints in device memory (the
// step's origin, which filter/step.py::window_origin_at computes and
// clamps on the card): each thread loads the 12 bytes once, behind its
// early return, through the read-only cache, so a block's threads share
// one line.
// Tried and dropped (chip_kernel_ab.py, the kernels alone at 2 x 1M, in
// turns, NVIDIA H100 80GB HBM3 at 700 W): the first kernel's one particle a
// thread, 0.0181-0.0183 ms (0.0225-0.0232 as its wrapper called it) where
// this layout takes 0.0165-0.0166 (0.0164-0.0167 through its wrapper);
// P = 4 at 2 x 100k, 0.0061-0.0062 where P = 1 takes 0.0041-0.0043 (the
// P argument; the rest were edited copies of this file, timed the same
// way): 8 particles a thread, 0.0205 (one wave: the loads, the index math
// and the stores of all threads no longer overlap); a grid-stride loop
// over the card's resident blocks that loads the next run's poses before
// it scores the current one, 0.0164-0.0165 (the escapee count 0.0115
// against 0.0106); at most 32 registers a thread for 8 blocks an SM,
// 0.0182; evict-first pose loads and score stores (__ldcs, __stcs), 0.0158
// alone but 0.0172-0.0174 against 0.0165-0.0168 through the wrapper in
// chip_smoke.py, in turns, and the escapee count 0.0138 against
// 0.0109-0.0110 there.

#include <cuda_runtime.h>

#include "thread_runs.cuh"

// Passed by value from ctypes (ops/_cuda.py::WindowArgs): 4-byte
// fields only, in this order.
struct WindowArgs {
  float origin_x, origin_y, fine_scale, theta_scale, pi_f, res_c, kc_scale;
  float blind_score;
  int n_theta, nbins, fh, fw, h, w, kc, hc, wc;
  int fine_div, theta_div, clip_before_window;
};

namespace {

constexpr int kThreads = 256;

struct WindowIndex {
  int row, lane;
  bool covered, in_map;
};

// The window's (oy0, ox0) corner and first theta bin, read from the three
// ints of the device-held origin.
struct Origin {
  int oy0, ox0, kstart;
};

__device__ __forceinline__ Origin read_origin(const int* __restrict__ origin) {
  return {__ldg(origin), __ldg(origin + 1), __ldg(origin + 2)};
}

__device__ __forceinline__ WindowIndex window_index(float px, float py,
                                                    float pth,
                                                    const WindowArgs& a,
                                                    const Origin& o) {
  const float dx = __fsub_rn(px, a.origin_x);
  const float dy = __fsub_rn(py, a.origin_y);
  const float fx = a.fine_div ? __fdiv_rn(dx, a.fine_scale)
                              : __fmul_rn(dx, a.fine_scale);
  const float fy = a.fine_div ? __fdiv_rn(dy, a.fine_scale)
                              : __fmul_rn(dy, a.fine_scale);
  const int mx = __float2int_rz(fx);
  const int my = __float2int_rz(fy);
  const float tpi = __fadd_rn(pth, a.pi_f);
  const float tb = a.theta_div ? __fdiv_rn(tpi, a.theta_scale)
                               : __fmul_rn(tpi, a.theta_scale);
  const int tbin = wrap_mod(__float2int_rz(tb), a.n_theta);
  const int k_rel = wrap_mod(tbin - o.kstart, a.n_theta);
  const bool in_theta = k_rel < a.nbins;
  const int tbin_w = in_theta ? k_rel : 0;

  WindowIndex r;
  r.in_map = mx >= 0 && mx < a.w && my >= 0 && my < a.h;
  const int mxw = (a.clip_before_window ? clampi(mx, 0, a.w - 1) : mx) - o.ox0;
  const int myw = (a.clip_before_window ? clampi(my, 0, a.h - 1) : my) - o.oy0;
  r.covered = in_theta && mxw >= 0 && mxw < a.fw && myw >= 0 && myw < a.fh;
  if (r.covered) {
    r.row = clampi(myw, 0, a.fh - 1) * a.nbins + tbin_w;
    r.lane = clampi(mxw, 0, a.fw - 1);
  } else {
    const int cx = clampi(__float2int_rz(__fdiv_rn(dx, a.res_c)), 0, a.wc - 1);
    const int cy = clampi(__float2int_rz(__fdiv_rn(dy, a.res_c)), 0, a.hc - 1);
    const int ck = wrap_mod(__float2int_rz(__fmul_rn(tpi, a.kc_scale)), a.kc);
    r.row = cy * a.kc + ck;
    r.lane = cx;
  }
  return r;
}

template <int P>
__global__ void __launch_bounds__(kThreads) window_score_kernel(
    const float* __restrict__ fine, const float* __restrict__ coarse,
    const float* __restrict__ particles, int n, bool vec,
    const float* __restrict__ denom_ptr, float denom,
    const float* __restrict__ fill_ptr, float fill,
    const int* __restrict__ count, const int* __restrict__ origin,
    WindowArgs a, float* __restrict__ out) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * P;
  if (i0 >= n) return;
  const Origin o = read_origin(origin);
  float p[3 * P];
  load_poses<P>(particles, i0, n, vec, p);
  const bool seen = count == nullptr || __ldg(count) > 0;
  if (denom_ptr != nullptr) denom = __ldg(denom_ptr);
  if (fill_ptr != nullptr) fill = __ldg(fill_ptr);
  const float* src[P];
  bool in_map[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const WindowIndex r =
        window_index(p[3 * k], p[3 * k + 1], p[3 * k + 2], a, o);
    src[k] = r.covered ? fine + static_cast<long long>(r.row) * a.fw + r.lane
                       : coarse + static_cast<long long>(r.row) * a.wc + r.lane;
    in_map[k] = r.in_map;
  }
  float v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = __ldg(src[k]);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    v[k] = seen ? (in_map[k] ? __fdiv_rn(v[k], denom) : fill) : a.blind_score;
  }
  store_run<P>(out, i0, n, v);
}

template <int P>
__global__ void __launch_bounds__(kThreads) window_escapees_kernel(
    const float* __restrict__ particles, int n, bool vec,
    const int* __restrict__ origin, WindowArgs a,
    int* __restrict__ n_escaped) {
  __shared__ int s_warp[kThreads / 32];
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * P;
  int escaped = 0;
  if (i0 < n) {
    const Origin o = read_origin(origin);
    float p[3 * P];
    load_poses<P>(particles, i0, n, vec, p);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const WindowIndex r =
          window_index(p[3 * k], p[3 * k + 1], p[3 * k + 2], a, o);
      escaped += (i0 + k < n && r.in_map && !r.covered) ? 1 : 0;
    }
  }
  escaped = __reduce_add_sync(0xffffffffu, escaped);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = escaped;
  __syncthreads();
  if (threadIdx.x == 0) {
    int block_count = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) block_count += s_warp[k];
    if (block_count > 0) atomicAdd(n_escaped, block_count);
  }
}

template <int P>
cudaError_t launch_score(const float* fine, const float* coarse,
                         const float* particles, int n,
                         const float* denom_ptr, float denom,
                         const float* fill_ptr, float fill, const int* count,
                         const int* origin, const WindowArgs& a, float* out,
                         cudaStream_t stream) {
  const int blocks = blocks_for(n, P, kThreads);
  window_score_kernel<P><<<blocks, kThreads, 0, stream>>>(
      fine, coarse, particles, n, aligned_to(particles, 16), denom_ptr, denom,
      fill_ptr, fill, count, origin, a, out);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_escapees(const float* particles, int n, const int* origin,
                            const WindowArgs& a, int* n_escaped,
                            cudaStream_t stream) {
  const int blocks = blocks_for(n, P, kThreads);
  window_escapees_kernel<P><<<blocks, kThreads, 0, stream>>>(
      particles, n, aligned_to(particles, 16), origin, a, n_escaped);
  return cudaGetLastError();
}

int score(const float* fine, const float* coarse, const float* particles,
          int n, const float* denom_ptr, float denom, const float* fill_ptr,
          float fill, const int* count, const int* origin, const WindowArgs& a,
          int poses, float* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (poses) {
    case 4:
      return launch_score<4>(fine, coarse, particles, n, denom_ptr, denom,
                             fill_ptr, fill, count, origin, a, out, st);
    case 2:
      return launch_score<2>(fine, coarse, particles, n, denom_ptr, denom,
                             fill_ptr, fill, count, origin, a, out, st);
    case 1:
      return launch_score<1>(fine, coarse, particles, n, denom_ptr, denom,
                             fill_ptr, fill, count, origin, a, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int escapees(const float* particles, int n, const int* origin,
             const WindowArgs& a, int poses, int* n_escaped, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (poses) {
    case 4:
      return launch_escapees<4>(particles, n, origin, a, n_escaped, st);
    case 2:
      return launch_escapees<2>(particles, n, origin, a, n_escaped, st);
    case 1:
      return launch_escapees<1>(particles, n, origin, a, n_escaped, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// denom and fill: read from the device where the pointer is not null,
// else the value given; count may be null (no blind case).  origin: the
// three ints (oy0, ox0, kstart) in device memory.  poses: the particles a
// thread, 1, 2 or 4 (ops/_cuda.py::poses_per_thread).
extern "C" int mcmh_window_score_at(const float* fine, const float* coarse,
                                    const float* particles, int n,
                                    const float* denom_ptr, float denom,
                                    const float* fill_ptr, float fill,
                                    const int* count, const int* origin,
                                    WindowArgs a, int poses, float* out,
                                    void* stream) {
  if (origin == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return score(fine, coarse, particles, n, denom_ptr, denom, fill_ptr, fill,
               count, origin, a, poses, out, stream);
}

extern "C" int mcmh_window_escapees_at(const float* particles, int n,
                                       const int* origin, WindowArgs a,
                                       int poses, int* n_escaped,
                                       void* stream) {
  if (origin == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return escapees(particles, n, origin, a, poses, n_escaped, stream);
}
