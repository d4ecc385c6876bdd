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
// Bound: one dependent 4-byte read per particle from the two tables (2 MB
// fine + 1.3 MB coarse at the single-program flagship's shapes), which stay
// in L2, plus 12 bytes of pose in and 4 bytes out: ~16 bytes of DRAM
// traffic per particle.  One thread per particle.  mcmh_window_escapees
// counts the in-map particles the window does not cover (the coarse-build
// gate) with one atomic add per block.

#include <cuda_runtime.h>

// Passed by value from ctypes (ops/fused_score.py::WindowArgs): 4-byte
// fields only, in this order.
struct WindowArgs {
  float origin_x, origin_y, fine_scale, theta_scale, pi_f, res_c, kc_scale;
  float blind_score;
  int n_theta, nbins, kstart, fh, fw, h, w, ox0, oy0, kc, hc, wc;
  int fine_div, theta_div, clip_before_window;
};

namespace {

constexpr int kThreads = 256;

struct WindowIndex {
  int row, lane;
  bool covered, in_map;
};

__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ WindowIndex window_index(const float* particles,
                                                    int i,
                                                    const WindowArgs& a) {
  const float px = particles[3LL * i];
  const float py = particles[3LL * i + 1];
  const float pth = particles[3LL * i + 2];
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
  const int tbin = floor_mod(__float2int_rz(tb), a.n_theta);
  const int k_rel = floor_mod(tbin - a.kstart, a.n_theta);
  const bool in_theta = k_rel < a.nbins;
  const int tbin_w = in_theta ? k_rel : 0;

  WindowIndex r;
  r.in_map = mx >= 0 && mx < a.w && my >= 0 && my < a.h;
  const int mxw = (a.clip_before_window ? clampi(mx, 0, a.w - 1) : mx) - a.ox0;
  const int myw = (a.clip_before_window ? clampi(my, 0, a.h - 1) : my) - a.oy0;
  r.covered = in_theta && mxw >= 0 && mxw < a.fw && myw >= 0 && myw < a.fh;
  if (r.covered) {
    r.row = clampi(myw, 0, a.fh - 1) * a.nbins + tbin_w;
    r.lane = clampi(mxw, 0, a.fw - 1);
  } else {
    const int cx = clampi(__float2int_rz(__fdiv_rn(dx, a.res_c)), 0, a.wc - 1);
    const int cy = clampi(__float2int_rz(__fdiv_rn(dy, a.res_c)), 0, a.hc - 1);
    const int ck =
        floor_mod(__float2int_rz(__fmul_rn(tpi, a.kc_scale)), a.kc);
    r.row = cy * a.kc + ck;
    r.lane = cx;
  }
  return r;
}

__global__ void window_score_kernel(const float* __restrict__ fine,
                                    const float* __restrict__ coarse,
                                    const float* __restrict__ particles, int n,
                                    const float* __restrict__ denom_fill,
                                    const int* __restrict__ count,
                                    WindowArgs a, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (count != nullptr && *count <= 0) {
    out[i] = a.blind_score;
    return;
  }
  const WindowIndex r = window_index(particles, i, a);
  const float v =
      r.covered ? __ldg(fine + static_cast<long long>(r.row) * a.fw + r.lane)
                : __ldg(coarse + static_cast<long long>(r.row) * a.wc + r.lane);
  out[i] = r.in_map ? __fdiv_rn(v, denom_fill[0]) : denom_fill[1];
}

__global__ void window_escapees_kernel(const float* __restrict__ particles,
                                       int n, WindowArgs a,
                                       int* __restrict__ n_escaped) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool escaped = false;
  if (i < n) {
    const WindowIndex r = window_index(particles, i, a);
    escaped = r.in_map && !r.covered;
  }
  const int block_count = __syncthreads_count(escaped);
  if (threadIdx.x == 0 && block_count > 0) atomicAdd(n_escaped, block_count);
}

}  // namespace

extern "C" int mcmh_window_score(const float* fine, const float* coarse,
                                 const float* particles, int n,
                                 const float* denom_fill, const int* count,
                                 WindowArgs a, float* out, void* stream) {
  if (n <= 0) return 0;
  window_score_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      fine, coarse, particles, n, denom_fill, count, a, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcmh_window_escapees(const float* particles, int n,
                                    WindowArgs a, int* n_escaped,
                                    void* stream) {
  if (n <= 0) return 0;
  window_escapees_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      particles, n, a, n_escaped);
  return static_cast<int>(cudaGetLastError());
}
