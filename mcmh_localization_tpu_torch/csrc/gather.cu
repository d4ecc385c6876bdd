// Per-particle table lookups for the corr scorer.
//
// Replaces mcmh_localization_tpu/ops/gather_pallas.py::gather_rows_lanes
// (reached there through gather_2d / gather_3d / gather_2d_select).  The
// TPU kernel turns a random gather into one-hot MXU products over bf16
// hi/lo table planes; here a gather is one f32 load, exact.
//
//   mcmh_gather_2d:   out[i] = table[y[i], x[i]]   (indices in bounds)
//   mcmh_corr_lookup: the corr scorer's whole per-particle lookup
//     (models/corr_field.py::correlation_field_scores, the index math of
//     :466-490 and the masks and fills of :641-665) fused with the gather:
//     pose -> (theta bin, row, col) -> field value -> aggregation divide ->
//     blind / invalid fills.  Every op form copies the JAX call site in
//     f32 with explicit round-to-nearest intrinsics (no contraction), so
//     the kernel is bitwise equal to the plain PyTorch version.
//
// Bound: one dependent random 4-byte read per particle plus 12 bytes of
// pose and 4 bytes of output, so ~20 bytes of DRAM traffic per particle
// when the field is not in L2 (the 70 MB BIG field) and far less for the
// 2 MB SMALL field, which stays in L2.  One thread per particle; pose
// loads are strided by 3 floats, which the L1 line absorbs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void gather_2d_kernel(const float* __restrict__ table, int w,
                                 const int* __restrict__ y,
                                 const int* __restrict__ x, int n,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = table[static_cast<long long>(y[i]) * w + x[i]];
}

struct LookupArgs {
  int nbins, fh, fw;
  float origin_x, origin_y, inv_res, pi_f, theta_scale;
  int n_theta, kstart, use_theta_win;
  int ox0, oy0, use_window;
  int map_h, map_w;
  int sum_aggregation, score_validity;
  float blind_score, invalid_score;
};

__global__ void corr_lookup_kernel(const float* __restrict__ field,
                                   const float* __restrict__ particles, int n,
                                   const int* __restrict__ n_valid,
                                   LookupArgs a, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = particles[3LL * i];
  const float py = particles[3LL * i + 1];
  const float pth = particles[3LL * i + 2];
  // mx = ((px - origin) * inv_res).astype(int32)    corr_field.py:468-469
  const int mx = __float2int_rz(__fmul_rn(__fsub_rn(px, a.origin_x), a.inv_res));
  const int my = __float2int_rz(__fmul_rn(__fsub_rn(py, a.origin_y), a.inv_res));
  // tbin = ((pth + pi) * (n_theta / 2pi)).astype(int32) % n_theta   :470-473
  int tbin = floor_mod(
      __float2int_rz(__fmul_rn(__fadd_rn(pth, a.pi_f), a.theta_scale)),
      a.n_theta);
  bool in_theta = true;
  if (a.use_theta_win) {  // :474-477
    const int k_rel = floor_mod(tbin - a.kstart, a.n_theta);
    in_theta = k_rel < a.nbins;
    tbin = in_theta ? k_rel : 0;
  }
  const bool in_map = mx >= 0 && mx < a.map_w && my >= 0 && my < a.map_h;
  bool in_window = true;
  int mxc, myc;
  if (a.use_window) {  // :481-486
    const int mxw = mx - a.ox0;
    const int myw = my - a.oy0;
    in_window = mxw >= 0 && mxw < a.fw && myw >= 0 && myw < a.fh;
    mxc = clampi(mxw, 0, a.fw - 1);
    myc = clampi(myw, 0, a.fh - 1);
  } else {
    mxc = clampi(mx, 0, a.fw - 1);
    myc = clampi(my, 0, a.fh - 1);
  }
  const bool covered = in_window && in_theta;
  const int count = *n_valid;
  const float cnt1 = static_cast<float>(max(count, 1));
  // :642-643 gather, then zero outside map / coverage
  const float total =
      (in_map && covered)
          ? field[(static_cast<long long>(tbin) * a.fh + myc) * a.fw + mxc]
          : 0.0f;
  float score = a.sum_aggregation ? total : __fdiv_rn(total, cnt1);  // :645-648
  if (in_map && !covered) score = a.blind_score;                     // :654-655
  if (a.score_validity && !in_map) {                                 // :656-664
    score = a.sum_aggregation ? __fmul_rn(a.invalid_score, cnt1)
                              : a.invalid_score;
  }
  out[i] = count > 0 ? score : a.blind_score;                        // :665
}

}  // namespace

extern "C" int mcmh_gather_2d(const float* table, int h, int w, const int* y,
                              const int* x, int n, float* out, void* stream) {
  (void)h;
  if (n <= 0) return 0;
  gather_2d_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(table, w, y, x, n,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcmh_corr_lookup(const float* field, int nbins, int fh, int fw,
                                const float* particles, int n,
                                const int* n_valid, float origin_x,
                                float origin_y, float inv_res, float pi_f,
                                float theta_scale, int n_theta, int kstart,
                                int use_theta_win, int ox0, int oy0,
                                int use_window, int map_h, int map_w,
                                int sum_aggregation, int score_validity,
                                float blind_score, float invalid_score,
                                float* out, void* stream) {
  if (n <= 0) return 0;
  LookupArgs a;
  a.nbins = nbins;
  a.fh = fh;
  a.fw = fw;
  a.origin_x = origin_x;
  a.origin_y = origin_y;
  a.inv_res = inv_res;
  a.pi_f = pi_f;
  a.theta_scale = theta_scale;
  a.n_theta = n_theta;
  a.kstart = kstart;
  a.use_theta_win = use_theta_win;
  a.ox0 = ox0;
  a.oy0 = oy0;
  a.use_window = use_window;
  a.map_h = map_h;
  a.map_w = map_w;
  a.sum_aggregation = sum_aggregation;
  a.score_validity = score_validity;
  a.blind_score = blind_score;
  a.invalid_score = invalid_score;
  corr_lookup_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      field, particles, n, n_valid, a, out);
  return static_cast<int>(cudaGetLastError());
}
