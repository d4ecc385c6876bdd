// Per-particle table lookups for the corr scorer.
//
// Replaces mcmh_localization_tpu/ops/gather_pallas.py::gather_rows_lanes
// (reached there through gather_2d / gather_3d / gather_2d_select).  The
// TPU kernel turns a random gather into one-hot MXU products over bf16
// hi/lo table planes; here a gather is one f32 load, exact.
//
//   mcmh_gather_2d:      out[i] = table[y[i], x[i]]   (indices in bounds)
//   mcmh_corr_lookup_at: the corr scorer's whole per-particle lookup
//     (models/corr_field.py::correlation_field_scores, the index math of
//     :466-490 and the masks and fills of :641-665) fused with the gather:
//     pose -> (theta bin, row, col) -> field value -> aggregation divide ->
//     blind / invalid fills.  Every op form copies the JAX call site in
//     f32 with explicit round-to-nearest intrinsics (no contraction), so
//     the kernel is bitwise equal to the plain PyTorch version.
//
// Bound: one dependent random 4-byte read per item plus its 12 bytes of
// pose (8 of index pair) and 4 bytes of output from DRAM; the tables read
// (the 2 MB SMALL field, the 384^2 free mask) stay in L2, the 70 MB BIG
// field does not.  At the staged SMALL program's 2 x 130 048 poses the
// whole call is a few microseconds, so what counts is the chain each thread
// waits on and how many reads are in flight.  The first kernel took one
// item a thread: three strided 4-byte pose loads (or two index loads),
// then the valid-beam count, then the table read, in turn.  The layout now
// (the one of csrc/fused_score.cu):
//  - each thread takes P consecutive items, P from N by the caller
//    (ops/_cuda.py::poses_per_thread): 4 where N still gives the card about
//    a wave of threads (the 48 bytes of four poses are three 16-byte loads,
//    four index pairs two, issued together; then the four table reads; then
//    one 16-byte store), else 2 or 1;
//  - the valid-beam count is read before the pose loads are issued;
//  - the theta bins wrap without an integer division (wrap_mod);
//  - a base that is not aligned for the vector loads (a view such as
//    parts[1:]) takes the same kernel with 4-byte loads, and the last
//    thread of a ragged N reads and writes its items one by one; the output
//    is the wrapper's own allocation and always aligned.
// mcmh_corr_lookup_at reads the window's (oy0, ox0) corner and its first
// theta bin from three ints in device memory (filter/step.py::
// window_origin_at computes them on the card), loaded with the valid-beam
// count before the poses; the full-map lookup has neither window and
// passes no origin.

#include <cuda_runtime.h>

#include "thread_runs.cuh"

namespace {

constexpr int kThreads = 256;

template <int P>
__global__ void __launch_bounds__(kThreads) gather_2d_kernel(
    const float* __restrict__ table, int w, const int* __restrict__ y,
    const int* __restrict__ x, int n, bool vec, float* __restrict__ out) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * P;
  if (i0 >= n) return;
  int yy[P], xx[P];
  load_run<P>(y, i0, n, vec, yy);
  load_run<P>(x, i0, n, vec, xx);
  float v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    v[k] = __ldg(table + static_cast<long long>(yy[k]) * w + xx[k]);
  }
  store_run<P>(out, i0, n, v);
}

struct LookupArgs {
  int nbins, fh, fw;
  float origin_x, origin_y, inv_res, pi_f, theta_scale;
  int n_theta, use_theta_win, use_window;
  int map_h, map_w;
  int sum_aggregation, score_validity;
  float blind_score, invalid_score;
};

template <int P>
__global__ void __launch_bounds__(kThreads) corr_lookup_kernel(
    const float* __restrict__ field, const float* __restrict__ particles,
    int n, bool vec, const int* __restrict__ n_valid,
    const int* __restrict__ origin, LookupArgs a, float* __restrict__ out) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * P;
  if (i0 >= n) return;
  const int count = __ldg(n_valid);
  int oy0 = 0, ox0 = 0, kstart = 0;
  if (origin != nullptr) {  // (oy0, ox0, kstart) on the card
    oy0 = __ldg(origin);
    ox0 = __ldg(origin + 1);
    kstart = __ldg(origin + 2);
  }
  float p[3 * P];
  load_poses<P>(particles, i0, n, vec, p);
  long long src[P];
  bool in_map[P], covered[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float px = p[3 * k], py = p[3 * k + 1], pth = p[3 * k + 2];
    // mx = ((px - origin) * inv_res).astype(int32)    corr_field.py:468-469
    const int mx =
        __float2int_rz(__fmul_rn(__fsub_rn(px, a.origin_x), a.inv_res));
    const int my =
        __float2int_rz(__fmul_rn(__fsub_rn(py, a.origin_y), a.inv_res));
    // tbin = ((pth + pi) * (n_theta / 2pi)).astype(int32) % n_theta :470-473
    int tbin = wrap_mod(
        __float2int_rz(__fmul_rn(__fadd_rn(pth, a.pi_f), a.theta_scale)),
        a.n_theta);
    bool in_theta = true;
    if (a.use_theta_win) {  // :474-477
      const int k_rel = wrap_mod(tbin - kstart, a.n_theta);
      in_theta = k_rel < a.nbins;
      tbin = in_theta ? k_rel : 0;
    }
    in_map[k] = mx >= 0 && mx < a.map_w && my >= 0 && my < a.map_h;
    bool in_window = true;
    int mxc, myc;
    if (a.use_window) {  // :481-486
      const int mxw = mx - ox0;
      const int myw = my - oy0;
      in_window = mxw >= 0 && mxw < a.fw && myw >= 0 && myw < a.fh;
      mxc = clampi(mxw, 0, a.fw - 1);
      myc = clampi(myw, 0, a.fh - 1);
    } else {
      mxc = clampi(mx, 0, a.fw - 1);
      myc = clampi(my, 0, a.fh - 1);
    }
    covered[k] = in_window && in_theta;
    src[k] = (in_map[k] && covered[k])
                 ? (static_cast<long long>(tbin) * a.fh + myc) * a.fw + mxc
                 : -1;
  }
  const float cnt1 = static_cast<float>(max(count, 1));
  float v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {  // :642-643 gather, zero outside map / coverage
    v[k] = src[k] >= 0 ? __ldg(field + src[k]) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float score = a.sum_aggregation ? v[k] : __fdiv_rn(v[k], cnt1);  // :645-648
    if (in_map[k] && !covered[k]) score = a.blind_score;             // :654-655
    if (a.score_validity && !in_map[k]) {                            // :656-664
      score = a.sum_aggregation ? __fmul_rn(a.invalid_score, cnt1)
                                : a.invalid_score;
    }
    v[k] = count > 0 ? score : a.blind_score;                        // :665
  }
  store_run<P>(out, i0, n, v);
}

template <int P>
cudaError_t launch_gather(const float* table, int w, const int* y,
                          const int* x, int n, float* out,
                          cudaStream_t stream) {
  const bool vec = aligned_to(y, 4 * P) && aligned_to(x, 4 * P);
  gather_2d_kernel<P><<<blocks_for(n, P, kThreads), kThreads, 0, stream>>>(
      table, w, y, x, n, vec, out);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_lookup(const float* field, const float* particles, int n,
                          const int* n_valid, const int* origin,
                          const LookupArgs& a, float* out,
                          cudaStream_t stream) {
  corr_lookup_kernel<P><<<blocks_for(n, P, kThreads), kThreads, 0, stream>>>(
      field, particles, n, aligned_to(particles, 16), n_valid, origin, a,
      out);
  return cudaGetLastError();
}

int lookup(const float* field, const float* particles, int n,
           const int* n_valid, const int* origin, const LookupArgs& a,
           int poses, float* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (poses) {
    case 4:
      return launch_lookup<4>(field, particles, n, n_valid, origin, a, out,
                              st);
    case 2:
      return launch_lookup<2>(field, particles, n, n_valid, origin, a, out,
                              st);
    case 1:
      return launch_lookup<1>(field, particles, n, n_valid, origin, a, out,
                              st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// items: the index pairs a thread, 1, 2 or 4 (ops/_cuda.py::poses_per_thread)
extern "C" int mcmh_gather_2d(const float* table, int h, int w, const int* y,
                              const int* x, int n, int items, float* out,
                              void* stream) {
  (void)h;
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (items) {
    case 4:
      return launch_gather<4>(table, w, y, x, n, out, st);
    case 2:
      return launch_gather<2>(table, w, y, x, n, out, st);
    case 1:
      return launch_gather<1>(table, w, y, x, n, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// origin: (oy0, ox0, kstart), three ints in device memory, read where
// use_window / use_theta_win ask for them (null when neither does).
// poses: the particles a thread, 1, 2 or 4 (ops/_cuda.py::poses_per_thread)
extern "C" int mcmh_corr_lookup_at(const float* field, int nbins, int fh,
                                   int fw, const float* particles, int n,
                                   const int* n_valid, float origin_x,
                                   float origin_y, float inv_res, float pi_f,
                                   float theta_scale, int n_theta,
                                   int use_theta_win, int use_window,
                                   const int* origin, int map_h, int map_w,
                                   int sum_aggregation, int score_validity,
                                   float blind_score, float invalid_score,
                                   int poses, float* out, void* stream) {
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
  a.use_theta_win = use_theta_win;
  a.use_window = use_window;
  a.map_h = map_h;
  a.map_w = map_w;
  a.sum_aggregation = sum_aggregation;
  a.score_validity = score_validity;
  a.blind_score = blind_score;
  a.invalid_score = invalid_score;
  return lookup(field, particles, n, n_valid,
                use_window || use_theta_win ? origin : nullptr, a, poses, out,
                stream);
}
