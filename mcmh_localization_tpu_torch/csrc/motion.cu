// One odometry message's motion step (filter/step.py::_predict and, on a
// correct step's buffers, filter/captured.py::predict_in_place): the
// delta between the message's two poses (models/motion.py::
// compute_motion), its three noise scales (_noise_stds), the proposal of
// every slot (sample_motion: the raw draw, or under "reject" the first of
// R candidates on a free cell, else the old pose), and the anchor
// advanced by the delta (advance_anchor).  The normals are
// torch's: the wrapper draws them with torch.randn from the state's
// generator, at the same place in the stream as the plain chain, and this
// kernel draws nothing.
//
// Replaces no Pallas kernel: the JAX package leaves the motion model to
// XLA (mcmh_localization_tpu/models/motion.py, filter/step.py:80-111).
// Under "reject" it reads the free mask inline (grid_map.py::
// is_free_world: world_to_grid's truncating divide, in_bounds, > 0.5),
// the read gather_2d (kernel 2's counterpart) made on this path.  In
// PyTorch a message was 59 launches and 4 copies, 83 and 4 under
// "reject" with 4 retries; here it is one launch after torch's draw.
//
// Bound: the bytes, each input read once and each output written once:
// the set and its noise (24 B a slot, 12 more a candidate under
// "reject"), the proposal (12) and, in place, the set kept as the
// previous one (12): 48 B a slot in place, 36 B into a new tensor (48 MB
// at 1M slots, 14.3 us at 3.35 TB/s).  The message's own work (six
// floats in, about 40 flops) is done by every thread again, so no launch
// and no grid-wide step is spent on it; thread 0 alone writes the delta
// and the anchor.  Each thread takes four consecutive slots: the 48 bytes
// of an (n, 3) set are three 16-byte loads, so a warp's loads cover 1536
// contiguous bytes and share their sectors; a base not aligned for them,
// and the last slots of an n that is not a multiple of 4, take 4-byte
// loads.  Nothing runs past n.  Under "reject" a thread reads the next
// candidate's noise only while one of its slots has found no free cell.
//
// The arithmetic follows the plain PyTorch chain operation by operation,
// with explicit round-to-nearest intrinsics (no contraction), atan2f,
// hypotf, cosf, sinf and torch's floor-mod for normalize_angle, so the
// kernel is bitwise equal to it on the card and a "reject" decision
// cannot flip at a cell edge.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;   // slots a thread: three 16-byte loads of a set

// f32(math.pi) and f32(2 * math.pi), as PyTorch rounds the python scalars
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

}  // namespace

// ops/_cuda.py::MotionArgs, passed by value
struct MotionArgs {
  const float* noise;      // (n, 3) normals, or (retries, n, 3)
  const float* particles;  // (n, 3) the set before the message
  const float* poses;      // (2, 3) the previous and current pose, or null
  const float* delta;      // (3) rot1, trans, rot2, where poses is null
  const float* anchor;     // (3)
  const float* free_mask;  // (h, w) 0/1 under "reject"
  float* proposed;         // (n, 3): the set itself in place; may be
                           // the noise, each row read before it is written
  float* prev_out;         // (n, 3) the set copied, or null
  float* delta_out;        // (3) or null
  float* anchor_out;       // (3); the anchor itself in place
  int n, retries, h, w;
  float a1, a2, a3, a4, origin_x, origin_y, res;
};

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// torch.remainder on floats: fmod, moved onto the divisor's sign
__device__ __forceinline__ float remainder_f(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m = add(m, b);
  return m;
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15ULL) == 0;
}

// utils/angles.py::normalize_angle
__device__ __forceinline__ float wrap(float t) {
  return sub(remainder_f(add(t, kPi), kTwoPi), kPi);
}

// the message's delta and its noise scales
struct Message {
  float d[3], s[3];
};

__device__ Message message(const MotionArgs& a) {
  Message m;
  if (a.poses != nullptr) {   // models/motion.py::compute_motion
    const float* p = a.poses;
    const float dx = sub(p[3], p[0]), dy = sub(p[4], p[1]);
    const float dtheta = wrap(sub(p[5], p[2]));
    m.d[0] = sub(atan2f(dy, dx), p[2]);
    m.d[1] = hypotf(dx, dy);
    m.d[2] = sub(dtheta, m.d[0]);
  } else {
    m.d[0] = a.delta[0];
    m.d[1] = a.delta[1];
    m.d[2] = a.delta[2];
  }
  // models/motion.py::_noise_stds
  const float r1 = fabsf(m.d[0]), t = fabsf(m.d[1]), r2 = fabsf(m.d[2]);
  m.s[0] = add(mul(a.a1, r1), mul(a.a2, t));
  m.s[1] = add(mul(a.a3, t), mul(a.a4, add(r1, r2)));
  m.s[2] = add(mul(a.a1, r2), mul(a.a2, t));
  return m;
}

// one slot's draw through the odometry model (sample_motion)
__device__ __forceinline__ void propose(const float* p, const float* z,
                                        const Message& m, float* q) {
  const float r1 = add(m.d[0], mul(z[0], m.s[0]));
  const float t = add(m.d[1], mul(z[1], m.s[1]));
  const float r2 = add(m.d[2], mul(z[2], m.s[2]));
  const float heading = add(p[2], r1);
  q[0] = add(p[0], mul(t, cosf(heading)));
  q[1] = add(p[1], mul(t, sinf(heading)));
  q[2] = wrap(add(heading, r2));
}

// maps/grid_map.py::is_free_world of one pose
__device__ __forceinline__ bool is_free(const float* q, const MotionArgs& a) {
  const int mx = static_cast<int>(__fdiv_rn(sub(q[0], a.origin_x), a.res));
  const int my = static_cast<int>(__fdiv_rn(sub(q[1], a.origin_y), a.res));
  if (mx < 0 || mx >= a.w || my < 0 || my >= a.h) return false;
  return a.free_mask[my * a.w + mx] > 0.5f;
}

// the rows i0 .. i0 + rows - 1 of an (n, 3) set: three 16-byte loads
// where the run is whole and aligned, else one 4-byte load a value.  Plain
// loads: in place, the set is written by the same kernel.
__device__ __forceinline__ void load_rows(const float* src, int rows,
                                          float (&v)[3 * kRows]) {
  if (rows == kRows && aligned16(src)) {
    const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 t = s[k];
      v[4 * k] = t.x;
      v[4 * k + 1] = t.y;
      v[4 * k + 2] = t.z;
      v[4 * k + 3] = t.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 3 * kRows; ++k) v[k] = k < 3 * rows ? src[k] : 0.f;
}

__device__ __forceinline__ void store_rows(float* dst, int rows,
                                           const float (&v)[3 * kRows]) {
  if (rows == kRows && aligned16(dst)) {
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 3 * kRows; ++k) {
    if (k < 3 * rows) dst[k] = v[k];
  }
}

// kReject: R = a.retries candidates checked on the free mask
template <bool kReject>
__global__ void __launch_bounds__(kThreads) motion_kernel(MotionArgs a) {
  const Message m = message(a);
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g == 0) {
    if (a.delta_out != nullptr) {
      for (int k = 0; k < 3; ++k) a.delta_out[k] = m.d[k];
    }
    // models/motion.py::advance_anchor: read whole before the write, which
    // in place lands on the same three floats
    const float ax = a.anchor[0], ay = a.anchor[1], ath = a.anchor[2];
    const float th1 = add(ath, m.d[0]);
    const float x = add(ax, mul(m.d[1], cosf(th1)));
    const float y = add(ay, mul(m.d[1], sinf(th1)));
    a.anchor_out[0] = x;
    a.anchor_out[1] = y;
    a.anchor_out[2] = wrap(add(th1, m.d[2]));
  }
  const long long i0 = g * kRows;
  if (i0 >= a.n) return;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), a.n - i0));
  float p[3 * kRows], z[3 * kRows], q[3 * kRows];
  load_rows(a.particles + 3 * i0, rows, p);
  if constexpr (!kReject) {
    load_rows(a.noise + 3 * i0, rows, z);
#pragma unroll
    for (int k = 0; k < kRows; ++k) propose(p + 3 * k, z + 3 * k, m, q + 3 * k);
  } else {
    // the old pose where no candidate is free
#pragma unroll
    for (int k = 0; k < 3 * kRows; ++k) q[k] = p[k];
    int open = (1 << rows) - 1;   // the slots still without a free cell
    for (int r = 0; r < a.retries && open != 0; ++r) {
      load_rows(a.noise + 3 * (static_cast<long long>(r) * a.n + i0), rows, z);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!(open & (1 << k))) continue;
        float c[3];
        propose(p + 3 * k, z + 3 * k, m, c);
        if (is_free(c, a)) {
          q[3 * k] = c[0];
          q[3 * k + 1] = c[1];
          q[3 * k + 2] = c[2];
          open &= ~(1 << k);
        }
      }
    }
  }
  if (a.prev_out != nullptr) store_rows(a.prev_out + 3 * i0, rows, p);
  store_rows(a.proposed + 3 * i0, rows, q);
}

}  // namespace

extern "C" int mcmh_motion(MotionArgs a, void* stream) {
  if (a.n < 0 || a.retries < 0 || (a.retries > 0 && a.free_mask == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // at least one block: thread 0 writes the delta and the anchor
  const long long groups = (static_cast<long long>(a.n) + kRows - 1) / kRows;
  const int b = groups > 0 ? static_cast<int>((groups + kThreads - 1) / kThreads)
                           : 1;
  if (a.retries > 0) {
    motion_kernel<true><<<b, kThreads, 0, s>>>(a);
  } else {
    motion_kernel<false><<<b, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
