// The filter step's weight chain (filter/step.py::_correct, ops/
// weight_chain.py): from the scores of the proposed and previous sets to
// the ESS.
//
//   pass 1  scores   masked online max and sum of exp over s_post + carry
//                    and s_pre + carry; the sums of the forward and
//                    backward motion densities; last block: the two
//                    softmax constants, the density totals, the beams
//   pass 2  mh       alpha (asymmetric: the 1e-10 log guards and the
//                    always-accept guard; symmetric; none), the accept on
//                    torch's u, the selected set and its unnormalised
//                    weights; the accept count, the weights' sum, the sum
//                    of exp(per-beam s_post), the argmax (first index on
//                    ties) with its row; last block: the normaliser, the
//                    accept rate, the candidate
//   pass 3  moments  the normalised weights; sum w, sum w^2, the cluster
//                    masses at the candidate and at the anchor, the
//                    margin's max near the anchor, the estimate's moments
//                    (mean: the active set, cluster: near the candidate);
//                    last block: w_slow / w_fast, the anchor, its mass and
//                    streak, the mean, the ESS
//   (pass 3b)        estimate_mode "anchor": the moments near the new
//                    anchor, which pass 3 decides
//   pass 4  cov      sum wn r r^T and sum wn^2, r about the mean with theta
//                    wrapped; last block: the covariance over 1 - v2
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA
// (mcmh_localization_tpu/filter/step.py:651-715, ops/resampling.py,
// filter/mh.py, models/motion.py, filter/estimate.py), as it does the
// bin-LUT einsum, the EDT and the step's control flow.  In PyTorch the
// chain was about 290 launches a scan, many on 0-d tensors.
//
// Bound: the bytes, each input read once and each output written once:
// the scores (8 B a slot), the carried weights (4), both sets (24), u (4),
// the selected set (12) and the weights (4) written: 56 B a slot, 52 B
// without the carry (52 MB at BIG's 1M slots, 15.5 us at 3.35 TB/s).  At these sizes the chain is bound by
// launches, so each pass fuses every per-slot operation up to its next
// global reduction: a grid-stride loop, warp-shuffle and block reductions
// into per-block partials, and a last block (found by a __threadfence and
// an atomic ticket that wraps back to 0, so a replay finds it at 0) that
// folds the partials in block order and does the pass's 0-d work.  No
// float atomics: every sum is repeatable bit for bit from call to call.
// The tickets are one set a device, so chains on one device run one at a
// time (the port launches every step on one stream).  Pass 1 keeps each
// slot's two motion densities for pass 2, the forward one in the weights'
// buffer and the backward one in the scratch's tail (at 1M slots on an
// H100 pass 2 took 38.6 us so, 40.9 us computing them again).
// One block running every pass (one launch) was tried at 5000 slots and
// lost to the passes on an H100: 0.050 against 0.036 ms, its 800-odd
// instructions a slot all on one SM.
//
// The per-slot arithmetic follows the plain PyTorch chain operation by
// operation (no contraction: --fmad=false), so a slot's values match it;
// the sums are taken in another order, so the scalars, and a weight
// through its normaliser, differ from it in the last bits, and an accept
// at u == alpha to the last bit can flip.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;        // a block of the multi-block passes
constexpr int kMaxBlocks = 1024;     // 2^18 threads: about one wave
constexpr int kScalars = 32;         // scratch: the passes' 0-d results
constexpr int kPartial = 12;         // scratch: words of a block's partial

// f32(math.pi) and f32(2 * math.pi), as PyTorch rounds the python scalars
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// scratch slots
enum {
  S_MPOST, S_SPOST, S_MPRE, S_SPRE, S_TF, S_TB, S_BEAMS, S_NORM, S_TOPVAL,
  S_CAND, S_WAVG = S_CAND + 3, S_MEAN, S_V1 = S_MEAN + 3
};
// out slots (ops/weight_chain.py reads them)
enum {
  O_WSLOW, O_WFAST, O_ACCEPT, O_ANCHOR, O_MASS = O_ANCHOR + 3, O_MEAN,
  O_COV = O_MEAN + 3, O_ESS = O_COV + 9
};

}  // namespace

// ops/_cuda.py::ChainArgs, passed by value
struct ChainArgs {
  const float* scores;     // (n) s_post, or (2n) s_post then s_pre
  const float* w_in;       // (n) the state's weights: the carry
  const float* particles;  // (n, 3) the proposed set
  const float* prev;       // (n, 3) the previous set
  const float* delta;      // (3) rot1, trans, rot2
  const float* u;          // (n) the MH uniforms
  const int* count;
  const float* w_slow;
  const float* w_fast;
  const float* anchor;     // (3)
  const int* streak;
  const float* ranges;     // (n_ranges) the scan
  float* p_out;            // (n, 3) the selected set (with MH)
  float* w_out;            // (n) the weights
  float* out;              // see O_*
  int* streak_out;
  float* scratch;          // kScalars + blocks * kPartial
  int n, n_ranges, range_step;
  int mh;                  // 0 none, 1 symmetric, 2 asymmetric
  int guard;               // asymmetric: alpha = 1 where log_den <= 0
  int carry;               // log weights added to both sets' scores
  int adaptive;            // w_slow / w_fast updated
  int ref_w_avg;           // w_avg = sum w / count (else exp per beam)
  int sum_agg;             // score_aggregation "sum": per-beam by beams
  int est_mode;            // 0 mean, 1 cluster, 2 anchor
  int margin_on;           // anchor_score_margin > 0
  int ref_bwd;             // ref_compat_backward_delta
  int commit;              // anchor_commit_scans
  float a1, a2, a3, a4, alpha_slow, alpha_fast, rxy, rxy2, rth, hysteresis,
      neg_margin, max_range;
};

namespace {

__device__ unsigned int g_tickets[5];   // one a pass

// the blocks of every pass: one slot a thread up to 2^18 slots
__host__ __device__ __forceinline__ int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

// ---------------------------------------------------------------------------
// the plain chain's elementwise arithmetic
// ---------------------------------------------------------------------------

// torch.remainder on floats: fmod, moved onto the divisor's sign (an
// exact fmaf form of it was tried in the angle wraps and moved no pass's
// time on an H100)
__device__ __forceinline__ float remainder_f(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m += b;
  return m;
}

// utils/angles.py::normalize_angle
__device__ __forceinline__ float wrap(float t) {
  return remainder_f(t + kPi, kTwoPi) - kPi;
}

// a delta, its three noise stds clamped as _gaussian_prob clamps them, and
// each one's normaliser sqrt(2 pi s s)
struct Motion {
  float d[3], s[3], norm[3];
};

// the delta and models/motion.py::_noise_stds of it
__device__ Motion motion(float r1, float t, float r2, const ChainArgs& a) {
  const float ar1 = fabsf(r1), at = fabsf(t), ar2 = fabsf(r2);
  const float sig[3] = {a.a1 * ar1 + a.a2 * at,
                        a.a3 * at + a.a4 * (ar1 + ar2),
                        a.a1 * ar2 + a.a2 * at};
  Motion m{{r1, t, r2}, {}, {}};
  for (int k = 0; k < 3; ++k) {
    m.s[k] = fmaxf(sig[k], 1e-9f);
    m.norm[k] = sqrtf(kTwoPi * m.s[k] * m.s[k]);
  }
  return m;
}

// the forward delta and models/motion.py::invert_delta of it
__device__ void motions(const ChainArgs& a, Motion& fwd, Motion& bwd) {
  const float r1 = a.delta[0], t = a.delta[1], r2 = a.delta[2];
  fwd = motion(r1, t, r2, a);
  if (a.ref_bwd) {
    const float c = cosf(r2), s = sinf(r2);
    bwd = motion(-r1 * c - t * s, r1 * s - t * c, -r2, a);
  } else {
    bwd = motion(wrap(kPi - r2), t, wrap(-r1 - kPi), a);
  }
}

// models/motion.py::_gaussian_prob of component k
__device__ __forceinline__ float gauss(float diff, const Motion& m, int k) {
  const float q = diff / m.s[k];
  return expf(-0.5f * (q * q)) / m.norm[k];
}

// models/motion.py::motion_density's product, unnormalised
__device__ float density(float3 p0, float3 p1, const Motion& m) {
  const float dx = p1.x - p0.x, dy = p1.y - p0.y;
  const float trans = sqrtf(dx * dx + dy * dy);
  const float rot1 = wrap(atan2f(dy, dx) - p0.z);
  const float rot2 = wrap(p1.z - p0.z - rot1);
  return gauss(wrap(m.d[0] - rot1), m, 0) * gauss(m.d[1] - trans, m, 1) *
         gauss(wrap(m.d[2] - rot2), m, 2);
}

__device__ __forceinline__ float3 row3(const float* p, int i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

// filter/estimate.py::_near
__device__ __forceinline__ bool near(float3 p, float3 c, const ChainArgs& a) {
  const float dx = p.x - c.x, dy = p.y - c.y;
  return (dx * dx + dy * dy <= a.rxy2) && (fabsf(wrap(p.z - c.z)) <= a.rth);
}

// the online softmax: (m, s) with s = sum exp(x - m); -inf adds nothing
__device__ __forceinline__ void online(float& m, float& s, float x) {
  if (x == -INFINITY) return;
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
  } else if (m2 > m) {
    s = s2 + s * expf(m - m2);
    m = m2;
  } else {
    s += s2 * expf(m2 - m);
  }
}

// ---------------------------------------------------------------------------
// the passes' partials
// ---------------------------------------------------------------------------

struct ScoreAcc {
  float mp, sp, mq, sq, tf, tb;
  static __device__ ScoreAcc identity() {
    return {-INFINITY, 0.f, -INFINITY, 0.f, 0.f, 0.f};
  }
  static __device__ ScoreAcc combine(ScoreAcc a, const ScoreAcc& b) {
    merge(a.mp, a.sp, b.mp, b.sp);
    merge(a.mq, a.sq, b.mq, b.sq);
    a.tf += b.tf;
    a.tb += b.tb;
    return a;
  }
};

struct MhAcc {
  int acc;
  float sw, sx, top_w;
  int top_i;
  float tx, ty, tz;
  static __device__ MhAcc identity() {
    return {0, 0.f, 0.f, -INFINITY, INT_MAX, 0.f, 0.f, 0.f};
  }
  static __device__ MhAcc combine(MhAcc a, const MhAcc& b) {
    a.acc += b.acc;
    a.sw += b.sw;
    a.sx += b.sx;
    if (b.top_w > a.top_w || (b.top_w == a.top_w && b.top_i < a.top_i)) {
      a.top_w = b.top_w;
      a.top_i = b.top_i;
      a.tx = b.tx;
      a.ty = b.ty;
      a.tz = b.tz;
    }
    return a;
  }
};

// pass 3 and 3b: the estimate's moments over its set (cw, cx, cy, cc, cs)
struct MomAcc {
  float sw, sw2, cw, cx, cy, cc, cs, mcand, mcur, marg;
  static __device__ MomAcc identity() {
    return {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }
  static __device__ MomAcc combine(MomAcc a, const MomAcc& b) {
    a.sw += b.sw;
    a.sw2 += b.sw2;
    a.cw += b.cw;
    a.cx += b.cx;
    a.cy += b.cy;
    a.cc += b.cc;
    a.cs += b.cs;
    a.mcand += b.mcand;
    a.mcur += b.mcur;
    a.marg = fmaxf(a.marg, b.marg);
    return a;
  }
};

struct CovAcc {
  float c00, c01, c02, c11, c12, c22, v2;
  static __device__ CovAcc identity() {
    return {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }
  static __device__ CovAcc combine(CovAcc a, const CovAcc& b) {
    a.c00 += b.c00;
    a.c01 += b.c01;
    a.c02 += b.c02;
    a.c11 += b.c11;
    a.c12 += b.c12;
    a.c22 += b.c22;
    a.v2 += b.v2;
    return a;
  }
};

struct IntAcc {
  int v;
  static __device__ IntAcc identity() { return {0}; }
  static __device__ IntAcc combine(IntAcc a, const IntAcc& b) {
    a.v += b.v;
    return a;
  }
};

template <class T>
__device__ __forceinline__ T shfl_down(const T& v, int d) {
  static_assert(sizeof(T) % 4 == 0, "partials are 32-bit words");
  T r;
  const int* s = reinterpret_cast<const int*>(&v);
  int* o = reinterpret_cast<int*>(&r);
#pragma unroll
  for (int k = 0; k < int(sizeof(T) / 4); ++k)
    o[k] = __shfl_down_sync(0xffffffffu, s[k], d);
  return r;
}

// The block's total in thread 0, in a fixed tree: lanes, then warps.
// Every thread of the block calls it.
template <class T>
__device__ T block_reduce(T v) {
  __shared__ T red[32];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = T::combine(v, shfl_down(v, d));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < int(blockDim.x >> 5) ? red[lane] : T::identity();
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = T::combine(v, shfl_down(v, d));
  }
  __syncthreads();
  return v;
}

template <class T>
__device__ __forceinline__ void put(float* dst, const T& v) {
  const int* s = reinterpret_cast<const int*>(&v);
  int* d = reinterpret_cast<int*>(dst);
#pragma unroll
  for (int k = 0; k < int(sizeof(T) / 4); ++k) d[k] = s[k];
}

template <class T>
__device__ __forceinline__ T get_cg(const float* src) {
  T v;
  int* d = reinterpret_cast<int*>(&v);
  const int* s = reinterpret_cast<const int*>(src);
#pragma unroll
  for (int k = 0; k < int(sizeof(T) / 4); ++k) d[k] = __ldcg(s + k);
  return v;
}

// ---------------------------------------------------------------------------
// each pass: its slots (start, stride), then its 0-d work on the total
// (every thread of one block calls fin_*; thread 0 holds the total)
// ---------------------------------------------------------------------------

// the carried log weight (the plain chain adds 0.0 without the carry)
__device__ __forceinline__ float log_carry(const ChainArgs& a, int i) {
  return a.carry ? logf(fmaxf(a.w_in[i], 1e-30f)) : 0.f;
}

__device__ __forceinline__ float* bwd_of(const ChainArgs& a) {
  return a.scratch + kScalars + blocks_for(a.n) * kPartial;
}

__device__ void acc_scores(const ChainArgs& a, int start, int stride,
                           ScoreAcc& v) {
  const int cnt = *a.count;
  Motion mf, mb;
  motions(a, mf, mb);
  for (int i = start; i < a.n; i += stride) {
    if (i < cnt) {
      const float lc = log_carry(a, i);
      online(v.mp, v.sp, a.scores[i] + lc);
      if (a.mh) online(v.mq, v.sq, a.scores[a.n + i] + lc);
    }
    if (a.mh == 2) {
      // the densities' totals run over every slot; each slot's densities
      // wait for pass 2 in its weight and in the scratch's tail
      const float3 p0 = row3(a.prev, i), p1 = row3(a.particles, i);
      const float f = density(p0, p1, mf), b = density(p1, p0, mb);
      a.w_out[i] = f;
      bwd_of(a)[i] = b;
      v.tf += f;
      v.tb += b;
    }
  }
}

__device__ void fin_scores(const ChainArgs& a, const ScoreAcc& t) {
  IntAcc nb{0};
  if (a.sum_agg) {   // step.py::_beam_count: finite and short of max_range
    for (int j = threadIdx.x * a.range_step; j < a.n_ranges;
         j += blockDim.x * a.range_step) {
      const float r = a.ranges[j];
      nb.v += (isfinite(r) && r < a.max_range) ? 1 : 0;
    }
    nb = block_reduce(nb);
  }
  if (threadIdx.x == 0) {
    float* s = a.scratch;
    s[S_MPOST] = t.mp;
    s[S_SPOST] = t.sp;
    s[S_MPRE] = t.mq;
    s[S_SPRE] = t.sq;
    s[S_TF] = t.tf;
    s[S_TB] = t.tb;
    s[S_BEAMS] = static_cast<float>(max(nb.v, 1));
  }
}

__device__ void acc_mh(const ChainArgs& a, int start, int stride, MhAcc& v) {
  const int cnt = *a.count;
  const float* s = a.scratch;
  const float mp = s[S_MPOST], sp = s[S_SPOST], mq = s[S_MPRE],
              sq = s[S_SPRE], tf = s[S_TF], tb = s[S_TB],
              beams = s[S_BEAMS];
  const bool w_exp = a.adaptive && !a.ref_w_avg;
  for (int i = start; i < a.n; i += stride) {
    const bool act = i < cnt;
    const float s_post = a.scores[i];
    const float lc = act ? log_carry(a, i) : 0.f;
    const float wp = act ? expf(s_post + lc - mp) / sp : 0.f;
    float w = wp;
    float3 sel = row3(a.particles, i);
    if (a.mh) {
      const float wq = act ? expf(a.scores[a.n + i] + lc - mq) / sq : 0.f;
      const float3 p0 = row3(a.prev, i);
      float alpha;
      if (a.mh == 2) {
        float f = a.w_out[i], b = bwd_of(a)[i];   // pass 1's
        if (tf > 0.f) f = f / tf;
        if (tb > 0.f) b = b / tb;
        const float num = logf(wp + 1e-10f) + logf(b + 1e-10f);
        const float den = logf(wq + 1e-10f) + logf(f + 1e-10f);
        alpha = fminf(expf(num - den), 1.f);
        if (a.guard && !(den > 0.f)) alpha = 1.f;
      } else {
        alpha = wq > 0.f ? fminf(wp / wq, 1.f) : 1.f;
      }
      const bool accept = a.u[i] < alpha;
      if (!accept) {
        sel = p0;
        w = wq;
      }
      a.p_out[3 * i] = sel.x;
      a.p_out[3 * i + 1] = sel.y;
      a.p_out[3 * i + 2] = sel.z;
      if (act && accept) v.acc += 1;
    }
    if (!act) w = 0.f;
    a.w_out[i] = w;
    v.sw += w;
    if (w_exp && act) v.sx += expf(a.sum_agg ? s_post / beams : s_post);
    if (w > v.top_w) {   // ascending i: the first index on ties
      v.top_w = w;
      v.top_i = i;
      v.tx = sel.x;
      v.ty = sel.y;
      v.tz = sel.z;
    }
  }
}

__device__ void fin_mh(const ChainArgs& a, const MhAcc& t) {
  if (threadIdx.x != 0) return;
  const float cnt = static_cast<float>(max(*a.count, 1));
  float* s = a.scratch;
  s[S_NORM] = fmaxf(t.sw, 1e-30f);
  s[S_TOPVAL] = t.top_w;
  s[S_CAND] = t.tx;
  s[S_CAND + 1] = t.ty;
  s[S_CAND + 2] = t.tz;
  s[S_WAVG] = t.sx / cnt;
  a.out[O_ACCEPT] = a.mh ? static_cast<float>(t.acc) / cnt : 1.f;
}

__device__ __forceinline__ void moments(MomAcc& v, float3 p, float w) {
  v.cw += w;
  v.cx += w * p.x;
  v.cy += w * p.y;
  v.cc += w * cosf(p.z);
  v.cs += w * sinf(p.z);
}

__device__ __forceinline__ const float* selected(const ChainArgs& a) {
  return a.mh ? a.p_out : a.particles;
}

__device__ __forceinline__ float3 cand_of(const ChainArgs& a) {
  const float* s = a.scratch;
  return make_float3(s[S_CAND], s[S_CAND + 1], s[S_CAND + 2]);
}

__device__ void acc_moments(const ChainArgs& a, int start, int stride,
                            MomAcc& v) {
  const int cnt = *a.count;
  const float norm = a.scratch[S_NORM];
  const float3 cand = cand_of(a);
  const float3 anc = row3(a.anchor, 0);
  const float* ps = selected(a);
  for (int i = start; i < a.n; i += stride) {
    const float w = a.w_out[i] / norm;
    a.w_out[i] = w;
    const float3 p = row3(ps, i);
    const bool nc = near(p, cand, a), na = near(p, anc, a);
    v.sw += w;
    v.sw2 += w * w;
    if (a.est_mode == 0 ? i < cnt : (a.est_mode == 1 && nc && i < cnt))
      moments(v, p, w);
    if (nc) v.mcand += w;
    if (na) {
      v.mcur += w;
      v.marg = fmaxf(v.marg, w);
    }
  }
}

// the estimate's mean from its set's moments
__device__ void mean_of(const ChainArgs& a, const MomAcc& t) {
  const float d = fmaxf(t.cw, 1e-30f);
  const float mx = t.cx / d, my = t.cy / d;
  const float mt = atan2f(t.cs / d, t.cc / d);
  float* s = a.scratch;
  s[S_MEAN] = mx;
  s[S_MEAN + 1] = my;
  s[S_MEAN + 2] = mt;
  s[S_V1] = d;
  a.out[O_MEAN] = mx;
  a.out[O_MEAN + 1] = my;
  a.out[O_MEAN + 2] = mt;
}

__device__ void fin_moments(const ChainArgs& a, const MomAcc& t) {
  if (threadIdx.x != 0) return;
  const float* s = a.scratch;
  const int cnt = max(*a.count, 1);
  if (a.adaptive) {
    const float w_avg = a.ref_w_avg ? t.sw / static_cast<float>(cnt)
                                    : s[S_WAVG];
    const float ws = *a.w_slow, wf = *a.w_fast;
    a.out[O_WSLOW] = ws + a.alpha_slow * (w_avg - ws);
    a.out[O_WFAST] = wf + a.alpha_fast * (w_avg - wf);
  }
  // step.py::refresh_anchor
  const float3 cand = cand_of(a);
  const float3 anc = row3(a.anchor, 0);
  const bool same = hypotf(cand.x - anc.x, cand.y - anc.y) <= a.rxy &&
                    fabsf(wrap(cand.z - anc.z)) <= a.rth;
  bool migrate = t.mcand > a.hysteresis * t.mcur;
  if (a.margin_on) {
    const float top = s[S_TOPVAL] / s[S_NORM];
    const float x = a.sum_agg ? a.neg_margin * s[S_BEAMS] : a.neg_margin;
    migrate = migrate && (t.marg < top * expf(x));
  }
  int streak = (migrate && !same) ? *a.streak + 1 : 0;
  migrate = migrate && streak >= a.commit;
  const bool adopt = same || migrate;
  if (migrate) streak = 0;
  a.out[O_ANCHOR] = adopt ? cand.x : anc.x;
  a.out[O_ANCHOR + 1] = adopt ? cand.y : anc.y;
  a.out[O_ANCHOR + 2] = adopt ? cand.z : anc.z;
  a.out[O_MASS] = adopt ? t.mcand : t.mcur;
  *a.streak_out = streak;
  a.out[O_ESS] = 1.f / fmaxf(t.sw2, 1e-30f);
  if (a.est_mode != 2) mean_of(a, t);
}

// estimate_mode "anchor": the moments near the anchor pass 3 chose
__device__ void acc_anchor_moments(const ChainArgs& a, int start, int stride,
                                   MomAcc& v) {
  const int cnt = *a.count;
  const float3 anc = row3(a.out + O_ANCHOR, 0);
  const float* ps = selected(a);
  for (int i = start; i < a.n; i += stride) {
    const float3 p = row3(ps, i);
    if (i < cnt && near(p, anc, a)) moments(v, p, a.w_out[i]);
  }
}

__device__ void fin_anchor_moments(const ChainArgs& a, const MomAcc& t) {
  if (threadIdx.x == 0) mean_of(a, t);
}

// the estimate's set: the active slots, or those near its centre
__device__ __forceinline__ bool in_estimate(const ChainArgs& a, float3 p,
                                            int i, int cnt) {
  if (i >= cnt) return false;
  if (a.est_mode == 0) return true;
  const float3 c = a.est_mode == 1 ? cand_of(a) : row3(a.out + O_ANCHOR, 0);
  return near(p, c, a);
}

__device__ void acc_cov(const ChainArgs& a, int start, int stride,
                        CovAcc& v) {
  const int cnt = *a.count;
  const float* s = a.scratch;
  const float mx = s[S_MEAN], my = s[S_MEAN + 1], mt = s[S_MEAN + 2],
              d = s[S_V1];
  const float* ps = selected(a);
  for (int i = start; i < a.n; i += stride) {
    const float3 p = row3(ps, i);
    if (!in_estimate(a, p, i, cnt)) continue;
    const float wn = a.w_out[i] / d;
    const float r0 = p.x - mx, r1 = p.y - my, r2 = wrap(p.z - mt);
    const float q0 = r0 * wn, q1 = r1 * wn, q2 = r2 * wn;
    v.c00 += q0 * r0;
    v.c01 += q0 * r1;
    v.c02 += q0 * r2;
    v.c11 += q1 * r1;
    v.c12 += q1 * r2;
    v.c22 += q2 * r2;
    v.v2 += wn * wn;
  }
}

__device__ void fin_cov(const ChainArgs& a, const CovAcc& t) {
  if (threadIdx.x != 0) return;
  const float den = fmaxf(1.f - t.v2, 1e-12f);
  const float c[6] = {t.c00 / den, t.c01 / den, t.c02 / den,
                      t.c11 / den, t.c12 / den, t.c22 / den};
  float* o = a.out + O_COV;
  o[0] = c[0];
  o[1] = c[1];
  o[2] = c[2];
  o[3] = c[1];
  o[4] = c[3];
  o[5] = c[4];
  o[6] = c[2];
  o[7] = c[4];
  o[8] = c[5];
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// One pass: the slots, the block's partial, and in the last block to
// finish the fold of every partial in block order and FIN.
template <class T, void (*ACC)(const ChainArgs&, int, int, T&),
          void (*FIN)(const ChainArgs&, const T&)>
__device__ void pass(const ChainArgs& a, unsigned int* ticket) {
  T v = T::identity();
  ACC(a, blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x, v);
  v = block_reduce(v);
  float* parts = a.scratch + kScalars;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    put(parts + blockIdx.x * kPartial, v);
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  T f = T::identity();
  for (int j = threadIdx.x; j < int(gridDim.x); j += blockDim.x)
    f = T::combine(f, get_cg<T>(parts + j * kPartial));
  FIN(a, block_reduce(f));
}

__global__ void __launch_bounds__(kThreads) chain_scores(ChainArgs a) {
  pass<ScoreAcc, acc_scores, fin_scores>(a, g_tickets + 0);
}
__global__ void __launch_bounds__(kThreads) chain_mh(ChainArgs a) {
  pass<MhAcc, acc_mh, fin_mh>(a, g_tickets + 1);
}
__global__ void __launch_bounds__(kThreads) chain_moments(ChainArgs a) {
  pass<MomAcc, acc_moments, fin_moments>(a, g_tickets + 2);
}
__global__ void __launch_bounds__(kThreads) chain_anchor_moments(ChainArgs a) {
  pass<MomAcc, acc_anchor_moments, fin_anchor_moments>(a, g_tickets + 3);
}
__global__ void __launch_bounds__(kThreads) chain_cov(ChainArgs a) {
  pass<CovAcc, acc_cov, fin_cov>(a, g_tickets + 4);
}


}  // namespace

// the scalars, the partials, then n floats of the backward densities
extern "C" int mcmh_weight_chain_scratch_floats(int n) {
  return kScalars + blocks_for(n) * kPartial + n;
}

// Passes 1-2: the selected set and its weights.
extern "C" int mcmh_weight_chain_mh(ChainArgs a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = blocks_for(a.n);
  chain_scores<<<b, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_mh<<<b, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Passes 3 (3b) and 4: the weights normalised, the averages, the anchor,
// the estimate and the ESS.
extern "C" int mcmh_weight_chain_estimate(ChainArgs a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = blocks_for(a.n);
  chain_moments<<<b, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.est_mode == 2) {
    chain_anchor_moments<<<b, kThreads, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chain_cov<<<b, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
