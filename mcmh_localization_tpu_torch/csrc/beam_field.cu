// Beam score-field build for the ray-cast beam model
// (models/range_table.py::beam_field_scores and its coarse fallback).
//
//   out[b, c] = sum_{g=0}^{K-1} s[b, g, qt[g, c]]              (B, C) f32
//
// qt is the int8 quantized range table (K, C) with values in [0, nq) (the
// window or the coarse block centres of models/range_table.py::
// quantize_table's output); s the per-scan LUT (B, K, nq) f32.
//
// Replaces mcmh_localization_tpu/ops/beam_field_pallas.py::lut_field.  The
// TPU kernel builds a one-hot of qt in VMEM and multiplies it on the MXU
// against int8 hi/lo planes of s with int32 accumulation, because gathers
// serialize on a TPU.  Here the sum is a gather from a small table in
// shared memory.  No one-hot and no quantization of s.
//
// Bound: B * K * C reads of 4 bytes from shared memory (37.7 MB for the
// fine window at B=24, K=96, C=64^2; 85 MB for the coarse 96^2), at 128
// bytes a clock an SM; the DRAM bytes (qt, s, out: 0.5-1.3 MB) and the
// adds are far below that.  A row of s[b, g] is nq = 51 words, so the 32
// random reads of a warp fall on at most two words of a bank; on the beam
// path's tables that costs nothing measurable (all indices 0, every read a
// broadcast, timed the same).  What holds the kernel back is latency: the
// fine build is 98 304 sums of 96 terms, a few warps an SM, and every
// block first stages its LUTs and its qt tile (50-100 KB) from L2.
// The first kernel (one output a thread, a block per 256 cells and one b)
// restaged all of s[b] in every block, re-read qt once per b as one byte a
// thread, and walked a chain of dependent global and shared loads with a
// runtime trip count.  The layout now:
//  - a block owns a tile of blockDim.x cells (one a thread) and BPAR
//    consecutive b (both from the caller, ops/beam_field.py::lut_tiles:
//    BPAR = 2 at the fine build, 4 at the coarse);
//  - it stages its qt tile (K rows of the tile's bytes, 16 a copy) and its
//    BPAR LUTs in shared memory with cp.async, and sums the BPAR outputs of
//    each cell in one pass over the bins, so one index read serves BPAR
//    LUTs;
//  - the bins go 8 at a time, the 8 index reads and the 8 * BPAR LUT reads
//    issued before the adds, so a thread keeps BPAR independent chains with
//    their loads in flight;
//  - a qt or s that is not aligned for 16-byte copies (or a C or K * nq
//    that is not a multiple of them) takes 4-byte copies, and a ragged last
//    tile reads zeros past C and stores nothing there.
//  - where the LUT slots and the qt tile of all K bins do not fit a
//    block's shared memory (K = 360 table bins at nq = 51: 385 920 bytes
//    at 4 b a block), the block walks the bins in chunks of ``kg`` that
//    fit (ops/beam_field.py::lut_plan), restaging both between chunks and
//    keeping each output's sum in a register across them, in a template
//    instance of its own, so a build whose bins fit runs the one-staging
//    code unchanged.  The TPU kernel chunks over K the same way.  One
//    launch a chunk, each adding onto the partial sums in ``out``, was
//    slower (chip_kernel_ab.py --kernels 7k, PERF.md §6).
// Each output still adds over g in ascending order from 0.0f with
// round-to-nearest adds, the plain PyTorch version's order, in one chunk
// or several, so the two agree bitwise.
// mcmh_lut_field_at builds the fine field over a window of the whole
// (K, H, W) table, read in place at the window's (oy0, ox0) in device
// memory (kernel 1 reads its window the same way): the window need not be
// copied out at a corner read on the host.  The corner aligns to
// nothing, so a 16-byte piece of a window row comes as the five aligned
// words around it, funnel-shifted into place (byte loads took twice the
// launch-argument form's time at (F), PERF.md §6); the LUT staging and
// the sums are the launch-argument entry's.
// Tried and dropped (timed on an NVIDIA H100 80GB HBM3 at 700 W at the
// beam path's shapes, in turns with the first kernel; PERF.md §6): one b a
// block (slower at both builds); 2 or 4 cells a thread; a block walking two passes with the next LUTs landing in
// a two-stage ring while the current ones are summed (half the blocks);
// the indices held in registers for the whole walk (255 registers and
// spills); the staging in 2-8 chunks of bins, each summed as it lands
// (more chunks, slower).

#include <cuda_runtime.h>

#include "thread_runs.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kChunk = 8;  // bins whose loads issue together

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// floats of one LUT slot: K * nq rounded up to 16 bytes
__host__ __device__ __forceinline__ int slot_floats(int k, int nq) {
  return (k * nq + 3) & ~3;
}

// Where a block reads qt: the (K, C) table itself (win == 0, a bin's row
// ``plane`` = C bytes long), or a win x win window of the (K, H, W) table
// (plane = H * W, row stride ``ld`` = W) whose corner ``base`` points at:
// cell c of the window is (c / win, c % win) from there.
struct QtView {
  const signed char* base;
  long long plane;
  int ld;
  int win;
};

// Stages the qt rows and LUT rows of bins [g0, g0 + gn) of the block's
// cells and b: gn rows of tc bytes of qt, 16 a copy (zeros past C), and
// gn * nq floats of each LUT s[b0 .. b0 + n_b - 1] into its slot, 16-byte
// copies where vec.  A window's corner is anywhere in the table, so its
// rows align to nothing: where a window row holds whole pieces (win a
// multiple of 16), a piece comes as the aligned words around it, shifted
// into place; else one byte at a time.
__device__ __forceinline__ void stage_bins(
    const QtView& qv, const float* __restrict__ s, int kn, int nq, int c,
    int c0, int b0, int n_b, int g0, int gn, int slot, bool vec_q,
    bool vec_s, float* lut, unsigned char* q_s) {
  const int tc = blockDim.x;
  const int pieces = tc / 16;
  for (int idx = threadIdx.x; idx < gn * pieces; idx += tc) {
    const int gl = idx / pieces;
    const int cell = c0 + 16 * (idx - gl * pieces);
    unsigned char* dst = q_s + gl * tc + (cell - c0);
    const signed char* plane = qv.base + (g0 + gl) * qv.plane;
    if (qv.win == 0) {
      const signed char* src = plane + cell;
      if (vec_q && cell + 16 <= c) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          dst[j] = cell + j < c ? static_cast<unsigned char>(__ldg(src + j))
                                : 0;
        }
      }
    } else {
      int y = cell / qv.win;
      int x = cell - y * qv.win;
      const signed char* src = plane + static_cast<long long>(y) * qv.ld + x;
      if (qv.win % 16 == 0 && cell + 16 <= c) {
        // the piece lies in one window row: its 16 bytes from the aligned
        // words that cover them, shifted into place (the corner's
        // misalignment is the same for every piece)
        const unsigned long long a = reinterpret_cast<unsigned long long>(src);
        const unsigned* w = reinterpret_cast<const unsigned*>(a & ~3ull);
        const unsigned sh = static_cast<unsigned>(a & 3ull) * 8u;
        unsigned u[5];
#pragma unroll
        for (int i = 0; i < 4; ++i) u[i] = __ldg(w + i);
        // the fifth word only where the bytes run into it: an aligned
        // piece may end the table
        u[4] = sh != 0u ? __ldg(w + 4) : 0u;
        uint4 o;
        o.x = __funnelshift_r(u[0], u[1], sh);
        o.y = __funnelshift_r(u[1], u[2], sh);
        o.z = __funnelshift_r(u[2], u[3], sh);
        o.w = __funnelshift_r(u[3], u[4], sh);
        *reinterpret_cast<uint4*>(dst) = o;
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          dst[j] = cell + j < c
                       ? static_cast<unsigned char>(__ldg(
                             plane + static_cast<long long>(y) * qv.ld + x))
                       : 0;
          if (++x == qv.win) {
            x = 0;
            ++y;
          }
        }
      }
    }
  }
  const int cn = gn * nq;
  for (int p = 0; p < n_b; ++p) {
    float* dst = lut + p * slot;
    const float* src = s + static_cast<long long>(b0 + p) * kn +
                       static_cast<long long>(g0) * nq;
    if (vec_s) {
      for (int i = 4 * threadIdx.x; i < cn; i += 4 * tc) {
        cp_async16(dst + i, src + i);
      }
    } else {
      for (int i = threadIdx.x; i < cn; i += tc) cp_async4(dst + i, src + i);
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// Adds the gn staged bins of this thread's cell onto acc, in ascending g.
// (slots past n_b are never stored: their sums read stale shared memory)
template <int BPAR>
__device__ __forceinline__ void sum_bins(const float* lut,
                                         const unsigned char* q_s, int gn,
                                         int nq, int slot, float* acc) {
  const int tc = blockDim.x;
  const unsigned char* q_col = q_s + threadIdx.x;
  int g = 0;
  for (; g + kChunk <= gn; g += kChunk) {
    unsigned q[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) q[u] = q_col[(g + u) * tc];
    float v[kChunk][BPAR];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float* row = lut + (g + u) * nq + q[u];
#pragma unroll
      for (int p = 0; p < BPAR; ++p) v[u][p] = row[p * slot];
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
#pragma unroll
      for (int p = 0; p < BPAR; ++p) acc[p] = __fadd_rn(acc[p], v[u][p]);
    }
  }
  for (; g < gn; ++g) {
    const float* row = lut + g * nq + q_col[g * tc];
#pragma unroll
    for (int p = 0; p < BPAR; ++p) acc[p] = __fadd_rn(acc[p], row[p * slot]);
  }
}

// kChunked: the block stages kg < K bins at a time and keeps each output's
// sum in a register across the chunks; else it stages all K at once.
// origin: null for the (K, C) table; else the window's (oy0, ox0) in
// device memory, the table (K, H, W) with ld = W, win x win = C cells.
template <int BPAR, bool kChunked>
__global__ void __launch_bounds__(kMaxThreads) lut_field_kernel(
    const signed char* __restrict__ qt, const float* __restrict__ s, int nb,
    int k, int nq, int c, int kg, bool vec_q, bool vec_s,
    const int* __restrict__ origin, long long plane, int ld, int win,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  QtView qv{qt, plane, ld, win};
  if (origin != nullptr) {
    qv.base += static_cast<long long>(__ldg(origin)) * ld + __ldg(origin + 1);
  }
  const int kn = k * nq;
  const int slot = slot_floats(kChunked ? kg : k, nq);
  float* lut = reinterpret_cast<float*>(smem);
  unsigned char* q_s = smem + sizeof(float) * slot * BPAR;
  const int c0 = blockIdx.x * blockDim.x;
  const int b0 = blockIdx.y * BPAR;
  const int n_b = min(BPAR, nb - b0);

  float acc[BPAR];
#pragma unroll
  for (int p = 0; p < BPAR; ++p) acc[p] = 0.0f;
  if constexpr (!kChunked) {
    stage_bins(qv, s, kn, nq, c, c0, b0, n_b, 0, k, slot, vec_q, vec_s, lut,
               q_s);
    sum_bins<BPAR>(lut, q_s, k, nq, slot, acc);
  } else {
    for (int g0 = 0; g0 < k; g0 += kg) {
      if (g0 > 0) __syncthreads();  // every thread is done with the chunk
      const int gn = min(kg, k - g0);
      stage_bins(qv, s, kn, nq, c, c0, b0, n_b, g0, gn, slot, vec_q, vec_s,
                 lut, q_s);
      sum_bins<BPAR>(lut, q_s, gn, nq, slot, acc);
    }
  }
  const int cell = c0 + threadIdx.x;
  if (cell < c) {
#pragma unroll
    for (int p = 0; p < BPAR; ++p) {
      if (p < n_b) out[static_cast<long long>(b0 + p) * c + cell] = acc[p];
    }
  }
}

// Lets a kernel take `smem` bytes of dynamic shared memory on the current
// device; the attribute is set once for each larger size, not every call.
template <int BPAR, bool kChunked>
cudaError_t allow_smem(int smem) {
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(lut_field_kernel<BPAR, kChunked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next call
    return err;
  }
  if (dev < kDevices) allowed[dev] = smem;
  return err;
}

// The window of one launch: none (qt is (K, C)), or a win x win window
// of the (K, H, W) table at the (oy0, ox0) ``origin`` holds in device
// memory.
struct Window {
  const int* origin;
  int h, w, win;
};

template <int BPAR, bool kChunked>
cudaError_t launch_as(const signed char* qt, const float* s, int b, int k,
                      int nq, int c, int threads, int kg, const Window& wd,
                      float* out, cudaStream_t stream) {
  // the LUT slots and the qt tile of one chunk of kg bins
  // (ops/beam_field.py::lut_smem_bytes)
  const int smem =
      static_cast<int>(sizeof(float)) * slot_floats(kg, nq) * BPAR +
      kg * threads;
  const cudaError_t err = allow_smem<BPAR, kChunked>(smem);
  if (err != cudaSuccess) return err;
  const bool windowed = wd.origin != nullptr;
  const bool vec_q = !windowed && c % 16 == 0 && aligned_to(qt, 16);
  // every chunk's rows start on 16 bytes
  const bool vec_s =
      (k * nq) % 4 == 0 && (kg * nq) % 4 == 0 && aligned_to(s, 16);
  const long long plane =
      windowed ? static_cast<long long>(wd.h) * wd.w : static_cast<long long>(c);
  dim3 grid((c + threads - 1) / threads, (b + BPAR - 1) / BPAR);
  lut_field_kernel<BPAR, kChunked><<<grid, threads, smem, stream>>>(
      qt, s, b, k, nq, c, kg, vec_q, vec_s, wd.origin, plane,
      windowed ? wd.w : 0, windowed ? wd.win : 0, out);
  return cudaGetLastError();
}

template <int BPAR>
cudaError_t launch(const signed char* qt, const float* s, int b, int k,
                   int nq, int c, int threads, int kg, const Window& wd,
                   float* out, cudaStream_t stream) {
  return kg < k ? launch_as<BPAR, true>(qt, s, b, k, nq, c, threads, kg, wd,
                                        out, stream)
                : launch_as<BPAR, false>(qt, s, b, k, nq, c, threads, k, wd,
                                         out, stream);
}

int launch_bpar(const signed char* qt, const float* s, int b, int k, int nq,
                int c, int threads, int bpar, int kg, const Window& wd,
                float* out, void* stream) {
  if (b <= 0 || c <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || threads % 16 != 0 || kg <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bpar) {
    case 2:
      return static_cast<int>(
          launch<2>(qt, s, b, k, nq, c, threads, kg, wd, out, st));
    case 4:
      return static_cast<int>(
          launch<4>(qt, s, b, k, nq, c, threads, kg, wd, out, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// threads: the cells a block, a multiple of 16 up to 256; bpar: the b a
// block, 2 or 4 (ops/beam_field.py::lut_tiles); kg: the bins a block
// stages at once (ops/beam_field.py::lut_plan; K or more: all of them).
extern "C" int mcmh_lut_field(const signed char* qt, const float* s, int b,
                              int k, int nq, int c, int threads, int bpar,
                              int kg, float* out, void* stream) {
  return launch_bpar(qt, s, b, k, nq, c, threads, bpar, kg,
                     Window{nullptr, 0, 0, 0}, out, stream);
}

// The field over a win x win window of the (K, H, W) table qt, read in
// place at the (oy0, ox0) that ``origin`` holds in device memory (the
// step's window origin, filter/step.py::_window_origin): the same sums as
// mcmh_lut_field on the window copied out, with C = win * win, but the
// corner is never read on the host, so a captured step replays with each
// scan's own origin.  The caller keeps the window inside the table.
extern "C" int mcmh_lut_field_at(const signed char* qt, const float* s,
                                 int b, int k, int nq, int h, int w, int win,
                                 const int* origin, int threads, int bpar,
                                 int kg, float* out, void* stream) {
  if (origin == nullptr || win <= 0 || win > h || win > w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_bpar(qt, s, b, k, nq, win * win, threads, bpar, kg,
                     Window{origin, h, w, win}, out, stream);
}
