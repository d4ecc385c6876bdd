// Correlation-field build for the corr scorer (models/corr_field.py).
//
//   F[k, y, x] = sum_j padded[y + oy[k, j], x + ox[k, j]]     (K, h, w) f32
//
// Replaces mcmh_localization_tpu/ops/corr_field_pallas.py::corr_field_pallas
// (the TPU build of the full-map BIG field) and, on this card, also the
// SMALL program's windowed build (models/corr_field.py::_build_field_dft on
// the TPU) and the coarse fallback field: the callers slice the window
// region or pool the coarse table first, so one kernel serves all three.
// Invalid beams point at the all-zero band, the last h rows of ``padded``
// (rows from zero_row = Hp - h on): adding those rows adds +0.0, which
// leaves a sum that starts at +0.0 unchanged, so the kernel skips them.
//
// Bound: K*h*w*M_valid adds, one 4-byte table value each, M_valid the
// beams inside max_range; at K=120, 384^2 the f32 rate and the 70.8 MB
// output bound it about equally.  What holds it back is L1: every add
// needs its own table value, and a warp's load of 32 neighbouring values
// costs one or two 128-byte wavefronts where the FP32 pipe would take four
// warp-wide adds.
// The design:
//  - each warp builds one theta bin, four bins per block over one spatial
//    tile, so the tile's table rows are shared in L1 across the bins;
//  - each thread makes kRunX x RY outputs (columns 32 apart, so each of a
//    warp's loads is one coalesced row segment, RY rows down), so one
//    staged offset, one address and the loop cost serve kRunX * RY adds;
//  - the warp stages its bin's offsets in shared memory as flat offsets
//    oy*wp + ox, compacting out the invalid beams with a ballot (order is
//    kept), so the inner loop is one shared read, kRunX * RY loads and
//    adds and no branch;
//  - the beams arrive ordered by (oy, ox) (models/corr_field.py::
//    _bin_offsets), so consecutive beams read neighbouring rows.
// The only load a thread could keep from one beam for the next in this
// layout is a repeated offset (0.40 of the coarse field's consecutive
// valid beams, under 0.01 at the full-map and window fields; chip_smoke.py
// prints the shares).  A branch that skipped those loads made the build
// 35% slower at the full-map field and 60% at the window (most likely
// because the loads of consecutive beams no longer overlap) and 3% faster
// at the coarse field (H100 80GB HBM3 at 700 W), so the inner loop has no
// branch.
// Sums run over the valid beams in the given order from 0.0 with
// round-to-nearest adds and no contraction: bitwise the plain PyTorch
// version's sum over all beams in that order.
//
// The SMALL program's window: the build reads its region in place inside
// the whole padded table, at the (oy0, ox0) cell origin
// the step computes on the card (filter/step.py::_window_origin), read
// from device memory by every block; the beams at or past `zero_row` (the
// padded table's height, where the JAX package's zero band starts) are
// the invalid ones.  So the window needs no slice or copy placed by the
// host, and a captured step replays with each scan's own origin.  (The
// earlier form sliced the region out on the host, with the zero band
// appended: origin null, zero_row = hp - h.)

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;    // theta bins per block, one warp each
constexpr int kRunX = 4;     // columns per thread, 32 apart
constexpr int kStage = 512;  // offsets staged per warp per pass

template <int RY>
__global__ void __launch_bounds__(kWarps * 32)
corr_field_build_kernel(const float* __restrict__ padded, int wp,
                        int zero_row, const int* __restrict__ ox,
                        const int* __restrict__ oy, int k_bins, int m,
                        float* __restrict__ out, int h, int w,
                        const int* __restrict__ origin) {
  __shared__ int s_off[kWarps][kStage];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.z * kWarps + warp;
  if (k >= k_bins) return;  // the warps never meet at a block barrier
  const int xb = blockIdx.x * (32 * kRunX);
  const int y0 = blockIdx.y * RY;
  // warp-uniform: the tile lies inside the field, no clamping
  const bool full = xb + 32 * kRunX <= w && y0 + RY <= h;
  // the window's corner inside the padded table (0 for a whole table)
  const int corner =
      origin != nullptr ? __ldg(origin) * wp + __ldg(origin + 1) : 0;
  int idx[RY][kRunX];  // read index of each output, clamped at the edge
#pragma unroll
  for (int r = 0; r < RY; ++r) {
#pragma unroll
    for (int i = 0; i < kRunX; ++i) {
      idx[r][i] = corner + min(y0 + r, h - 1) * wp +
                  min(xb + lane + 32 * i, w - 1);
    }
  }
  float acc[RY][kRunX];
#pragma unroll
  for (int r = 0; r < RY; ++r) {
#pragma unroll
    for (int i = 0; i < kRunX; ++i) acc[r][i] = 0.0f;
  }
  const int* oxk = ox + static_cast<long long>(k) * m;
  const int* oyk = oy + static_cast<long long>(k) * m;
  int* so = s_off[warp];
  for (int j0 = 0; j0 < m; j0 += kStage) {
    const int jn = min(kStage, m - j0);
    int n = 0;
    for (int t = 0; t < jn; t += 32) {
      bool live = false;
      int off = 0;
      if (t + lane < jn) {
        const int yy = oyk[j0 + t + lane];
        live = yy < zero_row;
        off = yy * wp + oxk[j0 + t + lane];
      }
      const unsigned int mask = __ballot_sync(0xffffffffu, live);
      if (live) so[n + __popc(mask & ((1u << lane) - 1u))] = off;
      n += __popc(mask);
    }
    __syncwarp();
    if (full) {
      const float* base = padded + idx[0][0];
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const float* q = base + so[t];
#pragma unroll
        for (int r = 0; r < RY; ++r) {
#pragma unroll
          for (int i = 0; i < kRunX; ++i) {
            acc[r][i] = __fadd_rn(acc[r][i], __ldg(q + r * wp + 32 * i));
          }
        }
      }
    } else {
#pragma unroll 2
      for (int t = 0; t < n; ++t) {
        const int off = so[t];
#pragma unroll
        for (int r = 0; r < RY; ++r) {
#pragma unroll
          for (int i = 0; i < kRunX; ++i) {
            acc[r][i] = __fadd_rn(acc[r][i], __ldg(padded + off + idx[r][i]));
          }
        }
      }
    }
    __syncwarp();  // the next pass overwrites the staged offsets
  }
#pragma unroll
  for (int r = 0; r < RY; ++r) {
#pragma unroll
    for (int i = 0; i < kRunX; ++i) {
      const int y = y0 + r;
      const int x = xb + lane + 32 * i;
      if (y < h && x < w) {
        out[(static_cast<long long>(k) * h + y) * w + x] = acc[r][i];
      }
    }
  }
}

template <int RY>
cudaError_t launch(const float* padded, int wp, int zero_row, const int* ox,
                   const int* oy, int k, int m, float* out, int h, int w,
                   const int* origin, cudaStream_t stream) {
  dim3 grid((w + 32 * kRunX - 1) / (32 * kRunX), (h + RY - 1) / RY,
            (k + kWarps - 1) / kWarps);
  corr_field_build_kernel<RY><<<grid, kWarps * 32, 0, stream>>>(
      padded, wp, zero_row, ox, oy, k, m, out, h, w, origin);
  return cudaGetLastError();
}

}  // namespace

// zero_row: beams with oy >= zero_row are invalid and skipped; origin:
// the (oy0, ox0) corner of the h x w window in `padded`, two ints in device
// memory (null: the corner is (0, 0))
extern "C" int mcmh_corr_field_build(const float* padded, int hp, int wp,
                                     const int* ox, const int* oy, int k,
                                     int m, float* out, int h, int w,
                                     int zero_row, const int* origin,
                                     void* stream) {
  (void)hp;
  if (k <= 0 || h <= 0 || w <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // two rows per thread where the grid stays large (the full-map field),
  // one where it would leave SMs idle (the window and coarse fields)
  const cudaError_t err =
      h * w >= 65536
          ? launch<2>(padded, wp, zero_row, ox, oy, k, m, out, h, w, origin, s)
          : launch<1>(padded, wp, zero_row, ox, oy, k, m, out, h, w, origin,
                      s);
  return static_cast<int>(err);
}

extern "C" const char* mcmh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
