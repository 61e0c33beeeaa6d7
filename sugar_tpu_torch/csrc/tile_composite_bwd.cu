// Backward of the per-tile alpha compositing, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sugar_tpu/raster/pallas_composite.py
// `_bwd_kernel` (built by `_make_bwd`, called from `_tile_composite_bwd`).
// It reads the forward kernel's (tile_composite.cu) records:
//
//   tile_start, tile_count (T,) int32   each tile's unaligned slot range;
//                                       counts clipped to max_chunks * 256
//   nch (T,) int32                      chunks the forward processed
//   dup_data (ROWS, d_pad) float32      the packed dup slots (rows 0:2
//                                       mean2d, 2:5 conic, 5 opacity,
//                                       6:6+CH color)
//   g_img (T, 256, CH)                  cotangent of the tile images
//   gt_total (T, 256)                   g_T + g_img . bg (cotangent of
//                                       final_T, background folded in)
//   t_fin (T, 256), entry_p (T, rec, 256)  the forward's final_T and the
//                                       ungated running product at each
//                                       processed chunk's entry
//   d_out (ROWS, d_pad) float32         ZERO-initialized by the caller;
//                                       rows 0:6+CH of each slot a tile
//                                       owns in a processed chunk get
//                                       d mean2d, d conic, d opacity,
//                                       d color. Other slots stay 0.
//
// Math (pallas_composite.py:317-399): with t_in the transmittance before
// slot i, w = a_eff * t_in, and the suffix S_i = sum_{j>i} w_j (c_j . g) +
// T_fin * gt_total,  dL/dalpha_i = t_in (c_i . g) - S_i / max(1 - a_eff,
// 0.01). The 0.99 clamp passes the gradient straight through
// (d opacity = dalpha * e even when clamped); no gradient flows through the
// 1/255 cutoff or the T_EPS stop; gated accumulations are selects, so a NaN
// conic or opacity on a dropped slot gives 0.
//
// Design: one block per tile, 256 threads, one thread per pixel; the
// tile's processed chunks are walked in reverse (the suffix carry S flows
// from the back). Inside a chunk each pixel recomputes the forward in
// slot order from entry_p with the forward's own alpha code
// (composite_common.cuh) and product order, so its include decisions are
// the forward's, bit for bit: dividing T back by (1 - alpha) could flip
// the last included slot. Two passes per chunk, as the TPU's
// `total - inclusive cumsum` suffix: the first sums w (c . g) over the
// chunk, the second computes the gradients with a running subtraction.
// Each slot's 6+CH per-pixel terms are summed over the tile's 256 pixels:
// a warp-shuffle reduction per warp (skipped when no pixel of the warp
// includes the slot), one partial per warp in shared memory, and then
// each thread adds the 8 warp partials of one slot in a fixed order and
// makes one store. A slot belongs to exactly one tile's range, so no two
// blocks store to one slot: no atomics, and the result is deterministic.
//
// Bound on an H100 SXM: operations, as for the forward. Each processed
// (tile, chunk) pair costs two alpha evaluations per (pixel, slot) (about
// 50 + 4*CH fp32 operations with the gradient terms, chip_smoke.py's
// `_ops_per_eval_bwd`), against bytes of dup_data, entry_p, the
// cotangents and d_out read or written once. This first version makes no
// attempt at that bound (recomputation twice per chunk, a shuffle tree per
// slot and row, full-precision expf and division).

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using sugar::kChunk;
using sugar::kTEps;
using sugar::kTile;

constexpr int kWarps = kChunk / 32;

template <int CH>
constexpr int smem_bytes() {
  return (6 + CH) * kChunk * 4 * (1 + kWarps);
}

template <int CH>
__global__ void __launch_bounds__(kChunk) tile_composite_bwd_kernel(
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ nch,
    const float* __restrict__ dup,
    int64_t d_pad, int tiles_x, int max_chunks, int rec,
    const float* __restrict__ g_img, const float* __restrict__ gt_total,
    const float* __restrict__ t_fin, const float* __restrict__ entry_p,
    float* __restrict__ d_out) {
  constexpr int kRows = 6 + CH;
  extern __shared__ float smem[];
  float(*s)[kChunk] = reinterpret_cast<float(*)[kChunk]>(smem);
  // part[w][r][j]: warp w's sum over its 32 pixels of row r for slot j.
  float(*part)[kRows][kChunk] =
      reinterpret_cast<float(*)[kRows][kChunk]>(smem + kRows * kChunk);

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int64_t start = tile_start[t];
  const int count = min(tile_count[t], max_chunks * kChunk);
  const int64_t end = start + count;
  const int64_t c0 = start / kChunk;
  const int n_chunks = nch[t];
  const float px = static_cast<float>((t % tiles_x) * kTile + p % kTile);
  const float py = static_cast<float>((t / tiles_x) * kTile + p / kTile);

  const int64_t pix = static_cast<int64_t>(t) * kChunk + p;
  float g[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) g[k] = g_img[pix * CH + k];
  float carry = t_fin[pix] * gt_total[pix];  // suffix from later chunks

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int64_t slot0 = (c0 + c) * kChunk;
    const int64_t mine = slot0 + p;
    __syncthreads();  // the previous chunk's readers of s and part are done
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r][p] = mine < d_pad ? dup[r * d_pad + mine] : 0.f;
    }
    __syncthreads();
    const float base_p = entry_p[(static_cast<int64_t>(t) * rec + c) * kChunk + p];
    const int64_t lo = start - slot0;
    const int64_t hi = end - slot0;
    const int j_lo = lo > 0 ? static_cast<int>(lo) : 0;
    const int j_hi = hi < kChunk ? static_cast<int>(hi) : kChunk;

    // Pass 1: the chunk's total of w (c . g).
    float pc = base_p;
    float total = 0.f;
    for (int j = j_lo; j < j_hi; ++j) {
      float dx, dy, e;
      const float alpha =
          sugar::slot_alpha(s[0][j], s[1][j], s[2][j], s[3][j], s[4][j], s[5][j], px, py,
                            dx, dy, e);
      const float pn = pc * (1.f - alpha);
      const float a_eff = pn >= kTEps ? alpha : 0.f;
      float cdotg = 0.f;
#pragma unroll
      for (int k = 0; k < CH; ++k) cdotg += g[k] * s[6 + k][j];
      total += (a_eff * pc) * cdotg;
      pc = pn;
    }

    // Pass 2: the gradients, slot by slot, reduced over the tile's pixels.
    pc = base_p;
    float cum = 0.f;
    for (int j = j_lo; j < j_hi; ++j) {
      float dx, dy, e;
      const float op = s[5][j];
      const float alpha =
          sugar::slot_alpha(s[0][j], s[1][j], s[2][j], s[3][j], s[4][j], op, px, py,
                            dx, dy, e);
      const float pn = pc * (1.f - alpha);
      const float a_eff = pn >= kTEps ? alpha : 0.f;
      const float t_in = pc;
      const float w = a_eff * t_in;
      float cdotg = 0.f;
#pragma unroll
      for (int k = 0; k < CH; ++k) cdotg += g[k] * s[6 + k][j];
      const float wc = w * cdotg;
      cum += wc;
      const float suffix = (total - cum) + carry;
      const bool act = a_eff > 0.f;
      const float one_m_a = fmaxf(1.f - a_eff, sugar::kOneMinusClamp);
      const float dalpha = act ? (t_in * cdotg - suffix / one_m_a) : 0.f;
      pc = pn;

      float v[kRows];
      const float dpower = dalpha * op * e;
      const float ca = s[2][j], cb = s[3][j], cc = s[4][j];
      v[0] = act ? dpower * -(ca * dx + cb * dy) : 0.f;
      v[1] = act ? dpower * -(cc * dy + cb * dx) : 0.f;
      v[2] = act ? dpower * (-0.5f * dx * dx) : 0.f;
      v[3] = act ? dpower * -(dx * dy) : 0.f;
      v[4] = act ? dpower * (-0.5f * dy * dy) : 0.f;
      v[5] = act ? dalpha * e : 0.f;
#pragma unroll
      for (int k = 0; k < CH; ++k) v[6 + k] = g[k] * w;

      if (__any_sync(0xffffffffu, act)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v[r] += __shfl_down_sync(0xffffffffu, v[r], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) part[warp][r][j] = v[r];
        }
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[warp][r][j] = 0.f;
      }
    }
    carry += total;

    __syncthreads();
    // Thread p stores slot j = p of the chunk when its tile owns it.
    if (p >= j_lo && p < j_hi && mine < d_pad) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += part[w][r][p];
        d_out[r * d_pad + mine] = acc;
      }
    }
  }
}

template <int CH>
int launch(const void* tile_start, const void* tile_count, const void* nch,
           const void* dup, int64_t d_pad, int num_tiles, int tiles_x,
           int max_chunks, int rec, const void* g_img, const void* gt_total,
           const void* t_fin, const void* entry_p, void* d_out,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<CH>();
  cudaError_t err = cudaFuncSetAttribute(tile_composite_bwd_kernel<CH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_composite_bwd_kernel<CH><<<num_tiles, kChunk, bytes, stream>>>(
      static_cast<const int32_t*>(tile_start),
      static_cast<const int32_t*>(tile_count), static_cast<const int32_t*>(nch),
      static_cast<const float*>(dup), d_pad, tiles_x, max_chunks, rec,
      static_cast<const float*>(g_img), static_cast<const float*>(gt_total),
      static_cast<const float*>(t_fin), static_cast<const float*>(entry_p),
      static_cast<float*>(d_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns a CUDA error code (0 on
// success). ch must be 1..4; d_out must be zero-filled (rows >= 6+ch,
// d_pad); the Python wrapper checks every argument.
extern "C" int sugar_tile_composite_bwd(
    const void* tile_start, const void* tile_count, const void* nch,
    const void* dup_data, long long d_pad, int num_tiles, int tiles_x, int ch,
    int max_chunks, int rec, const void* g_img, const void* gt_total,
    const void* t_fin, const void* entry_p, void* d_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return 0;
  switch (ch) {
    case 1:
      return launch<1>(tile_start, tile_count, nch, dup_data, d_pad, num_tiles, tiles_x,
                       max_chunks, rec, g_img, gt_total, t_fin, entry_p, d_out, st);
    case 2:
      return launch<2>(tile_start, tile_count, nch, dup_data, d_pad, num_tiles, tiles_x,
                       max_chunks, rec, g_img, gt_total, t_fin, entry_p, d_out, st);
    case 3:
      return launch<3>(tile_start, tile_count, nch, dup_data, d_pad, num_tiles, tiles_x,
                       max_chunks, rec, g_img, gt_total, t_fin, entry_p, d_out, st);
    case 4:
      return launch<4>(tile_start, tile_count, nch, dup_data, d_pad, num_tiles, tiles_x,
                       max_chunks, rec, g_img, gt_total, t_fin, entry_p, d_out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
