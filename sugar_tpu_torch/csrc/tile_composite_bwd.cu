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
// Design. The work unit is a (tile, chunk < nch) pair: chunk c needs the
// later chunks only through the per-pixel carry T_fin * gt_total +
// sum_{k>c} total_k, where total_k is chunk k's sum of w (c . g). Each
// slot lies in one tile's range and one chunk, so a pair owns its slots'
// gradient columns. Three launches on the caller's stream:
//   1. build_items (one block): the pair list, tile-major, from nch.
//   2. bwd_total (one block of 256 threads per pair, one thread per
//      pixel): recomputes the chunk forward from K1's entry_p with K1's
//      alpha code and product order (entry_p * U_j, composite_common.cuh),
//      so the include decisions are K1's bit for bit, and stores total_c
//      per pixel. A pixel stops at its first excluded slot.
//   3. bwd_grad (one block per pair): adds the later chunks' totals in
//      reverse chunk order, the order of the serial walk, then recomputes
//      the chunk and computes each slot's 6+CH per-pixel terms with the
//      running suffix (total - cumsum) + carry. The terms are summed over
//      the tile's 256 pixels in two levels: inside a warp, a reduce-scatter
//      over groups of 4 slots per row (3 exchange shuffles leave each of 4
//      lane groups one slot's sum over 8 lanes, 3 more finish it: 6
//      shuffles per 4 values, where a tree per value takes 20), skipped when
//      no lane of the warp includes a slot of the group or every lane is
//      past its last included slot; across warps, the 8 warp partials of
//      each 32-slot window go through 9 KiB of shared memory and are added
//      in warp order by one thread per (row, slot), which makes the one
//      store. No atomics; the result is deterministic.
//
// Resources per block (ptxas, printed by chip_smoke.py): bwd_total stages
// (6+CH) x 256 floats (9 KiB at CH=3); bwd_grad that plus the (8, 6+CH,
// 32) window of warp partials (18 KiB in all), so shared memory allows
// 12 blocks per SM; registers (the 4 x (6+CH) terms of a group) bound it
// first, at the 3 blocks per SM that __launch_bounds__ asks for.
//
// Bound on an H100 SXM: operations, as for the forward. Each processed
// (tile, chunk) pair costs up to two alpha evaluations per (pixel, slot)
// (about 50 + 4*CH fp32 operations with the gradient terms, chip_smoke.py's
// `_ops_per_eval_bwd`), against bytes of dup_data, entry_p, the
// cotangents and d_out read or written once. With the serial walk gone,
// instruction issue (the recomputation, the division, the reduction's
// shuffles and selects) bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using sugar::kChunk;
using sugar::kTEps;
using sugar::block_pair;
using sugar::Pair;

constexpr int kWarps = kChunk / 32;
constexpr int kGroup = 4;    // slots per warp reduce-scatter
constexpr int kWindow = 32;  // slots per flush of the warp partials

// Sums v[0..kGroup) over the warp's 32 lanes: on return v[0] holds, in
// every lane, the sum of value (lane >> 3) & 3. Halving exchanges at
// offsets 16 and 8 (each lane keeps the half its lane bit selects), then a
// tree over offsets 4, 2, 1.
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[kGroup], int lane) {
  static_assert(kGroup == 4, "the exchanges below are written for 4 values");
  constexpr unsigned kAll = 0xffffffffu;
  const bool up16 = lane & 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up16 ? v[i] : v[i + 2];
    const float keep = up16 ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kAll, send, 16);
  }
  const bool up8 = lane & 8;
  const float send = up8 ? v[0] : v[1];
  v[0] = (up8 ? v[1] : v[0]) + __shfl_xor_sync(kAll, send, 8);
  v[0] += __shfl_xor_sync(kAll, v[0], 4);
  v[0] += __shfl_xor_sync(kAll, v[0], 2);
  v[0] += __shfl_xor_sync(kAll, v[0], 1);
}

template <int CH>
__global__ void __launch_bounds__(kChunk) bwd_total(
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    const float* __restrict__ dup, int64_t d_pad, int num_tiles, int tiles_x, int max_chunks,
    int rec, const int32_t* __restrict__ first, const int32_t* __restrict__ item_tile,
    const float* __restrict__ g_img, const float* __restrict__ entry_p,
    float* __restrict__ tot) {
  constexpr int kRows = 6 + CH;
  __shared__ float s[kRows][kChunk];
  const Pair pr = block_pair(first, item_tile, num_tiles);
  if (pr.t < 0) return;
  const int p = threadIdx.x;
  const sugar::TileRange r = sugar::tile_range(tile_start, tile_count, pr.t, max_chunks);
  sugar::stage_chunk<kRows>(dup, d_pad, (r.c0 + pr.c) * kChunk, s);
  __syncthreads();
  int j_lo, j_hi;
  sugar::chunk_span(r, pr.c, j_lo, j_hi);
  float px, py;
  sugar::pixel_xy(pr.t, tiles_x, px, py);
  const int64_t pix = static_cast<int64_t>(pr.t) * kChunk + p;
  float g[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) g[k] = g_img[pix * CH + k];
  const float base = entry_p[(static_cast<int64_t>(pr.t) * rec + pr.c) * kChunk + p];

  float u = 1.f;
  float total = 0.f;
  for (int j = j_lo; j < j_hi; ++j) {
    if (!(base * u >= kTEps)) break;  // no later slot is included
    float dx, dy, e;
    const float alpha =
        sugar::slot_alpha(s[0][j], s[1][j], s[2][j], s[3][j], s[4][j], s[5][j], px, py, dx, dy, e);
    const float un = u * (1.f - alpha);
    const float a_eff = base * un >= kTEps ? alpha : 0.f;
    float cdotg = 0.f;
#pragma unroll
    for (int k = 0; k < CH; ++k) cdotg += g[k] * s[6 + k][j];
    total += (a_eff * (base * u)) * cdotg;
    u = un;
  }
  tot[static_cast<int64_t>(blockIdx.x) * kChunk + p] = total;
}

template <int CH>
__global__ void __launch_bounds__(kChunk, 3) bwd_grad(
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    const float* __restrict__ dup, int64_t d_pad, int num_tiles, int tiles_x, int max_chunks,
    int rec, const int32_t* __restrict__ first, const int32_t* __restrict__ item_tile,
    const float* __restrict__ g_img, const float* __restrict__ gt_total,
    const float* __restrict__ t_fin, const float* __restrict__ entry_p,
    const float* __restrict__ tot, float* __restrict__ d_out) {
  constexpr int kRows = 6 + CH;
  __shared__ float s[kRows][kChunk];
  // part[w][r][j]: warp w's sum over its 32 pixels of row r, window slot j.
  __shared__ float part[kWarps][kRows][kWindow];
  const Pair pr = block_pair(first, item_tile, num_tiles);
  if (pr.t < 0) return;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int i0 = first[pr.t];
  const int n = first[pr.t + 1] - i0;
  const int64_t pix = static_cast<int64_t>(pr.t) * kChunk + p;

  // The suffix from later chunks, added in the serial walk's order.
  float carry = t_fin[pix] * gt_total[pix];
  for (int k = n - 1; k > pr.c; --k) carry += tot[static_cast<int64_t>(i0 + k) * kChunk + p];
  const float total = tot[static_cast<int64_t>(blockIdx.x) * kChunk + p];

  const sugar::TileRange r = sugar::tile_range(tile_start, tile_count, pr.t, max_chunks);
  const int64_t slot0 = (r.c0 + pr.c) * kChunk;
  sugar::stage_chunk<kRows>(dup, d_pad, slot0, s);
  __syncthreads();
  int j_lo, j_hi;
  sugar::chunk_span(r, pr.c, j_lo, j_hi);
  float px, py;
  sugar::pixel_xy(pr.t, tiles_x, px, py);
  float g[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) g[k] = g_img[pix * CH + k];
  const float base = entry_p[(static_cast<int64_t>(pr.t) * rec + pr.c) * kChunk + p];

  float u = 1.f;
  float cum = 0.f;
  for (int w0 = j_lo & ~(kWindow - 1); w0 < j_hi; w0 += kWindow) {
#pragma unroll 1
    for (int g0 = w0; g0 < w0 + kWindow; g0 += kGroup) {
      float v[kRows][kGroup];
      bool act_any = false;
      // Warp-uniform: skip the group when every lane is past its last
      // included slot (entry_p * U only falls) or the group is unowned.
      const bool live = g0 + kGroup > j_lo && g0 < j_hi &&
                        __any_sync(0xffffffffu, base * u >= kTEps);
      if (live) {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int j = g0 + q;
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) v[rr][q] = 0.f;
          if (j < j_lo || j >= j_hi) continue;
          float dx, dy, e;
          const float op = s[5][j];
          const float alpha =
              sugar::slot_alpha(s[0][j], s[1][j], s[2][j], s[3][j], s[4][j], op, px, py, dx, dy, e);
          const float un = u * (1.f - alpha);
          const float a_eff = base * un >= kTEps ? alpha : 0.f;
          const float t_in = base * u;
          const float w = a_eff * t_in;
          float cdotg = 0.f;
#pragma unroll
          for (int k = 0; k < CH; ++k) cdotg += g[k] * s[6 + k][j];
          cum += w * cdotg;
          const float suffix = (total - cum) + carry;
          const bool act = a_eff > 0.f;
          const float one_m_a = fmaxf(1.f - a_eff, sugar::kOneMinusClamp);
          const float dalpha = act ? (t_in * cdotg - suffix / one_m_a) : 0.f;
          u = un;
          act_any |= act;
          const float dpower = dalpha * op * e;
          const float ca = s[2][j], cb = s[3][j], cc = s[4][j];
          v[0][q] = act ? dpower * -(ca * dx + cb * dy) : 0.f;
          v[1][q] = act ? dpower * -(cc * dy + cb * dx) : 0.f;
          v[2][q] = act ? dpower * (-0.5f * dx * dx) : 0.f;
          v[3][q] = act ? dpower * -(dx * dy) : 0.f;
          v[4][q] = act ? dpower * (-0.5f * dy * dy) : 0.f;
          v[5][q] = act ? dalpha * e : 0.f;
#pragma unroll
          for (int k = 0; k < CH; ++k) v[6 + k][q] = g[k] * w;
        }
      }
      const int slot = g0 - w0 + ((lane >> 3) & (kGroup - 1));
      if (__any_sync(0xffffffffu, act_any)) {
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          warp_reduce_scatter(v[rr], lane);
          if ((lane & 7) == 0) part[warp][rr][slot] = v[rr][0];
        }
      } else if ((lane & 7) == 0) {
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) part[warp][rr][slot] = 0.f;
      }
    }
    __syncthreads();
    // One thread per (row, window slot): the 8 warp partials in warp
    // order, one store for each slot the tile owns.
    for (int idx = p; idx < kRows * kWindow; idx += kChunk) {
      const int rr = idx / kWindow;
      const int jj = idx % kWindow;
      const int j = w0 + jj;
      if (j < j_lo || j >= j_hi || slot0 + j >= d_pad) continue;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += part[w][rr][jj];
      d_out[rr * d_pad + slot0 + j] = acc;
    }
    __syncthreads();
  }
}

template <int CH>
int launch(const int32_t* tile_start, const int32_t* tile_count, const int32_t* nch,
           const float* dup, int64_t d_pad, int num_tiles, int tiles_x, int max_chunks, int rec,
           int capacity, const float* g_img, const float* gt_total, const float* t_fin,
           const float* entry_p, float* d_out, int32_t* first, int32_t* item_tile, float* tot,
           cudaStream_t st) {
  sugar::build_items<<<1, sugar::kBuildThreads, 0, st>>>(
      tile_start, tile_count, nch, num_tiles, max_chunks, capacity, first, item_tile);
  if (const int err = sugar::last_error()) return err;
  bwd_total<CH><<<capacity, kChunk, 0, st>>>(tile_start, tile_count, dup, d_pad, num_tiles,
                                             tiles_x, max_chunks, rec, first, item_tile, g_img,
                                             entry_p, tot);
  if (const int err = sugar::last_error()) return err;
  bwd_grad<CH><<<capacity, kChunk, 0, st>>>(tile_start, tile_count, dup, d_pad, num_tiles,
                                            tiles_x, max_chunks, rec, first, item_tile, g_img,
                                            gt_total, t_fin, entry_p, tot, d_out);
  return sugar::last_error();
}

}  // namespace

// Launches the three kernels on `stream` and returns the first nonzero
// cudaGetLastError() (0 on success). ch must be 1..4; d_out must be
// zero-filled (rows >= 6+ch, d_pad); capacity >= 1 pairs. Scratch (the
// wrapper's torch.empty): first (T+1) and item_tile (capacity) int32, tot
// (capacity*256) float32. The Python wrapper checks every argument.
extern "C" int sugar_tile_composite_bwd(
    const void* tile_start, const void* tile_count, const void* nch, const void* dup_data,
    long long d_pad, int num_tiles, int tiles_x, int ch, int max_chunks, int rec, int capacity,
    const void* g_img, const void* gt_total, const void* t_fin, const void* entry_p,
    void* d_out, void* first, void* item_tile, void* tot, void* stream) {
  if (num_tiles <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* x) { return static_cast<const int32_t*>(x); };
  auto f32 = [](const void* x) { return static_cast<const float*>(x); };
#define SUGAR_ARGS                                                                              \
  i32(tile_start), i32(tile_count), i32(nch), f32(dup_data), d_pad, num_tiles, tiles_x,         \
      max_chunks, rec, capacity, f32(g_img), f32(gt_total), f32(t_fin), f32(entry_p),           \
      static_cast<float*>(d_out), static_cast<int32_t*>(first), static_cast<int32_t*>(item_tile), \
      static_cast<float*>(tot), st
  switch (ch) {
    case 1: return launch<1>(SUGAR_ARGS);
    case 2: return launch<2>(SUGAR_ARGS);
    case 3: return launch<3>(SUGAR_ARGS);
    case 4: return launch<4>(SUGAR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SUGAR_ARGS
}
