// Front-to-back alpha compositing of 16x16 pixel tiles: the forward of the
// production render path, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sugar_tpu/raster/pallas_composite.py
// `_fwd_kernel` (built by `_make_fwd`, called from `tile_composite` /
// `_tile_composite_fwd`). Inputs and outputs keep that kernel's meanings,
// because the backward of the training path reads them:
//
//   tile_start, tile_count (T,) int32   each tile's unaligned slot range
//                                       [start, start+count) of dup_data;
//                                       ranges are disjoint and inside
//                                       [0, d_pad), as binning lays them out
//   dup_data (ROWS, d_pad) float32      component-major packed dup slots:
//                                       rows 0:2 mean2d, 2:5 conic,
//                                       5 opacity, 6:6+CH color
//   img (T, 256, CH)      sum of w_i * color_i (background added outside)
//   final_t (T, 256)      transmittance after the last included slot
//   n_contrib (T, 256)    COUNT of included slots with alpha > 0
//   entry_p (T, rec, 256) the pixel's UNGATED running product of (1-alpha)
//                         at the entry of chunk k; it keeps multiplying
//                         after the pixel stops. Rows >= nch[t] are not
//                         written.
//   nch (T,)              chunks processed before the tile's early exit
//
// Semantics (pallas_composite.py:185-270): a tile walks the 256-slot
// chunks aligned to GLOBAL 256-slot boundaries that cover its range. Per
// slot, alpha = min(0.99, opacity * exp(power)); the slot is dropped when
// power > 0, alpha < 1/255 or the slot lies outside the tile's range. With
// U_j the chunk-local product of (1 - alpha) (composite_common.cuh), a
// pixel includes slot j while entry_p * U_j >= T_EPS, and the next chunk's
// entry is entry_p * U_last. The tile stops at the first chunk entry at
// which no pixel's entry_p is >= T_EPS. Counts above max_chunks * 256 are
// clipped. Gates are selects, so a NaN conic or opacity on a dropped slot
// cannot reach the outputs.
//
// Design. The work unit is a (tile, chunk) pair, not a tile: chunk c's
// include decisions depend on earlier chunks only through entry_p[c], so
// the deepest tile's chunks run side by side on many SMs instead of in one
// block's serial walk. Four launches on the caller's stream:
//   1. build_items (one block): the pair list, tile-major, from each
//      tile's chunk count.
//   2. fwd_local (one block of 256 threads per pair, one thread per
//      pixel): stages the chunk's 6+CH rows in 9 KiB of shared memory and
//      walks its owned slots once, keeping the local product U, the
//      unscaled color sum L = sum alpha_j U_{j-1} c_j and the count of
//      alpha > 0. If entry_p * U_last >= T_EPS the whole chunk is included
//      and the chunk adds entry_p * L, U_last and the count: most pixels of
//      most chunks need no second walk.
//   3. fwd_scan (one block per tile): entry_p[c+1] = entry_p[c] * U_last,
//      the tile's exit rule (`__syncthreads_count`), and the per-pixel sum
//      of the fully included chunks in chunk order. A pixel crosses T_EPS
//      in exactly one chunk (entry >= T_EPS > entry * U_last); that chunk
//      is recorded. The loop body is a few loads and multiplies, so the
//      deepest tile's 84 steps are short.
//   4. fwd_cross (one block per pair): the pixels whose crossing chunk it
//      is walk the chunk again with their entry_p, up to the first
//      excluded slot, and add the chunk's partial image, transmittance and
//      count to the outputs. Each pixel has one writer: no atomics.
// Every output element is written by one thread, in a fixed order, so two
// launches give bit-identical results.
//
// Resources per block (ptxas, printed by chip_smoke.py): fwd_local and
// fwd_cross stage (6+CH) x 256 floats (9 KiB at CH=3); every sub-kernel
// needs at most 32 registers at CH=3, so the SM's 2,048-thread limit
// (8 blocks) bounds occupancy.
// Scratch from the wrapper: the pair list, CH+1 float planes and one int
// plane of 256 per pair, and one int per pixel (the crossing chunk).
//
// Bound on an H100 SXM: the bytes it must move are the live rows of the
// processed chunks ((6+CH)*4 bytes per slot) plus its outputs, at
// 3.35 TB/s; the operations are 256 x 256 alpha evaluations per processed
// (tile, chunk) pair, each about 20 + 2*CH fp32 operations and one exp.
// At 67 TFLOP/s fp32 the operations bound it. The split does about one
// evaluation per pixel-slot of every chunk a tile's range covers, including
// the chunks past the tile's exit that fwd_local walks before the exit is
// known, plus the crossing pixels' partial second walk; instruction issue,
// not latency, should now bound it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using sugar::kChunk;
using sugar::kTEps;
using sugar::block_pair;
using sugar::Pair;
using sugar::pixel_xy;

// part: per pair, CH planes of L, one plane of U_last (float); npart: one
// plane of counts (int). Plane k of pair i is part[(i*(CH+1) + k)*256 + p].
template <int CH>
__global__ void __launch_bounds__(kChunk) fwd_local(
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    const float* __restrict__ dup, int64_t d_pad, int num_tiles, int tiles_x,
    int max_chunks, const int32_t* __restrict__ first, const int32_t* __restrict__ item_tile,
    float* __restrict__ part, int32_t* __restrict__ npart) {
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
  pixel_xy(pr.t, tiles_x, px, py);

  float u = 1.f;  // local product U_{j-1}
  float acc[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) acc[k] = 0.f;
  int cnt = 0;
  for (int j = j_lo; j < j_hi; ++j) {
    float dx, dy, e;
    const float alpha =
        sugar::slot_alpha(s[0][j], s[1][j], s[2][j], s[3][j], s[4][j], s[5][j], px, py, dx, dy, e);
    if (alpha > 0.f) {
      const float w = alpha * u;
#pragma unroll
      for (int k = 0; k < CH; ++k) acc[k] += w * s[6 + k][j];
      ++cnt;
      u = u * (1.f - alpha);
    }
  }
  const int64_t i = blockIdx.x;
  float* q = part + i * (CH + 1) * kChunk + p;
#pragma unroll
  for (int k = 0; k < CH; ++k) q[k * kChunk] = acc[k];
  q[CH * kChunk] = u;
  npart[i * kChunk + p] = cnt;
}

template <int CH>
__global__ void __launch_bounds__(kChunk) fwd_scan(
    const int32_t* __restrict__ first, const float* __restrict__ part,
    const int32_t* __restrict__ npart, int rec, float* __restrict__ img,
    float* __restrict__ final_t, int32_t* __restrict__ n_contrib,
    float* __restrict__ entry_p, int32_t* __restrict__ nch, int32_t* __restrict__ cross) {
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int i0 = first[t];
  const int n = first[t + 1] - i0;
  float pc = 1.f;    // ungated product at the chunk's entry
  float tfin = 1.f;  // product of the fully included chunks' U_last
  float acc[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) acc[k] = 0.f;
  int ninc = 0;
  int crossed = -1;
  int c = 0;
  for (; c < n; ++c) {
    if (__syncthreads_count(pc >= kTEps) == 0) break;
    entry_p[(static_cast<int64_t>(t) * rec + c) * kChunk + p] = pc;
    const float* q = part + static_cast<int64_t>(i0 + c) * (CH + 1) * kChunk + p;
    const float u = q[CH * kChunk];
    const float pn = pc * u;
    if (pn >= kTEps) {  // every slot of the chunk is included
#pragma unroll
      for (int k = 0; k < CH; ++k) acc[k] += pc * q[k * kChunk];
      tfin *= u;
      ninc += npart[static_cast<int64_t>(i0 + c) * kChunk + p];
    } else if (pc >= kTEps) {
      crossed = c;  // fwd_cross adds this chunk's included prefix
    }
    pc = pn;
  }
  const int64_t pix = static_cast<int64_t>(t) * kChunk + p;
#pragma unroll
  for (int k = 0; k < CH; ++k) img[pix * CH + k] = acc[k];
  final_t[pix] = tfin;
  n_contrib[pix] = ninc;
  cross[pix] = crossed;
  if (p == 0) nch[t] = c;
}

template <int CH>
__global__ void __launch_bounds__(kChunk) fwd_cross(
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    const float* __restrict__ dup, int64_t d_pad, int num_tiles, int tiles_x,
    int max_chunks, int rec, const int32_t* __restrict__ first,
    const int32_t* __restrict__ item_tile, const int32_t* __restrict__ nch,
    const int32_t* __restrict__ cross, const float* __restrict__ entry_p,
    float* __restrict__ img, float* __restrict__ final_t, int32_t* __restrict__ n_contrib) {
  constexpr int kRows = 6 + CH;
  __shared__ float s[kRows][kChunk];
  const Pair pr = block_pair(first, item_tile, num_tiles);
  if (pr.t < 0 || pr.c >= nch[pr.t]) return;
  const int p = threadIdx.x;
  const int64_t pix = static_cast<int64_t>(pr.t) * kChunk + p;
  const bool mine = cross[pix] == pr.c;
  if (__syncthreads_or(mine) == 0) return;
  const sugar::TileRange r = sugar::tile_range(tile_start, tile_count, pr.t, max_chunks);
  sugar::stage_chunk<kRows>(dup, d_pad, (r.c0 + pr.c) * kChunk, s);
  __syncthreads();
  if (!mine) return;
  int j_lo, j_hi;
  sugar::chunk_span(r, pr.c, j_lo, j_hi);
  float px, py;
  pixel_xy(pr.t, tiles_x, px, py);
  const float base = entry_p[(static_cast<int64_t>(pr.t) * rec + pr.c) * kChunk + p];

  float u = 1.f;
  float t_chunk = 1.f;  // U at the last included slot
  float acc[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) acc[k] = 0.f;
  int cnt = 0;
  for (int j = j_lo; j < j_hi; ++j) {
    float dx, dy, e;
    const float alpha =
        sugar::slot_alpha(s[0][j], s[1][j], s[2][j], s[3][j], s[4][j], s[5][j], px, py, dx, dy, e);
    const float un = u * (1.f - alpha);
    if (!(base * un >= kTEps)) break;  // the included slots are a prefix
    if (alpha > 0.f) {
      const float w = alpha * (base * u);
#pragma unroll
      for (int k = 0; k < CH; ++k) acc[k] += w * s[6 + k][j];
      ++cnt;
    }
    t_chunk = un;
    u = un;
  }
#pragma unroll
  for (int k = 0; k < CH; ++k) img[pix * CH + k] += acc[k];
  final_t[pix] *= t_chunk;
  n_contrib[pix] += cnt;
}

template <int CH>
int launch(const int32_t* tile_start, const int32_t* tile_count, const float* dup, int64_t d_pad,
           int num_tiles, int tiles_x, int max_chunks, int rec, int capacity, float* img,
           float* final_t, int32_t* n_contrib, float* entry_p, int32_t* nch, int32_t* first,
           int32_t* item_tile, int32_t* cross, int32_t* npart, float* part, cudaStream_t st) {
  sugar::build_items<<<1, sugar::kBuildThreads, 0, st>>>(
      tile_start, tile_count, nullptr, num_tiles, max_chunks, capacity, first, item_tile);
  if (const int err = sugar::last_error()) return err;
  fwd_local<CH><<<capacity, kChunk, 0, st>>>(tile_start, tile_count, dup, d_pad, num_tiles,
                                             tiles_x, max_chunks, first, item_tile, part, npart);
  if (const int err = sugar::last_error()) return err;
  fwd_scan<CH><<<num_tiles, kChunk, 0, st>>>(first, part, npart, rec, img, final_t, n_contrib,
                                             entry_p, nch, cross);
  if (const int err = sugar::last_error()) return err;
  fwd_cross<CH><<<capacity, kChunk, 0, st>>>(tile_start, tile_count, dup, d_pad, num_tiles,
                                             tiles_x, max_chunks, rec, first, item_tile, nch,
                                             cross, entry_p, img, final_t, n_contrib);
  return sugar::last_error();
}

}  // namespace

// Launches the four kernels on `stream` and returns the first nonzero
// cudaGetLastError() (0 on success). ch must be 1..4; capacity >= 1 pairs.
// Scratch (the wrapper's torch.empty): first (T+1) and item_tile
// (capacity) int32, cross (T*256) int32, npart (capacity*256) int32, part
// (capacity*(ch+1)*256) float32. The Python wrapper checks every argument.
extern "C" int sugar_tile_composite_fwd(
    const void* tile_start, const void* tile_count, const void* dup_data, long long d_pad,
    int num_tiles, int tiles_x, int ch, int max_chunks, int rec, int capacity, void* img,
    void* final_t, void* n_contrib, void* entry_p, void* nch, void* first, void* item_tile,
    void* cross, void* npart, void* part, void* stream) {
  if (num_tiles <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* x) { return static_cast<const int32_t*>(x); };
  auto o32 = [](void* x) { return static_cast<int32_t*>(x); };
  auto f32 = [](void* x) { return static_cast<float*>(x); };
  const auto* dup = static_cast<const float*>(dup_data);
#define SUGAR_ARGS                                                                             \
  i32(tile_start), i32(tile_count), dup, d_pad, num_tiles, tiles_x, max_chunks, rec, capacity, \
      f32(img), f32(final_t), o32(n_contrib), f32(entry_p), o32(nch), o32(first),               \
      o32(item_tile), o32(cross), o32(npart), f32(part), st
  switch (ch) {
    case 1: return launch<1>(SUGAR_ARGS);
    case 2: return launch<2>(SUGAR_ARGS);
    case 3: return launch<3>(SUGAR_ARGS);
    case 4: return launch<4>(SUGAR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SUGAR_ARGS
}
