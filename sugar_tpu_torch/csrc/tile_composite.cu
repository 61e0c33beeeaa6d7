// Front-to-back alpha compositing of 16x16 pixel tiles: the forward of the
// production render path, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sugar_tpu/raster/pallas_composite.py
// `_fwd_kernel` (built by `_make_fwd`, called from `tile_composite` /
// `_tile_composite_fwd`). Inputs and outputs keep that kernel's meanings,
// because the backward of the training path reads them:
//
//   tile_start, tile_count (T,) int32   each tile's unaligned slot range
//                                       [start, start+count) of dup_data
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
// Semantics (pallas_composite.py:138-270): a tile walks the 256-slot
// chunks aligned to GLOBAL 256-slot boundaries that cover its range, so
// n_chunks = cdiv(end, 256) - start / 256. Per slot, alpha =
// min(0.99, opacity * exp(power)); the slot is dropped when power > 0,
// alpha < 1/255 or the slot lies outside the tile's range. A pixel
// includes a slot while its running product after the slot stays >= T_EPS;
// exclusion is permanent. The tile stops at the first chunk entry at which
// no pixel's running product is >= T_EPS. Counts above max_chunks * 256
// are clipped (the nearest slots are kept), as the JAX caller clips them.
// Gates are selects, never multiplications, so a NaN conic or opacity on
// a dropped slot cannot reach the outputs.
//
// Design: one block per tile, 256 threads, one thread per pixel. For each
// chunk the block loads the chunk's 6+CH live rows into shared memory
// (component-major rows, so every row's load is one coalesced 1 KiB read),
// then each thread walks the slots of its tile's range in order, keeping
// transmittance and color in registers. `__syncthreads_count` is both the
// barrier that frees shared memory for the next chunk and the tile-wide
// early-exit test. Reads past d_pad are masked to zero.
//
// Bound on an H100 SXM: the bytes it must move are the live rows of the
// processed chunks ((6+CH)*4 bytes per slot) plus its outputs, at
// 3.35 TB/s; the operations are 256 x 256 alpha evaluations per processed
// (tile, chunk) pair, each about 20 + 2*CH fp32 operations and one exp.
// At 67 TFLOP/s fp32 (and 16 exp per SM per clock on the special function
// units) the operations bound it: each slot's 36 bytes feed 65,536
// evaluations. chip_smoke.py computes both bounds from the data of a run.
// This first version keeps every slot evaluation in one thread and makes
// no attempt at that bound yet (no double buffering, per-slot shared
// memory reads, full-precision expf).

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using sugar::kChunk;
using sugar::kTEps;
using sugar::kTile;

template <int CH>
__global__ void __launch_bounds__(kChunk) tile_composite_fwd_kernel(
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const float* __restrict__ dup,
    int64_t d_pad, int tiles_x, int max_chunks, int rec,
    float* __restrict__ img, float* __restrict__ final_t,
    int32_t* __restrict__ n_contrib, float* __restrict__ entry_p,
    int32_t* __restrict__ nch) {
  constexpr int kRows = 6 + CH;
  __shared__ float s[kRows][kChunk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int64_t start = tile_start[t];
  const int count = min(tile_count[t], max_chunks * kChunk);
  const int64_t end = start + count;
  const int64_t c0 = start / kChunk;
  const int n_chunks =
      count > 0 ? static_cast<int>((end + kChunk - 1) / kChunk - c0) : 0;
  const float px = static_cast<float>((t % tiles_x) * kTile + p % kTile);
  const float py = static_cast<float>((t / tiles_x) * kTile + p / kTile);

  float pc = 1.f;    // ungated running product of (1 - alpha)
  float tfin = 1.f;  // transmittance after the last included slot
  float acc[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) acc[k] = 0.f;
  int ninc = 0;

  int c = 0;
  for (; c < n_chunks; ++c) {
    if (__syncthreads_count(pc >= kTEps) == 0) break;
    entry_p[(static_cast<int64_t>(t) * rec + c) * kChunk + p] = pc;
    const int64_t slot0 = (c0 + c) * kChunk;
    const int64_t mine = slot0 + p;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r][p] = mine < d_pad ? dup[r * d_pad + mine] : 0.f;
    }
    __syncthreads();
    // Slots outside [start, end) have alpha 0: they change nothing.
    const int64_t lo = start - slot0;
    const int64_t hi = end - slot0;
    const int j_lo = lo > 0 ? static_cast<int>(lo) : 0;
    const int j_hi = hi < kChunk ? static_cast<int>(hi) : kChunk;
    for (int j = j_lo; j < j_hi; ++j) {
      float dx, dy, e;
      const float alpha = sugar::slot_alpha(s[0][j], s[1][j], s[2][j], s[3][j], s[4][j],
                                            s[5][j], px, py, dx, dy, e);
      const float pn = pc * (1.f - alpha);
      if (pn >= kTEps) {
        if (alpha > 0.f) {
          const float w = alpha * pc;
#pragma unroll
          for (int k = 0; k < CH; ++k) acc[k] += w * s[6 + k][j];
          ++ninc;
        }
        tfin = pn;
      }
      pc = pn;
    }
  }

  const int64_t pix = static_cast<int64_t>(t) * kChunk + p;
#pragma unroll
  for (int k = 0; k < CH; ++k) img[pix * CH + k] = acc[k];
  final_t[pix] = tfin;
  n_contrib[pix] = ninc;
  if (p == 0) nch[t] = c;
}

template <int CH>
void launch(const void* tile_start, const void* tile_count, const void* dup,
            int64_t d_pad, int num_tiles, int tiles_x, int max_chunks, int rec,
            void* img, void* final_t, void* n_contrib, void* entry_p,
            void* nch, cudaStream_t stream) {
  tile_composite_fwd_kernel<CH><<<num_tiles, kChunk, 0, stream>>>(
      static_cast<const int32_t*>(tile_start),
      static_cast<const int32_t*>(tile_count), static_cast<const float*>(dup),
      d_pad, tiles_x, max_chunks, rec, static_cast<float*>(img),
      static_cast<float*>(final_t), static_cast<int32_t*>(n_contrib),
      static_cast<float*>(entry_p), static_cast<int32_t*>(nch));
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). ch must be 1..4; the Python wrapper checks every argument.
extern "C" int sugar_tile_composite_fwd(
    const void* tile_start, const void* tile_count, const void* dup_data,
    long long d_pad, int num_tiles, int tiles_x, int ch, int max_chunks,
    int rec, void* img, void* final_t, void* n_contrib, void* entry_p,
    void* nch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return 0;
  switch (ch) {
    case 1:
      launch<1>(tile_start, tile_count, dup_data, d_pad, num_tiles, tiles_x,
                max_chunks, rec, img, final_t, n_contrib, entry_p, nch, st);
      break;
    case 2:
      launch<2>(tile_start, tile_count, dup_data, d_pad, num_tiles, tiles_x,
                max_chunks, rec, img, final_t, n_contrib, entry_p, nch, st);
      break;
    case 3:
      launch<3>(tile_start, tile_count, dup_data, d_pad, num_tiles, tiles_x,
                max_chunks, rec, img, final_t, n_contrib, entry_p, nch, st);
      break;
    case 4:
      launch<4>(tile_start, tile_count, dup_data, d_pad, num_tiles, tiles_x,
                max_chunks, rec, img, final_t, n_contrib, entry_p, nch, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
