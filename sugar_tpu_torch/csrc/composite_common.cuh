// Device code shared by the compositing forward (tile_composite.cu) and
// backward (tile_composite_bwd.cu).
//
// - slot_alpha: the per-slot alpha evaluation. One definition keeps the two
//   kernels' arithmetic identical, so the backward's recomputed include
//   decisions are the ones the forward made. Semantics of
//   pallas_composite.py `_chunk_alpha`.
// - TileRange / chunk_span: a tile's clipped slot range and the part of
//   one aligned chunk it owns.
// - build_items: the work list of (tile, chunk) pairs both kernels run on.
//
// Both kernels decide inclusion as the TPU kernel does: with U_j the
// chunk-local product of (1 - alpha) over slots 0..j, taken in slot order
// from 1, a pixel includes slot j while entry_p * U_j >= T_EPS, where
// entry_p is the pixel's ungated product at the chunk's entry. U never
// grows and float multiplication rounds monotonically, so the included
// slots of a chunk are a prefix, and entry_p * U_last >= T_EPS means all of
// them are included.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sugar {

// cudaGetLastError() as the int the C interface returns (0 on success).
inline int last_error() { return static_cast<int>(cudaGetLastError()); }

constexpr int kChunk = 256;  // slots per chunk = pixels per tile
constexpr int kTile = 16;
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr float kOneMinusClamp = 0.01f;  // f32(1 - 0.99 in double), as the TPU kernel
constexpr int kBuildThreads = 1024;

// Gated alpha of one slot at pixel (px, py): min(0.99, opacity *
// exp(power)), 0 when power > 0 or alpha < 1/255. The exp input is
// where()-gated, so a NaN conic on a dropped slot cannot reach `e`; the
// clamp is a select that keeps NaN, so the cutoff gate drops a NaN
// opacity. Also returns dx, dy (mean - pixel) and e = exp(gated power).
__device__ __forceinline__ float slot_alpha(float mx, float my, float ca, float cb,
                                            float cc, float op, float px, float py,
                                            float& dx, float& dy, float& e) {
  dx = mx - px;
  dy = my - py;
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  const bool pw_ok = power <= 0.f;  // false for NaN
  e = expf(pw_ok ? power : 0.f);
  const float raw = op * e;
  const float alpha = raw > kAlphaClamp ? kAlphaClamp : raw;  // keeps NaN
  return (pw_ok && alpha >= kAlphaCutoff) ? alpha : 0.f;
}

// A tile's slot range [start, end), count clipped to max_chunks * 256, and
// the aligned chunks covering it: c0 = start / 256, n_chunks of them (a
// range from an unaligned start can span one chunk more than its count
// needs).
struct TileRange {
  int64_t start, end, c0;
  int n_chunks;
};

__device__ __forceinline__ TileRange tile_range(const int32_t* tile_start,
                                                const int32_t* tile_count, int t,
                                                int max_chunks) {
  TileRange r;
  r.start = tile_start[t];
  const int count = min(tile_count[t], max_chunks * kChunk);
  r.end = r.start + count;
  r.c0 = r.start / kChunk;
  r.n_chunks = count > 0 ? static_cast<int>((r.end + kChunk - 1) / kChunk - r.c0) : 0;
  return r;
}

// The slots [j_lo, j_hi) of chunk c (local indices 0..255) that the tile
// owns; slots outside have alpha 0 and change nothing.
__device__ __forceinline__ void chunk_span(const TileRange& r, int c, int& j_lo, int& j_hi) {
  const int64_t slot0 = (r.c0 + c) * kChunk;
  const int64_t lo = r.start - slot0;
  const int64_t hi = r.end - slot0;
  j_lo = lo > 0 ? static_cast<int>(lo) : 0;
  j_hi = hi < kChunk ? static_cast<int>(hi) : kChunk;
}

// A listed (tile, chunk) pair; t = -1 for a block past the list's end.
struct Pair {
  int t, c;
};

// The pair of this block: one block per listed pair (build_items).
__device__ __forceinline__ Pair block_pair(const int32_t* __restrict__ first,
                                           const int32_t* __restrict__ item_tile,
                                           int num_tiles) {
  const int i = blockIdx.x;
  if (i >= first[num_tiles]) return {-1, 0};
  const int t = item_tile[i];
  return {t, i - first[t]};
}

// The coordinates of this thread's pixel (thread p = pixel p of tile t).
__device__ __forceinline__ void pixel_xy(int t, int tiles_x, float& px, float& py) {
  px = static_cast<float>((t % tiles_x) * kTile + threadIdx.x % kTile);
  py = static_cast<float>((t / tiles_x) * kTile + threadIdx.x / kTile);
}

// Stages chunk c's first `rows` packed rows into s[row][0..255], one
// coalesced 1 KiB read per row; reads past d_pad give 0.
template <int kRows>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ dup, int64_t d_pad,
                                            int64_t slot0, float (*s)[kChunk]) {
  const int64_t mine = slot0 + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r][threadIdx.x] = mine < d_pad ? dup[r * d_pad + mine] : 0.f;
}

// One block of kBuildThreads threads lists the work items, tile-major:
// tile t gets items first[t] .. first[t+1]-1, one per chunk it walks
// (its n_chunks, or nch[t] when `nch` is given), and item_tile[i] = t.
// first[] is clipped to `capacity`, so a list that would not fit is cut
// short instead of written out of bounds (the wrapper sizes capacity to
// hold every list of disjoint ranges inside [0, d_pad)). first[num_tiles]
// is the number of items.
__global__ void __launch_bounds__(kBuildThreads) build_items(
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ nch, int num_tiles, int max_chunks, int capacity,
    int32_t* __restrict__ first, int32_t* __restrict__ item_tile) {
  __shared__ int warp_sums[kBuildThreads / 32];
  __shared__ int base;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) base = 0;
  __syncthreads();
  for (int t0 = 0; t0 < num_tiles; t0 += kBuildThreads) {
    const int t = t0 + tid;
    int n = 0;
    if (t < num_tiles) n = nch ? nch[t] : tile_range(tile_start, tile_count, t, max_chunks).n_chunks;
    // Inclusive scan of n over the block: within warps, then warp sums.
    int x = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int off = base + x - n + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (t < num_tiles) {
      const int lo = min(off, capacity);
      const int hi = min(off + n, capacity);
      first[t] = lo;
      for (int i = lo; i < hi; ++i) item_tile[i] = t;
    }
    __syncthreads();  // every thread has read base and warp_sums
    if (tid == kBuildThreads - 1) base = off + n;
    __syncthreads();
  }
  if (tid == 0) first[num_tiles] = min(base, capacity);
}

}  // namespace sugar
