// Binning of the fused render on the card: count, scan, emit and per-tile
// order of the dup slots, written for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package bins with XLA ops over a
// static expansion (sugar_tpu/raster/fused.py `expand_support_culled` and
// the [tile | depth rank] sort of `bin_fused`): every Gaussian owns
// tile_cap slots, each slot is tested, and the whole buffer is sorted. On
// the card that tested and sorted 11-16M slots to keep 3-5M. These kernels
// test each tile of a Gaussian's rect (no per-Gaussian cap) and write and
// order only the slots they keep; the host reads nothing and copies nothing
// to the card, so the render never waits on it.
//
//   per Gaussian g < n (read once per pass):
//     mean2d (n, 2) f32, conic (n, 3) f32, qmax (n,) f32 (log(max(opacity,
//     1e-30) / ALPHA_CUTOFF), computed by the caller with the torch ops of
//     the plain route, so a boundary tile falls the same way), rect_min,
//     rect_max (n, 2) int32, tiles_touched (n,) int32, rank (n,) int64 (the
//     Gaussian's place in the stable depth sort), gsort (n,) int64 (the
//     Gaussian at each place)
//   outputs:
//     gid (d_pad,) int32       the Gaussians of each tile's slots in depth
//                              order, tile after tile, then the sentinel n
//     counts_culled (n,) int32 kept slots of each Gaussian
//     tile_start, tile_count (T,) int32, clipped at d_pad
//     stats (3,) int64         num_rendered, cap_overflow (= overflow =
//                              inexact), big_overflow (0)
//
// Bound on an H100 SXM: bytes, and they are few. The per-Gaussian inputs
// (60 bytes) are read once and gid is written once at 3.35 TB/s: about
// 0.07 ms for 2M Gaussians and a 25M-slot gid. The slot tests (about 60
// flops each, Sum tiles_touched of them, done twice) and the per-tile sorts
// stay below that only while they scale with the kept slots, which is the
// point of the design.
//
// Design, six launches on one stream:
//  1. visit<count>: a persistent grid; block b owns a contiguous range of
//     Gaussians. A thread tests the rect tiles of its Gaussian; a rect of
//     more than 32 tiles goes to the whole warp, one tile a lane, so large
//     splats do not serialise a thread. The test is the plain route's
//     `_box_qmin` with the same f32 operations in the same order (explicit
//     round-to-nearest intrinsics: no FMA contraction) and NaN propagating
//     as torch.minimum/maximum/clamp propagate it. Kept slots go to the
//     block's histogram row over the T tiles (few tiles are covered and
//     they are deep, so one row for the whole grid would serialise its
//     atomics). Up to kSharedTiles tiles (96 KB, two blocks an SM; a
//     1920x1244 frame has 9,360) the row lives in shared memory and is
//     written out at the end; a larger frame (a 4K frame has 32,400 tiles)
//     keeps it in global memory, up to kGlobalBlocksPerSm blocks an SM, so
//     no frame size is refused. The block also writes counts_culled.
//  2. column prefix: per tile, an exclusive prefix of the blocks' counts,
//     in place, and the tile's total.
//  3. tile scan (one block): exclusive scan of the totals over the tiles,
//     the raw starts, tile_start/tile_count clipped at d_pad exactly as a
//     searchsorted over the truncated tile-major array clips them, the
//     counters, and the list of tiles too deep for the small sort.
//  4. visit<emit>: the same blocks over the same Gaussians test again and
//     write each kept slot's depth rank into its tile's range at the
//     block's offset plus a shared-memory cursor. Positions past
//     d_pad + n are dropped: only tiles that start at or past d_pad reach
//     them (a tile holds at most n slots), and those are cut whole.
//  5. sort small (one block a tile): a range of at most 8,192 ranks is
//     sorted by a bitonic network in shared memory and written out as
//     gid = gsort[rank] up to d_pad; the blocks also fill the sentinel n
//     from min(num_rendered, d_pad) to d_pad.
//  6. sort large (one block an SM, looping over the deep tiles): up to
//     32,768 ranks in dynamic shared memory; a deeper range is sorted in
//     chunks of that size, then merged in rounds between the key buffer
//     and the same range of a second one (each element's place is its
//     index in its run plus a binary search in the other run; ranks are
//     unique, so there are no ties).
// The atomics only decide where in its tile's range a rank is written;
// the sort orders the range by rank, and ranks are unique, so two calls
// give bit-identical outputs. A tile cut by the capacity keeps its lowest
// ranks, as the sort-then-truncate of the plain route does.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;        // visit kernels: one Gaussian a thread
constexpr int kThreadTiles = 32;     // larger rects go to a whole warp
constexpr int kTileX = 16;           // raster/common.py TILE_X, TILE_Y
constexpr int kTileY = 16;
constexpr float kQEps = 1e-3f;       // raster/fused.py _Q_EPS
constexpr int kPrefixThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kSmallKeys = 8192;     // sort small: static shared memory
constexpr int kSmallThreads = 512;
constexpr int kLargeKeys = 32768;    // sort large: dynamic shared memory
constexpr int kLargeThreads = 1024;
constexpr int kSharedTiles = 24576;  // visit histogram in shared memory up to here
constexpr int kGlobalBlocksPerSm = 4;  // visit blocks an SM with the histogram in global memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

struct Splats {
  const float* mean2d;
  const float* conic;
  const float* qmax;
  const int32_t* rect_min;
  const int32_t* rect_max;
  const int32_t* touched;
  const int64_t* rank;
  int n;
  int tiles_x;
  int num_tiles;
};

struct Splat {
  float mx, my, a, b, c, thr;
  int rx, ry, rw, tt, key;
};

__device__ __forceinline__ Splat load_splat(const Splats& s, int g, bool live) {
  Splat p = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0, 0, 1, 0, 0};
  if (!live) return p;
  p.tt = max(s.touched[g], 0);
  if (p.tt == 0) return p;
  p.mx = s.mean2d[2 * g];
  p.my = s.mean2d[2 * g + 1];
  p.a = s.conic[3 * g];
  p.b = s.conic[3 * g + 1];
  p.c = s.conic[3 * g + 2];
  p.thr = __fadd_rn(s.qmax[g], kQEps);
  p.rx = s.rect_min[2 * g];
  p.ry = s.rect_min[2 * g + 1];
  p.rw = max(s.rect_max[2 * g] - p.rx, 1);
  p.key = static_cast<int>(s.rank[g]);
  return p;
}

__device__ __forceinline__ Splat shfl_splat(const Splat& p, int src) {
  Splat q;
  q.mx = __shfl_sync(kFull, p.mx, src);
  q.my = __shfl_sync(kFull, p.my, src);
  q.a = __shfl_sync(kFull, p.a, src);
  q.b = __shfl_sync(kFull, p.b, src);
  q.c = __shfl_sync(kFull, p.c, src);
  q.thr = __shfl_sync(kFull, p.thr, src);
  q.rx = __shfl_sync(kFull, p.rx, src);
  q.ry = __shfl_sync(kFull, p.ry, src);
  q.rw = __shfl_sync(kFull, p.rw, src);
  q.tt = __shfl_sync(kFull, p.tt, src);
  q.key = __shfl_sync(kFull, p.key, src);
  return q;
}

// torch.maximum / torch.minimum / torch.clamp: NaN in, NaN out.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

// One edge of the box: with e the fixed coordinate, the other coordinate
// d = clamp(-b e / o_s, lo, hi), q = 0.5 p e e + b e d + 0.5 o d d, in the
// plain route's order of operations (raster/fused.py _box_qmin).
__device__ __forceinline__ float edge_q(float e, float lo, float hi, float p, float o,
                                        float o_s, float b) {
  const float d = min_nan(max_nan(__fdiv_rn(__fmul_rn(-b, e), o_s), lo), hi);
  const float t1 = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, p), e), e);
  const float t2 = __fmul_rn(__fmul_rn(b, e), d);
  const float t3 = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, o), d), d);
  return __fadd_rn(__fadd_rn(t1, t2), t3);
}

// Slot j of the Gaussian's rect (row-major; j // w as floor(f32(j) /
// f32(w)), raster/fused.py _slot_tiles): its tile, and whether the tile's
// pixel box meets the alpha >= cutoff ellipse (raster/fused.py
// _slot_valid). A tile outside the grid (never, for a rect clipped to it)
// is not kept.
__device__ __forceinline__ bool slot_kept(const Splat& p, int j, int tiles_x, int num_tiles,
                                          int* tile) {
  const int ty_off = static_cast<int>(
      floorf(__fdiv_rn(static_cast<float>(j), static_cast<float>(p.rw))));
  const int tx = p.rx + (j - ty_off * p.rw);
  const int ty = p.ry + ty_off;
  *tile = ty * tiles_x + tx;
  if (tx < 0 || tx >= tiles_x || *tile < 0 || *tile >= num_tiles) return false;
  const float x0 = static_cast<float>(tx * kTileX);
  const float y0 = static_cast<float>(ty * kTileY);
  const float lx = __fsub_rn(x0, p.mx);
  const float hx = __fsub_rn(__fadd_rn(x0, static_cast<float>(kTileX - 1)), p.mx);
  const float ly = __fsub_rn(y0, p.my);
  const float hy = __fsub_rn(__fadd_rn(y0, static_cast<float>(kTileY - 1)), p.my);
  const bool inside = lx <= 0.f && hx >= 0.f && ly <= 0.f && hy >= 0.f;
  const float a_s = max_nan(p.a, 1e-30f);
  const float c_s = max_nan(p.c, 1e-30f);
  const float qmin = inside ? 0.f
                            : min_nan(min_nan(edge_q(lx, ly, hy, p.a, p.c, c_s, p.b),
                                              edge_q(hx, ly, hy, p.a, p.c, c_s, p.b)),
                                      min_nan(edge_q(ly, lx, hx, p.c, p.a, a_s, p.b),
                                              edge_q(hy, lx, hx, p.c, p.a, a_s, p.b)));
  return qmin <= p.thr;
}

// Count: cnt is the block's histogram. Emit: cnt holds the block's offset
// inside each tile's range and serves as its cursor.
template <bool kEmit>
__device__ __forceinline__ void visit(int tile, int key, int32_t* cnt,
                                      const int64_t* __restrict__ raw_start,
                                      int32_t* __restrict__ keys, int64_t key_len) {
  if (kEmit) {
    const int64_t pos = raw_start[tile] + atomicAdd(cnt + tile, 1);
    if (pos < key_len) keys[pos] = key;
  } else {
    atomicAdd(cnt + tile, 1);
  }
}

// kShared: the histogram row in shared memory (kSharedTiles tiles at
// most), else the block's row of hist itself.
template <bool kEmit, bool kShared>
__global__ void __launch_bounds__(kThreads) visit_kernel(
    Splats s, int per_block, int32_t* __restrict__ hist, int32_t* __restrict__ counts_culled,
    const int64_t* __restrict__ raw_start, int32_t* __restrict__ keys, int64_t key_len) {
  extern __shared__ int32_t s_tile[];
  const int T = s.num_tiles;
  int32_t* row = hist + static_cast<int64_t>(blockIdx.x) * T;
  int32_t* cnt = kShared ? s_tile : row;
  if (kShared || !kEmit)
    for (int t = threadIdx.x; t < T; t += kThreads) cnt[t] = kEmit ? row[t] : 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g_begin = blockIdx.x * per_block;
  const int g_end = min(g_begin + per_block, s.n);
  for (int base = g_begin; base < g_end; base += kThreads) {
    const int g = base + threadIdx.x;
    const bool live = g < g_end;
    const Splat p = load_splat(s, g, live);
    int kept = 0;
    if (p.tt <= kThreadTiles) {
      for (int j = 0; j < p.tt; ++j) {
        int tile;
        if (slot_kept(p, j, s.tiles_x, T, &tile)) {
          ++kept;
          visit<kEmit>(tile, p.key, cnt, raw_start, keys, key_len);
        }
      }
    }
    unsigned wide = __ballot_sync(kFull, p.tt > kThreadTiles);
    while (wide) {
      const int src = __ffs(wide) - 1;
      wide &= wide - 1;
      const Splat q = shfl_splat(p, src);
      int kq = 0;
      for (int j = lane; j < q.tt; j += 32) {
        int tile;
        if (slot_kept(q, j, s.tiles_x, T, &tile)) {
          ++kq;
          visit<kEmit>(tile, q.key, cnt, raw_start, keys, key_len);
        }
      }
      kq = __reduce_add_sync(kFull, kq);
      if (lane == src) kept = kq;
    }
    if (!kEmit && live) counts_culled[g] = kept;
  }
  if (kShared && !kEmit) {
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += kThreads) row[t] = s_tile[t];
  }
}

// hist (grid, T): each column becomes its exclusive prefix over the
// blocks; total[t] is the column's sum.
__global__ void __launch_bounds__(kPrefixThreads) column_prefix_kernel(
    int32_t* __restrict__ hist, int grid, int T, int32_t* __restrict__ total) {
  const int t = blockIdx.x * kPrefixThreads + threadIdx.x;
  if (t >= T) return;
  // Eight loads in flight before their stores: one column is a chain of
  // grid loads T ints apart.
  constexpr int kBatch = 8;
  int32_t run = 0;
  for (int b0 = 0; b0 < grid; b0 += kBatch) {
    int32_t v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      v[k] = b0 + k < grid ? hist[static_cast<int64_t>(b0 + k) * T + t] : 0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (b0 + k < grid) hist[static_cast<int64_t>(b0 + k) * T + t] = run;
      run += v[k];
    }
  }
  total[t] = run;
}

// Sum of v over the block (kScanThreads threads); every thread gets it.
__device__ int64_t block_sum(int64_t v, int64_t* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int64_t s = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) s += s_warp[w];
  return s;
}

// Exclusive prefix of v over the threads of the block, in thread order.
__device__ int64_t block_exclusive(int64_t v, int64_t* s_warp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int64_t inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += u;
  }
  __syncthreads();
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int64_t before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  return before + inc - v;
}

__global__ void __launch_bounds__(kScanThreads) tile_scan_kernel(
    const int32_t* __restrict__ total, int T, int64_t d_pad, int64_t capacity,
    int64_t* __restrict__ raw_start,
    int32_t* __restrict__ tile_start, int32_t* __restrict__ tile_count,
    int32_t* __restrict__ deep, int64_t* __restrict__ stats) {
  __shared__ int64_t s_warp[kScanThreads / 32];
  __shared__ int s_deep;
  if (threadIdx.x == 0) s_deep = 0;
  const int per = (T + kScanThreads - 1) / kScanThreads;
  const int t0 = min(static_cast<int>(threadIdx.x) * per, T);
  const int t1 = min(t0 + per, T);
  int64_t sum = 0;
  for (int t = t0; t < t1; ++t) sum += total[t];
  int64_t run = block_exclusive(sum, s_warp);  // its barriers publish s_deep
  for (int t = t0; t < t1; ++t) {
    const int64_t c = total[t];
    const int64_t s = min64(run, d_pad);
    raw_start[t] = run;
    tile_start[t] = static_cast<int32_t>(s);
    tile_count[t] = static_cast<int32_t>(min64(run + c, d_pad) - s);
    if (run < d_pad && c > kSmallKeys) deep[atomicAdd(&s_deep, 1)] = t;
    run += c;
  }
  const int64_t rendered = block_sum(sum, s_warp);
  if (threadIdx.x == 0) {
    stats[0] = rendered;
    stats[1] = rendered > capacity ? rendered - capacity : 0;
    stats[2] = 0;
    deep[T] = s_deep;  // block_sum's barriers order every append before this
  }
}

__device__ __forceinline__ int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Ascending bitonic sort of s[0, P), P a power of two; the caller has
// synchronised after filling s. Ends with a barrier.
__device__ void bitonic_sort(int32_t* s, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < P / 2; q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int l = i + j;
        const int32_t x = s[i], y = s[l];
        if ((x > y) == ((i & k) == 0)) {
          s[i] = y;
          s[l] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Sort the m ranks at src into shared memory s (padded to a power of two).
__device__ void sort_into_shared(const int32_t* src, int m, int32_t* s) {
  const int P = next_pow2(m);
  for (int p = threadIdx.x; p < P; p += blockDim.x) s[p] = p < m ? src[p] : INT_MAX;
  __syncthreads();
  bitonic_sort(s, P);
}

__global__ void __launch_bounds__(kSmallThreads) sort_small_kernel(
    const int64_t* __restrict__ raw_start, const int32_t* __restrict__ total, int64_t d_pad,
    const int32_t* __restrict__ keys, const int64_t* __restrict__ gsort,
    const int64_t* __restrict__ stats, int n, int32_t* __restrict__ gid) {
  __shared__ int32_t s_keys[kSmallKeys];
  const int64_t fill_from = min64(stats[0], d_pad);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSmallThreads;
  for (int64_t p = fill_from + static_cast<int64_t>(blockIdx.x) * kSmallThreads + threadIdx.x;
       p < d_pad; p += stride)
    gid[p] = n;
  const int t = blockIdx.x;
  const int64_t s = raw_start[t];
  const int c = total[t];
  if (c == 0 || c > kSmallKeys || s >= d_pad) return;
  sort_into_shared(keys + s, c, s_keys);
  const int out = static_cast<int>(min64(c, d_pad - s));
  for (int p = threadIdx.x; p < out; p += kSmallThreads)
    gid[s + p] = static_cast<int32_t>(gsort[s_keys[p]]);
}

// First index in a[0, len) whose value is >= x (len may be <= 0).
__device__ __forceinline__ int lower_bound(const int32_t* a, int len, int32_t x) {
  int lo = 0, hi = max(len, 0);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kLargeThreads) sort_large_kernel(
    const int64_t* __restrict__ raw_start, const int32_t* __restrict__ total, int64_t d_pad,
    int32_t* keys, int32_t* scratch, const int64_t* __restrict__ gsort,
    const int32_t* __restrict__ deep, int T, int32_t* __restrict__ gid) {
  extern __shared__ int32_t s_keys[];
  const int n_deep = deep[T];
  for (int i = blockIdx.x; i < n_deep; i += gridDim.x) {
    const int t = deep[i];
    const int64_t s = raw_start[t];
    const int c = total[t];
    const int out = static_cast<int>(min64(c, d_pad - s));
    if (c <= kLargeKeys) {
      sort_into_shared(keys + s, c, s_keys);
      for (int p = threadIdx.x; p < out; p += kLargeThreads)
        gid[s + p] = static_cast<int32_t>(gsort[s_keys[p]]);
      __syncthreads();  // s_keys is filled again for the next tile
      continue;
    }
    // Sorted runs of kLargeKeys, then merge rounds between the key buffer
    // and the scratch buffer.
    int32_t* src = keys + s;
    int32_t* dst = scratch + s;
    for (int c0 = 0; c0 < c; c0 += kLargeKeys) {
      const int m = min(kLargeKeys, c - c0);
      sort_into_shared(src + c0, m, s_keys);
      for (int p = threadIdx.x; p < m; p += kLargeThreads) src[c0 + p] = s_keys[p];
      __syncthreads();
    }
    for (int w = kLargeKeys; w < c; w <<= 1) {
      for (int p = threadIdx.x; p < c; p += kLargeThreads) {
        const int r = p / w;
        const int base = (r & ~1) * w;
        const int32_t x = src[p];
        int pos;
        if ((r & 1) == 0) {
          const int lo = base + w;
          pos = (p - base) + lower_bound(src + lo, min(base + 2 * w, c) - lo, x);
        } else {
          pos = (p - base - w) + lower_bound(src + base, w, x);
        }
        dst[base + pos] = x;
      }
      __syncthreads();
      int32_t* tmp = src;
      src = dst;
      dst = tmp;
    }
    for (int p = threadIdx.x; p < out; p += kLargeThreads)
      gid[s + p] = static_cast<int32_t>(gsort[src[p]]);
    __syncthreads();
  }
}

bool shared_hist(int num_tiles) { return num_tiles <= kSharedTiles; }

int visit_smem(int num_tiles) {
  return shared_hist(num_tiles) ? num_tiles * static_cast<int>(sizeof(int32_t)) : 0;
}

int set_smem_limits(int num_tiles) {
  const int smem = visit_smem(num_tiles);
  cudaError_t err = cudaFuncSetAttribute(visit_kernel<false, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(visit_kernel<true, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sort_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kLargeKeys * static_cast<int>(sizeof(int32_t)));
  return static_cast<int>(err);
}

}  // namespace

// Blocks of the visit kernels for n Gaussians over num_tiles tiles on the
// current device: as many as stay resident at once (a shared-memory
// histogram of num_tiles ints bounds that; a global one is capped at
// kGlobalBlocksPerSm blocks an SM, which bounds its scratch), and no more
// than n needs. Returns a cudaError_t (0 on success); the wrapper sizes
// the histogram scratch (grid, num_tiles) from *grid.
extern "C" int sugar_bin_fused_grid(int num_tiles, int n, int* grid) {
  if (num_tiles <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem_limits(num_tiles);
  if (err != 0) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  auto* count = shared_hist(num_tiles) ? visit_kernel<false, true> : visit_kernel<false, false>;
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, count, kThreads, visit_smem(num_tiles)));
  if (err != 0) return err;
  if (!shared_hist(num_tiles)) per_sm = std::min(per_sm, kGlobalBlocksPerSm);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int by_n = (n + kThreads - 1) / kThreads;
  *grid = std::max(1, std::min(sms * per_sm, by_n));
  return 0;
}

// Launches the six kernels on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 on success). The wrapper checks every
// argument and allocates every buffer: hist (grid * num_tiles) int32,
// total (num_tiles) int32, raw_start (num_tiles) int64, deep (num_tiles +
// 1) int32, keys (2 * (d_pad + n)) int32 (the emitted ranks, then the
// large sort's scratch), gid (d_pad) int32, counts_culled (n) int32,
// tile_start and tile_count (num_tiles) int32, stats (3) int64; none needs
// to be initialised.
extern "C" int sugar_bin_fused(
    const void* mean2d, const void* conic, const void* qmax, const void* rect_min,
    const void* rect_max, const void* touched, const void* rank, const void* gsort, int n,
    int tiles_x, int num_tiles, long long d_pad, long long capacity, int grid, void* hist,
    void* total, void* raw_start, void* deep, void* stats, void* keys, void* gid,
    void* counts_culled, void* tile_start, void* tile_count, void* stream_) {
  if (n < 0 || tiles_x <= 0 || num_tiles <= 0 || grid <= 0 || d_pad <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem_limits(num_tiles);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  auto stream = static_cast<cudaStream_t>(stream_);
  const Splats s = {static_cast<const float*>(mean2d), static_cast<const float*>(conic),
                    static_cast<const float*>(qmax), static_cast<const int32_t*>(rect_min),
                    static_cast<const int32_t*>(rect_max), static_cast<const int32_t*>(touched),
                    static_cast<const int64_t*>(rank), n, tiles_x, num_tiles};
  const int per_g = (n + grid - 1) / grid;
  const int per_block = std::max(kThreads, (per_g + kThreads - 1) / kThreads * kThreads);
  const int smem = visit_smem(num_tiles);
  auto* h = static_cast<int32_t*>(hist);
  auto* tot = static_cast<int32_t*>(total);
  auto* rs = static_cast<int64_t*>(raw_start);
  auto* dp = static_cast<int32_t*>(deep);
  auto* st = static_cast<int64_t*>(stats);
  auto* k = static_cast<int32_t*>(keys);
  auto* out = static_cast<int32_t*>(gid);
  const auto* gs = static_cast<const int64_t*>(gsort);
  auto* cc = static_cast<int32_t*>(counts_culled);
  const int64_t key_len = d_pad + n;

  const bool shared = shared_hist(num_tiles);
  auto* count = shared ? visit_kernel<false, true> : visit_kernel<false, false>;
  auto* emit = shared ? visit_kernel<true, true> : visit_kernel<true, false>;
  count<<<grid, kThreads, smem, stream>>>(s, per_block, h, cc, rs, k, key_len);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  column_prefix_kernel<<<(num_tiles + kPrefixThreads - 1) / kPrefixThreads, kPrefixThreads, 0,
                         stream>>>(h, grid, num_tiles, tot);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  tile_scan_kernel<<<1, kScanThreads, 0, stream>>>(
      tot, num_tiles, d_pad, capacity, rs, static_cast<int32_t*>(tile_start),
      static_cast<int32_t*>(tile_count), dp, st);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  emit<<<grid, kThreads, smem, stream>>>(s, per_block, h, cc, rs, k, key_len);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  sort_small_kernel<<<num_tiles, kSmallThreads, 0, stream>>>(rs, tot, d_pad, k, gs, st, n, out);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  sort_large_kernel<<<sms, kLargeThreads, kLargeKeys * sizeof(int32_t), stream>>>(
      rs, tot, d_pad, k, k + key_len, gs, dp, num_tiles, out);
  return static_cast<int>(cudaGetLastError());
}
