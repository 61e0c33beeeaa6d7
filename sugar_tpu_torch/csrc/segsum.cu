// Segmented column sum of gid-sorted cotangents: the gradient reduction of
// the dup gather (dup-slot gradients -> per-Gaussian gradients), written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sugar_tpu/raster/segsum.py `_kernel`
// (called through `segment_sum_sorted` from pallas_render._gather_dup_bwd).
//
//   ct  (rows, d) float32, row-major   cotangent columns, sorted by gid
//   gid (d,) int32, ascending          Gaussian id of each column; ids >= n
//                                      (the sentinel of padding and culled
//                                      slots) and ids < 0 are dropped
//   out (rows, n) float32              out[:, g] = sum of the columns whose
//                                      gid == g (0 for an absent id); every
//                                      element is written, so the caller
//                                      allocates it uninitialized
//
// Bound on an H100 SXM: bytes. The live columns (rows x 4 bytes + a 4-byte
// id each) are read once and the output written once at 3.35 TB/s; one
// add per input value is nothing beside that. The TPU needed a one-hot MXU
// contraction because it has no fast scatter; on the card a sorted
// segment is a plain loop.
//
// Design: output-driven blocks, one thread per id. Block b owns the ids
// [g0, g0 + kIds). Because the ids are sorted, its columns are one span
// starting at lower_bound(g0), which one warp finds by a 64-ary search
// (four dependent loads for two million ids; the upper levels, shared by
// every block, come from L2). The block then stages the span's ids kTile
// at a time with coalesced loads, and a barrier count of those below
// g0 + kIds says where the span ends, so there is no second search.
// Negative ids lie before the span and sentinel ids after it: no thread
// reads their columns. Each thread finds its id's run among the staged
// ids by a binary search and adds it, row by row, to sums it carries in
// registers from pass to pass, so a segment of any length is summed in
// slot order, as a sequential loop would. The cotangent is read straight
// from device memory: neighbouring threads read neighbouring columns, so
// the loads coalesce, and the kernel needs 32 registers and 1 KiB of
// shared memory, which keeps many blocks in flight to cover the search's
// latency (staging the cotangent through shared memory as well measured
// slower on the H100). Each output element gets exactly one store, zeros
// included, and neighbouring threads store neighbouring ids. No atomics:
// two launches give bit-identical results. The grid is sized from n
// alone, so the host reads nothing from the card.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // one thread per id
constexpr int kIds = kThreads;       // ids per block
constexpr int kTile = 2 * kThreads;  // staged ids per pass
constexpr int kProbes = 2;           // search probes per lane: 64-ary
constexpr int kMaxRows = 16;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// First position p in [0, d) with gid[p] >= target (d if none), found by
// the 32 lanes of a warp together: each round probes 32 * kProbes evenly
// spaced positions and keeps the gap between the last probe below the
// target and the first at or above it.
__device__ int64_t warp_lower_bound(const int32_t* __restrict__ gid, int64_t d,
                                    int64_t target) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = d;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + 32 * kProbes - 1) / (32 * kProbes);
    int32_t v[kProbes];
#pragma unroll
    for (int k = 0; k < kProbes; ++k) {
      const int64_t p = lo + (k * 32 + lane) * step;
      v[k] = p < hi ? __ldg(gid + p) : INT_MAX;
    }
    int m = 0;  // probes below the target: a prefix of (k, lane) order
#pragma unroll
    for (int k = 0; k < kProbes; ++k) {
      const int64_t p = lo + (k * 32 + lane) * step;
      m += __popc(__ballot_sync(0xffffffffu, p < hi && v[k] < target));
    }
    if (m == 0) {
      hi = lo;
    } else {
      hi = min64(hi, lo + m * step);
      lo += (m - 1) * step + 1;
    }
  }
  return lo;
}

// First position p in [0, cnt) of the staged ids with ids[p] >= g.
__device__ int shared_lower_bound(const int32_t* ids, int cnt, int64_t g) {
  int lo = 0, hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < g) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const float* __restrict__ ct, const int32_t* __restrict__ gid, int64_t d,
    int n, float* __restrict__ out) {
  __shared__ int32_t s_gid[kTile];
  __shared__ int64_t s_lo;

  const int tid = threadIdx.x;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kIds;
  const int64_t g = g0 + tid;
  const int64_t g_end = min64(g0 + kIds, n);
  if (tid < 32) {
    const int64_t pos = warp_lower_bound(gid, d, g0);
    if (tid == 0) s_lo = pos;
  }
  __syncthreads();

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int64_t base = s_lo;; base += kTile) {
    // The ids below g_end are a prefix of the staged ones (they are
    // sorted); each barrier count adds that prefix's share of one row of
    // kThreads staged ids.
    int cnt = 0;
#pragma unroll
    for (int it = 0; it < kTile / kThreads; ++it) {
      const int j = tid + it * kThreads;
      bool below = false;
      if (base + j < d) {
        const int32_t id = __ldg(gid + base + j);
        s_gid[j] = id;
        below = id < g_end;
      }
      cnt += __syncthreads_count(below);
    }
    if (g < n) {
      for (int j = shared_lower_bound(s_gid, cnt, g); j < cnt && s_gid[j] == g; ++j) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] += __ldg(ct + r * d + base + j);
      }
    }
    if (cnt < kTile) break;  // the span ends in this pass (cnt is uniform)
    __syncthreads();         // the next pass overwrites s_gid
  }
  if (g < n) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) out[static_cast<int64_t>(r) * n + g] = acc[r];
  }
}

template <int ROWS>
int launch(const float* ct, const int32_t* gid, long long d, int n, float* out,
           cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + kIds - 1) / kIds);
  segment_sum_kernel<ROWS><<<blocks, kThreads, 0, stream>>>(ct, gid, d, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Every element of `out` (rows, n) is written; the Python
// wrapper checks every argument (1 <= rows <= 16, n >= 1, d >= 0).
extern "C" int sugar_segment_sum(const void* ct_, const void* gid_, long long d,
                                 int rows, int n, void* out_, void* stream_) {
  if (n <= 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ct = static_cast<const float*>(ct_);
  const auto* gid = static_cast<const int32_t*>(gid_);
  auto* out = static_cast<float*>(out_);
  auto stream = static_cast<cudaStream_t>(stream_);
  switch (rows) {
    case 1: return launch<1>(ct, gid, d, n, out, stream);
    case 2: return launch<2>(ct, gid, d, n, out, stream);
    case 3: return launch<3>(ct, gid, d, n, out, stream);
    case 4: return launch<4>(ct, gid, d, n, out, stream);
    case 5: return launch<5>(ct, gid, d, n, out, stream);
    case 6: return launch<6>(ct, gid, d, n, out, stream);
    case 7: return launch<7>(ct, gid, d, n, out, stream);
    case 8: return launch<8>(ct, gid, d, n, out, stream);
    case 9: return launch<9>(ct, gid, d, n, out, stream);
    case 10: return launch<10>(ct, gid, d, n, out, stream);
    case 11: return launch<11>(ct, gid, d, n, out, stream);
    case 12: return launch<12>(ct, gid, d, n, out, stream);
    case 13: return launch<13>(ct, gid, d, n, out, stream);
    case 14: return launch<14>(ct, gid, d, n, out, stream);
    case 15: return launch<15>(ct, gid, d, n, out, stream);
    case kMaxRows: return launch<kMaxRows>(ct, gid, d, n, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
