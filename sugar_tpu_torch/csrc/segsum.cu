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
//                                      gid == g; ZERO-initialized by the
//                                      caller, columns of absent ids stay 0
//
// Design: one thread per column. A thread whose column starts a segment
// (gid[i] != gid[i-1]) and holds a live id walks its segment in column
// order and makes one store per (row, Gaussian). No atomics, so the result
// is deterministic and each sum is taken in slot order, the order of a
// sequential accumulation. Neighbouring threads read neighbouring columns,
// so the loads coalesce. A segment is as long as its Gaussian's dup slot
// count, which `raster/adaptive` can grow past 16: nothing here bounds it.
//
// Bound on an H100 SXM: bytes. Each column (rows x 4 bytes + its 4-byte
// id) is read once and each output written once at 3.35 TB/s; one add per
// input value is nothing beside that. The TPU needed a one-hot MXU
// contraction because it has no fast scatter; on the card a sorted
// segment is a plain loop. This first version makes one pass per row
// (rows passes over the segment's ids) and does no vectorized loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const float* __restrict__ ct, const int32_t* __restrict__ gid,
    int64_t d, int rows, int n, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= d) return;
  const int32_t g = gid[i];
  if (g < 0 || g >= n) return;
  if (i > 0 && gid[i - 1] == g) return;  // not the head of its segment
  int64_t e = i + 1;
  while (e < d && gid[e] == g) ++e;
  for (int r = 0; r < rows; ++r) {
    const float* row = ct + static_cast<int64_t>(r) * d;
    float s = 0.f;
    for (int64_t j = i; j < e; ++j) s += row[j];
    out[static_cast<int64_t>(r) * n + g] = s;
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). `out` must be zero-filled (rows, n); the Python wrapper checks
// every argument.
extern "C" int sugar_segment_sum(const void* ct, const void* gid, long long d,
                                 int rows, int n, void* out, void* stream) {
  if (d <= 0 || rows <= 0 || n <= 0) return 0;
  const long long blocks = (d + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ct), static_cast<const int32_t*>(gid), d, rows,
      n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
