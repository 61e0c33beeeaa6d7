// Preprocess of a render that needs no gradient, from the model's raw
// fields, written for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package preprocesses with XLA ops
// (sugar_tpu/raster/preprocess.py `preprocess`, sugar_tpu/core/sh.py
// `eval_sh`, the activations of sugar_tpu/models/render.py), which XLA
// fuses. The port ran the same per-Gaussian function as ~200 torch ops over
// the N rows: the SH table concatenated and read back as 16 stride-16
// slices, and scalar constants copied from pageable host memory, each copy
// making the host wait for the device. This kernel is that function in one
// pass, with the same float32 operations in the same order as
// sugar_tpu_torch/raster/preprocess.py `preprocess` and core/sh.py
// `eval_sh` (explicit round-to-nearest intrinsics: no FMA contraction;
// division and sqrt correctly rounded; NaN propagating as torch.maximum,
// torch.minimum and torch.clamp propagate it; the small matrix products as
// torch takes them on the card, `affine_mv` and `affine_mm`).
//
//   per Gaussian g < n:
//     in:  xyz (n, 3), opacity_logit (n,), log_scales (n, 3), quaternions
//          (n, 4) raw, sh_dc (n, 3), sh_rest (n, 3, rest) of which the
//          first (deg + 1)^2 - 1 of each channel, or colors (n, C) in place
//          of SH; alive (n,) bool and ndc_offset (n, 2), both optional
//     camera (on the device): viewmatrix, projmatrix (4, 4), campos (3,)
//     out: mean2d (n, 2), depth (n,), conic (n, 3), opacity (n,), color
//          (n, C), radius (n,) int32, rect_min, rect_max (n, 2) int32,
//          tiles_touched (n,) int32
//
// Bound on an H100 SXM: bytes. At SH 3 a Gaussian reads 12 + 4 + 12 + 16 +
// 12 + 180 + 1 = 237 bytes and writes 64: about 0.18 ms for 2M Gaussians
// at 3.35 TB/s. The ~300 flops a Gaussian are ~0.01 ms at 67 TFLOP/s.
//
// Design: one thread a Gaussian, kBlock Gaussians a block. The rows are
// narrow and not 16-byte aligned (xyz 12 bytes, sh_rest 180), so a thread
// walking its own row would touch a new sector on every load. Instead the
// block copies each field's rows (one contiguous range of device memory)
// into shared memory, 16 bytes a load where the range allows, neighbouring
// threads on neighbouring addresses; at a lower active SH degree only the
// active coefficients of each channel are copied, one float a load. The
// camera is copied once a block. Each thread then computes from shared
// memory. conic and the SH colour, 12-byte rows, go back through shared
// memory so that their stores are contiguous too; a colors override is
// copied range to range.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTile = 16;
// The port's constants (raster/common.py), rounded from double to float as
// torch rounds a Python scalar.
constexpr float kZCull = static_cast<float>(0.2);
constexpr float kWEps = static_cast<float>(1e-7);
constexpr float kLowpass = static_cast<float>(0.3);
constexpr float kRadiusSigma = 3.0f;
constexpr float kNormEps = static_cast<float>(1e-12);
constexpr float kDiscFloor = static_cast<float>(0.1);
constexpr float kRadiusMax = 1073741824.0f;  // 2^30

constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
__constant__ float kC2[5] = {
    static_cast<float>(1.0925484305920792), static_cast<float>(-1.0925484305920792),
    static_cast<float>(0.31539156525252005), static_cast<float>(-1.0925484305920792),
    static_cast<float>(0.5462742152960396)};
__constant__ float kC3[7] = {
    static_cast<float>(-0.5900435899266435), static_cast<float>(2.890611442640554),
    static_cast<float>(-0.4570457994644658), static_cast<float>(0.3731763325901154),
    static_cast<float>(-0.4570457994644658), static_cast<float>(1.445305721320277),
    static_cast<float>(-0.5900435899266435)};
__constant__ float kC4[9] = {
    static_cast<float>(2.5033429417967046), static_cast<float>(-1.7701307697799304),
    static_cast<float>(0.9461746957575601), static_cast<float>(-0.6690465435572892),
    static_cast<float>(0.10578554691520431), static_cast<float>(-0.6690465435572892),
    static_cast<float>(0.47308734787878004), static_cast<float>(-1.7701307697799304),
    static_cast<float>(0.6258357354491761)};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
// torch.maximum / torch.minimum: a NaN in either operand is the result.
__device__ __forceinline__ float tmax(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float tmin(float a, float b) { return (a != a || a < b) ? a : b; }

// Row i of a (4, 4) matrix applied to (p, 1) as torch takes it on the
// card: a matrix-vector product (the depth) sums the rounded products left
// to right; a matrix product (the view-space point, the homogeneous
// projection) chains fused multiply-adds over k = 0, 1, 2. The bias is a
// separate add in both.
__device__ __forceinline__ float affine_mv(const float* row, float x, float y, float z) {
  return add(add(add(mul(x, row[0]), mul(y, row[1])), mul(z, row[2])), row[3]);
}
__device__ __forceinline__ float affine_mm(const float* row, float x, float y, float z) {
  return add(__fmaf_rn(z, row[2], __fmaf_rn(y, row[1], mul(x, row[0]))), row[3]);
}

// raster/preprocess.py `_tile_index`: NaN to 0, clamp to [-1, hi + 1],
// truncate toward zero, clamp to [0, hi].
__device__ __forceinline__ int tile_index(float x, int hi) {
  if (x != x) x = 0.0f;
  x = fminf(fmaxf(x, -1.0f), static_cast<float>(hi + 1));
  const int i = static_cast<int>(x);
  return min(max(i, 0), hi);
}

// Copy len floats from src (4-byte aligned) into dst: 16-byte loads over
// the aligned middle, one float at each ragged end.
__device__ void stage(float* dst, const float* __restrict__ src, int len) {
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min(len, ((16 - misalign) & 15) >> 2);
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const int n4 = (len - head) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
#pragma unroll 4
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 v = s4[i];
    float* d = dst + head + 4 * i;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int i = head + 4 * n4 + threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
}

// The first seg floats of each of the 3 channels of rows rows of sh_rest
// (row stride 3 * rest), packed as rows of 3 * seg.
__device__ void stage_active(float* dst, const float* __restrict__ src, int rows, int rest,
                             int seg) {
  const int width = 3 * seg;
  for (int e = threadIdx.x; e < rows * width; e += blockDim.x) {
    const int r = e / width;
    const int k = e - r * width;
    const int c = k / seg;
    dst[e] = src[static_cast<long long>(r) * 3 * rest + c * rest + (k - c * seg)];
  }
}

// core/sh.py `eval_sh` for one channel: sh[0] the DC coefficient, sh[1..]
// the active rest, (x, y, z) the unit direction.
__device__ float eval_sh(int deg, float dc, const float* sh, float x, float y, float z) {
  float result = mul(kC0, dc);
  if (deg > 0) {
    result = sub(add(sub(result, mul(mul(kC1, y), sh[0])), mul(mul(kC1, z), sh[1])),
                 mul(mul(kC1, x), sh[2]));
    if (deg > 1) {
      const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
      const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
      result = add(result, mul(mul(kC2[0], xy), sh[3]));
      result = add(result, mul(mul(kC2[1], yz), sh[4]));
      result = add(result, mul(mul(kC2[2], sub(sub(mul(2.0f, zz), xx), yy)), sh[5]));
      result = add(result, mul(mul(kC2[3], xz), sh[6]));
      result = add(result, mul(mul(kC2[4], sub(xx, yy)), sh[7]));
      if (deg > 2) {
        const float zz4 = sub(sub(mul(4.0f, zz), xx), yy);
        result = add(result, mul(mul(mul(kC3[0], y), sub(mul(3.0f, xx), yy)), sh[8]));
        result = add(result, mul(mul(mul(kC3[1], xy), z), sh[9]));
        result = add(result, mul(mul(mul(kC3[2], y), zz4), sh[10]));
        result = add(result, mul(mul(mul(kC3[3], z),
                                     sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy))),
                                 sh[11]));
        result = add(result, mul(mul(mul(kC3[4], x), zz4), sh[12]));
        result = add(result, mul(mul(mul(kC3[5], z), sub(xx, yy)), sh[13]));
        result = add(result, mul(mul(mul(kC3[6], x), sub(xx, mul(3.0f, yy))), sh[14]));
        if (deg > 3) {
          const float zz7m1 = sub(mul(7.0f, zz), 1.0f);
          const float zz7m3 = sub(mul(7.0f, zz), 3.0f);
          result = add(result, mul(mul(mul(kC4[0], xy), sub(xx, yy)), sh[15]));
          result = add(result, mul(mul(mul(kC4[1], yz), sub(mul(3.0f, xx), yy)), sh[16]));
          result = add(result, mul(mul(mul(kC4[2], xy), zz7m1), sh[17]));
          result = add(result, mul(mul(mul(kC4[3], yz), zz7m3), sh[18]));
          result = add(result, mul(mul(kC4[4], add(mul(zz, sub(mul(35.0f, zz), 30.0f)), 3.0f)),
                                   sh[19]));
          result = add(result, mul(mul(mul(kC4[5], xz), zz7m3), sh[20]));
          result = add(result, mul(mul(mul(kC4[6], sub(xx, yy)), zz7m1), sh[21]));
          result = add(result, mul(mul(mul(kC4[7], xz), sub(xx, mul(3.0f, yy))), sh[22]));
          result = add(result,
                       mul(mul(kC4[8], sub(mul(xx, sub(xx, mul(3.0f, yy))),
                                           mul(yy, sub(mul(3.0f, xx), yy)))),
                           sh[23]));
        }
      }
    }
  }
  return result;
}

struct Params {
  const float* xyz;
  const float* opacity_logit;
  const float* log_scales;
  const float* quats;
  const float* sh_dc;
  const float* sh_rest;
  int rest;  // coefficients per channel in sh_rest's rows
  int deg;   // the active SH degree
  const float* colors;  // nullptr: SH
  int channels;
  const uint8_t* alive;  // nullptr: all alive
  const float* ndc_offset;  // nullptr: none
  const float* view;
  const float* proj;
  const float* campos;
  long long n;
  int width, height, tiles_x, tiles_y;
  float focal_x, focal_y, lim_x, lim_y, scale_mod;
  float* mean2d;
  float* depth;
  float* conic;
  float* opacity;
  float* color;
  int* radius;
  int* rect_min;
  int* rect_max;
  int* tiles;
};

// Floats of shared memory a block needs: the staged fields, then conic
// and the SH colour on their way out.
__host__ __device__ inline int shared_floats(const Params& p) {
  const bool sh = p.colors == nullptr;
  const int seg = (p.deg + 1) * (p.deg + 1) - 1;
  return kBlock * (3 + 3 + 4 + 1 + (sh ? 3 + 3 * seg : 0) + (p.ndc_offset ? 2 : 0) + 3 +
                   (sh ? 3 : 0));
}

__global__ void __launch_bounds__(kBlock) preprocess_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ float cam[35];  // view (16), proj (16), campos (3)
  const bool use_sh = p.colors == nullptr;
  const int seg = (p.deg + 1) * (p.deg + 1) - 1;
  const long long g0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int rows = static_cast<int>(min(static_cast<long long>(kBlock), p.n - g0));
  const int t = threadIdx.x;

  float* s_xyz = smem;
  float* s_ls = s_xyz + 3 * kBlock;
  float* s_q = s_ls + 3 * kBlock;
  float* s_op = s_q + 4 * kBlock;
  float* s_next = s_op + kBlock;
  float *s_dc = nullptr, *s_rest = nullptr, *s_ndc = nullptr;
  if (use_sh) {
    s_dc = s_next;
    s_rest = s_dc + 3 * kBlock;
    s_next = s_rest + 3 * seg * kBlock;
  }
  if (p.ndc_offset) {
    s_ndc = s_next;
    s_next += 2 * kBlock;
  }
  float* s_conic = s_next;
  float* s_color = s_conic + 3 * kBlock;

  if (t < 16) cam[t] = p.view[t];
  else if (t < 32) cam[t] = p.proj[t - 16];
  else if (t < 35) cam[t] = p.campos[t - 32];
  stage(s_xyz, p.xyz + 3 * g0, 3 * rows);
  stage(s_ls, p.log_scales + 3 * g0, 3 * rows);
  stage(s_q, p.quats + 4 * g0, 4 * rows);
  stage(s_op, p.opacity_logit + g0, rows);
  if (use_sh) {
    stage(s_dc, p.sh_dc + 3 * g0, 3 * rows);
    if (seg == p.rest) {
      stage(s_rest, p.sh_rest + 3 * seg * g0, 3 * seg * rows);
    } else if (seg > 0) {
      stage_active(s_rest, p.sh_rest + 3 * static_cast<long long>(p.rest) * g0, rows, p.rest,
                   seg);
    }
  }
  if (s_ndc) stage(s_ndc, p.ndc_offset + 2 * g0, 2 * rows);
  __syncthreads();

  if (t < rows) {
    const long long g = g0 + t;
    const float* V = cam;
    const float* P = cam + 16;
    const float X = s_xyz[3 * t], Y = s_xyz[3 * t + 1], Z = s_xyz[3 * t + 2];

    // Activations (models/gaussians.py): sigmoid as torch takes it on the
    // card, exp, the quaternion over max(norm, 1e-12).
    const float opac = dvd(1.0f, add(1.0f, expf(-s_op[t])));
    const float s0 = mul(p.scale_mod, expf(s_ls[3 * t]));
    const float s1 = mul(p.scale_mod, expf(s_ls[3 * t + 1]));
    const float s2 = mul(p.scale_mod, expf(s_ls[3 * t + 2]));
    const float qw0 = s_q[4 * t], qx0 = s_q[4 * t + 1], qy0 = s_q[4 * t + 2], qz0 = s_q[4 * t + 3];
    const float qn = tmax(
        root(add(add(add(mul(qw0, qw0), mul(qx0, qx0)), mul(qy0, qy0)), mul(qz0, qz0))), kNormEps);
    const float w = dvd(qw0, qn), x = dvd(qx0, qn), y = dvd(qy0, qn), z = dvd(qz0, qn);

    // Sigma = R diag(s^2) R^T in six channels (`_cov3d_channels`).
    float r[3][3];
    r[0][0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
    r[0][1] = mul(2.0f, sub(mul(x, y), mul(w, z)));
    r[0][2] = mul(2.0f, add(mul(x, z), mul(w, y)));
    r[1][0] = mul(2.0f, add(mul(x, y), mul(w, z)));
    r[1][1] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
    r[1][2] = mul(2.0f, sub(mul(y, z), mul(w, x)));
    r[2][0] = mul(2.0f, sub(mul(x, z), mul(w, y)));
    r[2][1] = mul(2.0f, add(mul(y, z), mul(w, x)));
    r[2][2] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
    const float q0 = mul(s0, s0), q1 = mul(s1, s1), q2 = mul(s2, s2);
    auto sig = [&](int i, int k) {
      return add(add(mul(mul(r[i][0], q0), r[k][0]), mul(mul(r[i][1], q1), r[k][1])),
                 mul(mul(r[i][2], q2), r[k][2]));
    };
    const float c00 = sig(0, 0), c01 = sig(0, 1), c02 = sig(0, 2);
    const float c11 = sig(1, 1), c12 = sig(1, 2), c22 = sig(2, 2);

    // EWA projection (`compute_cov2d`).
    const float t0 = affine_mm(V, X, Y, Z), t1 = affine_mm(V + 4, X, Y, Z);
    const float t2 = affine_mm(V + 8, X, Y, Z);
    const float tz = t2 > kZCull ? t2 : 1.0f;
    const float tx = mul(tmin(tmax(dvd(t0, tz), -p.lim_x), p.lim_x), tz);
    const float ty = mul(tmin(tmax(dvd(t1, tz), -p.lim_y), p.lim_y), tz);
    const float inv_z = dvd(1.0f, tz);
    const float inv_z2 = mul(inv_z, inv_z);
    const float j00 = mul(p.focal_x, inv_z);
    const float j02 = mul(mul(-p.focal_x, tx), inv_z2);
    const float j11 = mul(p.focal_y, inv_z);
    const float j12 = mul(mul(-p.focal_y, ty), inv_z2);
    float m0[3], m1[3];
    for (int k = 0; k < 3; ++k) {
      m0[k] = add(mul(j00, V[k]), mul(j02, V[8 + k]));
      m1[k] = add(mul(j11, V[4 + k]), mul(j12, V[8 + k]));
    }
    auto quad = [&](const float* a, const float* b) {
      const float u0 = add(add(mul(c00, b[0]), mul(c01, b[1])), mul(c02, b[2]));
      const float u1 = add(add(mul(c01, b[0]), mul(c11, b[1])), mul(c12, b[2]));
      const float u2 = add(add(mul(c02, b[0]), mul(c12, b[1])), mul(c22, b[2]));
      return add(add(mul(a[0], u0), mul(a[1], u1)), mul(a[2], u2));
    };
    const float cxx = add(quad(m0, m0), kLowpass);
    const float cyy = add(quad(m1, m1), kLowpass);
    const float cxy = quad(m0, m1);

    // Projection (forward.cu:197-200).
    const float depth = affine_mv(V + 8, X, Y, Z);
    const bool in_front = depth > kZCull;
    const float w_safe = in_front ? add(affine_mm(P + 12, X, Y, Z), kWEps) : 1.0f;
    const float p_w = dvd(1.0f, w_safe);
    float ndc_x = mul(affine_mm(P, X, Y, Z), p_w);
    float ndc_y = mul(affine_mm(P + 4, X, Y, Z), p_w);
    if (s_ndc) {
      ndc_x = add(ndc_x, s_ndc[2 * t]);
      ndc_y = add(ndc_y, s_ndc[2 * t + 1]);
    }
    const float mx = mul(sub(mul(add(ndc_x, 1.0f), static_cast<float>(p.width)), 1.0f), 0.5f);
    const float my = mul(sub(mul(add(ndc_y, 1.0f), static_cast<float>(p.height)), 1.0f), 0.5f);

    // Conic and radius (forward.cu:216-232).
    const float det = sub(mul(cxx, cyy), mul(cxy, cxy));
    const bool det_valid = det != 0.0f;
    const float inv_det = dvd(1.0f, det_valid ? det : 1.0f);
    const float mid = mul(0.5f, add(cxx, cyy));
    const float disc = root(tmax(sub(mul(mid, mid), det), kDiscFloor));
    const float lam_max = add(mid, disc);
    const float radius_f = ceilf(mul(kRadiusSigma, root(tmax(lam_max, 0.0f))));

    // Tile rect (auxiliary.h:46-56).
    const float tile = static_cast<float>(kTile);
    const int rmin_x = tile_index(dvd(sub(mx, radius_f), tile), p.tiles_x);
    const int rmin_y = tile_index(dvd(sub(my, radius_f), tile), p.tiles_y);
    const int rmax_x = tile_index(dvd(sub(add(add(mx, radius_f), tile), 1.0f), tile), p.tiles_x);
    const int rmax_y = tile_index(dvd(sub(add(add(my, radius_f), tile), 1.0f), tile), p.tiles_y);
    const bool alive = in_front && det_valid && (p.alive == nullptr || p.alive[g] != 0);
    const int tiles = alive ? (rmax_x - rmin_x) * (rmax_y - rmin_y) : 0;

    p.mean2d[2 * g] = mx;
    p.mean2d[2 * g + 1] = my;
    p.depth[g] = depth;
    p.opacity[g] = opac;
    p.radius[g] = tiles > 0 ? static_cast<int>(tmin(radius_f, kRadiusMax)) : 0;
    p.rect_min[2 * g] = rmin_x;
    p.rect_min[2 * g + 1] = rmin_y;
    p.rect_max[2 * g] = rmax_x;
    p.rect_max[2 * g + 1] = rmax_y;
    p.tiles[g] = tiles;
    s_conic[3 * t] = mul(cyy, inv_det);
    s_conic[3 * t + 1] = mul(-cxy, inv_det);
    s_conic[3 * t + 2] = mul(cxx, inv_det);

    if (use_sh) {
      // SH colour (`preprocess` + core/sh.py `sh_to_rgb`): the unit
      // direction from the camera, max(eval + 0.5, 0) per channel.
      float dx = sub(X, cam[32]), dy = sub(Y, cam[33]), dz = sub(Z, cam[34]);
      const float dn = tmax(root(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz))), kNormEps);
      dx = dvd(dx, dn);
      dy = dvd(dy, dn);
      dz = dvd(dz, dn);
      for (int c = 0; c < 3; ++c) {
        const float v = add(eval_sh(p.deg, s_dc[3 * t + c], s_rest + (3 * t + c) * seg, dx, dy, dz),
                            0.5f);
        s_color[3 * t + c] = tmax(v, 0.0f);
      }
    }
  }
  __syncthreads();
  for (int i = t; i < 3 * rows; i += kBlock) p.conic[3 * g0 + i] = s_conic[i];
  if (use_sh) {
    for (int i = t; i < 3 * rows; i += kBlock) p.color[3 * g0 + i] = s_color[i];
  } else {
    const long long base = static_cast<long long>(p.channels) * g0;
    for (long long i = t; i < static_cast<long long>(p.channels) * rows; i += kBlock) {
      p.color[base + i] = p.colors[base + i];
    }
  }
}

}  // namespace

extern "C" int sugar_preprocess_fields(
    const float* xyz, const float* opacity_logit, const float* log_scales, const float* quats,
    const float* sh_dc, const float* sh_rest, int rest, int sh_degree, const float* colors,
    int channels, const uint8_t* alive, const float* ndc_offset, const float* viewmatrix,
    const float* projmatrix, const float* campos, long long n, int width, int height,
    int tiles_x, int tiles_y, float focal_x, float focal_y, float lim_x, float lim_y,
    float scale_modifier, float* mean2d, float* depth, float* conic, float* opacity,
    float* color, int* radius, int* rect_min, int* rect_max, int* tiles_touched,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  if (sh_degree < 0 || sh_degree > 4) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{xyz, opacity_logit, log_scales, quats, sh_dc, sh_rest, rest, sh_degree, colors,
                 channels, alive, ndc_offset, viewmatrix, projmatrix, campos, n, width, height,
                 tiles_x, tiles_y, focal_x, focal_y, lim_x, lim_y, scale_modifier, mean2d,
                 depth, conic, opacity, color, radius, rect_min, rect_max, tiles_touched};
  const size_t smem = sizeof(float) * static_cast<size_t>(shared_floats(p));
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  preprocess_kernel<<<static_cast<unsigned>(blocks), kBlock, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
