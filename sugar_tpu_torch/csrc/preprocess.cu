// Preprocess of a render from the model's raw fields, and its backward,
// written for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package preprocesses with XLA ops
// (sugar_tpu/raster/preprocess.py `preprocess`, sugar_tpu/core/sh.py
// `eval_sh`, the activations of sugar_tpu/models/render.py), which XLA
// fuses, and differentiates them with jax.vjp. The port ran the same
// per-Gaussian function as ~370 torch ops over the N rows and its VJP as
// ~700 more: the SH table concatenated and read back as 16 stride-16
// slices (each slice's backward a zero-filled table), and scalar constants
// copied from pageable host memory, each copy making the host wait for the
// device. The forward kernel is that function in one pass, with the same
// float32 operations in the same order as
// sugar_tpu_torch/raster/preprocess.py `preprocess` and core/sh.py
// `eval_sh` (explicit round-to-nearest intrinsics: no FMA contraction;
// division and sqrt correctly rounded; NaN propagating as torch.maximum,
// torch.minimum and torch.clamp propagate it; the small matrix products as
// torch takes them on the card, `affine_mv` and `affine_mm`). The backward
// kernel is its VJP in one pass.
//
//   forward, per Gaussian g < n:
//     in:  xyz (n, 3), opacity_logit (n,), log_scales (n, 3), quaternions
//          (n, 4) raw, sh_dc (n, 3), sh_rest (n, 3, rest) of which the
//          first (deg + 1)^2 - 1 of each channel, or colors (n, C) in place
//          of SH; alive (n,) bool and ndc_offset (n, 2), both optional
//     camera (on the device): viewmatrix, projmatrix (4, 4), campos (3,)
//     out: mean2d (n, 2), depth (n,), conic (n, 3), opacity (n,), color
//          (n, C), radius (n,) int32, rect_min, rect_max (n, 2) int32,
//          tiles_touched (n,) int32
//   backward, per Gaussian: the same fields (no alive, no ndc_offset) and
//     camera, and the cotangents of mean2d, conic, opacity and (with SH)
//     color; out: the gradients of xyz, opacity_logit, log_scales, the raw
//     quaternions, sh_dc, sh_rest (zeros beyond the active degree) and,
//     when asked, ndc_offset. depth, radius, the rects and tiles_touched
//     carry no gradient; a colors override's gradient is its cotangent,
//     which the caller passes on.
//   "built" instantiation (template kBuilt, both passes): the scales and
//     unit quaternions arrive built (the refined model's mesh-bound
//     Gaussians) in place of log_scales and raw quaternions: no exp, no
//     normalisation, and their gradients are those of the built fields.
//
// Bound on an H100 SXM: bytes. At SH 3 the forward reads 12 + 4 + 12 + 16
// + 12 + 180 + 1 = 237 bytes a Gaussian and writes 64: about 0.18 ms for
// 2M Gaussians at 3.35 TB/s. The backward reads 236 bytes of fields and 36
// of cotangents and writes 12 + 4 + 12 + 16 + 12 + 180 + 8 = 244 bytes of
// gradients: about 0.31 ms for 2M Gaussians. The ~300 flops a Gaussian of
// the forward and ~900 of the backward are 0.01-0.03 ms at 67 TFLOP/s.
//
// Design: one thread a Gaussian, kBlock Gaussians a block. The rows are
// narrow and not 16-byte aligned (xyz 12 bytes, sh_rest 180), so a thread
// walking its own row would touch a new sector on every load. Instead the
// block copies each field's rows (one contiguous range of device memory)
// into shared memory, 16 bytes a load where the range allows, neighbouring
// threads on neighbouring addresses; at a lower active SH degree only the
// active coefficients of each channel are copied, one float a load. The
// camera is copied once a block. Each thread then computes from shared
// memory. In the forward, conic and the SH colour, 12-byte rows, go back
// through shared memory so that their stores are contiguous too; a colors
// override is copied range to range. The backward recomputes the forward
// in registers (`project`, `eval_sh`: the forward's arithmetic, so that
// the ties of the clamps fall where the forward's did), so nothing but the
// inputs is kept between the passes, then takes the chain rule back
// through the conic's inverse, the EWA cov2D with the 1.3 tan clamp, Sigma
// = R diag(s^2) R^T, the quaternion normalisation, exp and sigmoid, the
// projection and SH degrees 0-4 with the view direction's normalisation.
// Each thread writes its gradients over its own staged rows, and the block
// stores every field range to range (sh_rest's rows widened with zeros
// beyond the active degree). Ties follow the torch route: torch.maximum,
// torch.minimum and the clip built from them pass half a tie's gradient,
// and a torch.where guard passes none to its culled side.

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

// tmax(a, b)'s and tmin(a, b)'s derivative in a, as torch.maximum's and
// torch.minimum's backward take it: half at a tie, all of it for a NaN.
__device__ __forceinline__ float dmax(float a, float b) {
  return a < b ? 0.0f : (a == b ? 0.5f : 1.0f);
}
__device__ __forceinline__ float dmin(float a, float b) {
  return a > b ? 0.0f : (a == b ? 0.5f : 1.0f);
}

// Copy len floats from src (shared memory) to dst (4-byte aligned): the
// mirror of `stage`.
__device__ void unstage(float* __restrict__ dst, const float* src, int len) {
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  const int head = min(len, ((16 - misalign) & 15) >> 2);
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const int n4 = (len - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
#pragma unroll 4
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const float* s = src + head + 4 * i;
    d4[i] = make_float4(s[0], s[1], s[2], s[3]);
  }
  for (int i = head + 4 * n4 + threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
}

// The mirror of `stage_active`: rows of 3 * seg packed floats widened to
// rows of 3 * rest, zeros beyond the first seg of each channel.
__device__ void unstage_active(float* __restrict__ dst, const float* src, int rows, int rest,
                               int seg) {
  const int width = 3 * rest;
  for (int e = threadIdx.x; e < rows * width; e += blockDim.x) {
    const int r = e / width;
    const int k = e - r * width;
    const int c = k / rest;
    const int j = k - c * rest;
    dst[e] = j < seg ? src[r * 3 * seg + c * seg + j] : 0.0f;
  }
}

// The VJP of `eval_sh` for one channel at cotangent g: sh[k] (the active
// rest) is replaced by its gradient g * basis_k(x, y, z), and g * sum_k
// sh[k] d basis_k / d(x, y, z) is added to (gx, gy, gz). The DC term's
// gradient, g * C0, is the caller's.
__device__ void eval_sh_bwd(int deg, float* sh, float x, float y, float z, float g, float& gx,
                            float& gy, float& gz) {
  if (deg < 1) return;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float c;
  c = sh[0]; sh[0] = g * (-kC1 * y); dy -= kC1 * c;
  c = sh[1]; sh[1] = g * (kC1 * z); dz += kC1 * c;
  c = sh[2]; sh[2] = g * (-kC1 * x); dx -= kC1 * c;
  if (deg > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    c = sh[3]; sh[3] = g * (kC2[0] * xy);
    dx += c * kC2[0] * y; dy += c * kC2[0] * x;
    c = sh[4]; sh[4] = g * (kC2[1] * yz);
    dy += c * kC2[1] * z; dz += c * kC2[1] * y;
    c = sh[5]; sh[5] = g * (kC2[2] * (2.0f * zz - xx - yy));
    dx -= c * kC2[2] * 2.0f * x; dy -= c * kC2[2] * 2.0f * y; dz += c * kC2[2] * 4.0f * z;
    c = sh[6]; sh[6] = g * (kC2[3] * xz);
    dx += c * kC2[3] * z; dz += c * kC2[3] * x;
    c = sh[7]; sh[7] = g * (kC2[4] * (xx - yy));
    dx += c * kC2[4] * 2.0f * x; dy -= c * kC2[4] * 2.0f * y;
    if (deg > 2) {
      const float zz4 = 4.0f * zz - xx - yy;
      c = sh[8]; sh[8] = g * (kC3[0] * y * (3.0f * xx - yy));
      dx += c * kC3[0] * 6.0f * xy; dy += c * kC3[0] * 3.0f * (xx - yy);
      c = sh[9]; sh[9] = g * (kC3[1] * xy * z);
      dx += c * kC3[1] * yz; dy += c * kC3[1] * xz; dz += c * kC3[1] * xy;
      c = sh[10]; sh[10] = g * (kC3[2] * y * zz4);
      dx -= c * kC3[2] * 2.0f * xy; dy += c * kC3[2] * (zz4 - 2.0f * yy);
      dz += c * kC3[2] * 8.0f * yz;
      c = sh[11]; sh[11] = g * (kC3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy));
      dx -= c * kC3[3] * 6.0f * xz; dy -= c * kC3[3] * 6.0f * yz;
      dz += c * kC3[3] * (6.0f * zz - 3.0f * xx - 3.0f * yy);
      c = sh[12]; sh[12] = g * (kC3[4] * x * zz4);
      dx += c * kC3[4] * (zz4 - 2.0f * xx); dy -= c * kC3[4] * 2.0f * xy;
      dz += c * kC3[4] * 8.0f * xz;
      c = sh[13]; sh[13] = g * (kC3[5] * z * (xx - yy));
      dx += c * kC3[5] * 2.0f * xz; dy -= c * kC3[5] * 2.0f * yz; dz += c * kC3[5] * (xx - yy);
      c = sh[14]; sh[14] = g * (kC3[6] * x * (xx - 3.0f * yy));
      dx += c * kC3[6] * 3.0f * (xx - yy); dy -= c * kC3[6] * 6.0f * xy;
      if (deg > 3) {
        const float zz7m1 = 7.0f * zz - 1.0f, zz7m3 = 7.0f * zz - 3.0f;
        c = sh[15]; sh[15] = g * (kC4[0] * xy * (xx - yy));
        dx += c * kC4[0] * y * (3.0f * xx - yy); dy += c * kC4[0] * x * (xx - 3.0f * yy);
        c = sh[16]; sh[16] = g * (kC4[1] * yz * (3.0f * xx - yy));
        dx += c * kC4[1] * 6.0f * xy * z; dy += c * kC4[1] * 3.0f * z * (xx - yy);
        dz += c * kC4[1] * y * (3.0f * xx - yy);
        c = sh[17]; sh[17] = g * (kC4[2] * xy * zz7m1);
        dx += c * kC4[2] * y * zz7m1; dy += c * kC4[2] * x * zz7m1;
        dz += c * kC4[2] * 14.0f * xy * z;
        c = sh[18]; sh[18] = g * (kC4[3] * yz * zz7m3);
        dy += c * kC4[3] * z * zz7m3; dz += c * kC4[3] * y * (21.0f * zz - 3.0f);
        c = sh[19]; sh[19] = g * (kC4[4] * (zz * (35.0f * zz - 30.0f) + 3.0f));
        dz += c * kC4[4] * z * (140.0f * zz - 60.0f);
        c = sh[20]; sh[20] = g * (kC4[5] * xz * zz7m3);
        dx += c * kC4[5] * z * zz7m3; dz += c * kC4[5] * x * (21.0f * zz - 3.0f);
        c = sh[21]; sh[21] = g * (kC4[6] * (xx - yy) * zz7m1);
        dx += c * kC4[6] * 2.0f * x * zz7m1; dy -= c * kC4[6] * 2.0f * y * zz7m1;
        dz += c * kC4[6] * 14.0f * z * (xx - yy);
        c = sh[22]; sh[22] = g * (kC4[7] * xz * (xx - 3.0f * yy));
        dx += c * kC4[7] * 3.0f * z * (xx - yy); dy -= c * kC4[7] * 6.0f * xy * z;
        dz += c * kC4[7] * x * (xx - 3.0f * yy);
        c = sh[23]; sh[23] = g * (kC4[8] * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy)));
        dx += c * kC4[8] * 4.0f * x * (xx - 3.0f * yy);
        dy += c * kC4[8] * 4.0f * y * (yy - 3.0f * xx);
      }
    }
  }
  gx += g * dx;
  gy += g * dy;
  gz += g * dz;
}

// One Gaussian's forward values that both passes need, computed by
// `project` with the forward's arithmetic.
struct Splat {
  float e[3];           // exp(log_scales), or the built scales
  float s[3];           // scale_modifier * e
  float qnorm, qn;      // |q| and max(|q|, 1e-12) of the raw quaternion
  float w, x, y, z;     // the unit quaternion
  float r[3][3];        // its rotation
  float v[3];           // s^2
  float c00, c01, c02, c11, c12, c22;  // Sigma
  float t0, t1, t2, tz;  // view-space point; tz the guarded depth
  float u0, u1, cu0, cu1, tx, ty;  // t / tz, clipped, times tz
  float inv_z, inv_z2, j00, j02, j11, j12;
  float m0[3], m1[3];   // J W
  float cxx, cyy, cxy;  // cov2D
  float depth, p_w, ph0, ph1;
  bool in_front;
  float det, inv_det;
  bool det_valid;
};

// The forward of one Gaussian up to cov2D, the projection and the conic's
// inverse determinant (`_cov3d_channels`, `compute_cov2d`, `preprocess`).
// ls and q are its log scales and raw quaternion, or (kBuilt) its scales
// and unit quaternion.
template <bool kBuilt>
__device__ __forceinline__ void project(Splat& g, const float* cam, float X, float Y, float Z,
                                        const float* ls, const float* q, float scale_mod,
                                        float focal_x, float focal_y, float lim_x, float lim_y) {
  const float* V = cam;
  const float* P = cam + 16;
  // Activations (models/gaussians.py): exp, the quaternion over max(norm,
  // 1e-12).
  for (int k = 0; k < 3; ++k) {
    g.e[k] = kBuilt ? ls[k] : expf(ls[k]);
    g.s[k] = mul(scale_mod, g.e[k]);
  }
  if (kBuilt) {
    g.qnorm = g.qn = 1.0f;
    g.w = q[0], g.x = q[1], g.y = q[2], g.z = q[3];
  } else {
    g.qnorm = root(add(add(add(mul(q[0], q[0]), mul(q[1], q[1])), mul(q[2], q[2])),
                       mul(q[3], q[3])));
    g.qn = tmax(g.qnorm, kNormEps);
    g.w = dvd(q[0], g.qn), g.x = dvd(q[1], g.qn), g.y = dvd(q[2], g.qn), g.z = dvd(q[3], g.qn);
  }
  const float w = g.w, x = g.x, y = g.y, z = g.z;

  // Sigma = R diag(s^2) R^T in six channels (`_cov3d_channels`).
  g.r[0][0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  g.r[0][1] = mul(2.0f, sub(mul(x, y), mul(w, z)));
  g.r[0][2] = mul(2.0f, add(mul(x, z), mul(w, y)));
  g.r[1][0] = mul(2.0f, add(mul(x, y), mul(w, z)));
  g.r[1][1] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  g.r[1][2] = mul(2.0f, sub(mul(y, z), mul(w, x)));
  g.r[2][0] = mul(2.0f, sub(mul(x, z), mul(w, y)));
  g.r[2][1] = mul(2.0f, add(mul(y, z), mul(w, x)));
  g.r[2][2] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
  for (int k = 0; k < 3; ++k) g.v[k] = mul(g.s[k], g.s[k]);
  auto sig = [&](int i, int k) {
    return add(add(mul(mul(g.r[i][0], g.v[0]), g.r[k][0]), mul(mul(g.r[i][1], g.v[1]), g.r[k][1])),
               mul(mul(g.r[i][2], g.v[2]), g.r[k][2]));
  };
  g.c00 = sig(0, 0), g.c01 = sig(0, 1), g.c02 = sig(0, 2);
  g.c11 = sig(1, 1), g.c12 = sig(1, 2), g.c22 = sig(2, 2);

  // EWA projection (`compute_cov2d`).
  g.t0 = affine_mm(V, X, Y, Z), g.t1 = affine_mm(V + 4, X, Y, Z);
  g.t2 = affine_mm(V + 8, X, Y, Z);
  g.tz = g.t2 > kZCull ? g.t2 : 1.0f;
  g.u0 = dvd(g.t0, g.tz);
  g.u1 = dvd(g.t1, g.tz);
  g.cu0 = tmin(tmax(g.u0, -lim_x), lim_x);
  g.cu1 = tmin(tmax(g.u1, -lim_y), lim_y);
  g.tx = mul(g.cu0, g.tz);
  g.ty = mul(g.cu1, g.tz);
  g.inv_z = dvd(1.0f, g.tz);
  g.inv_z2 = mul(g.inv_z, g.inv_z);
  g.j00 = mul(focal_x, g.inv_z);
  g.j02 = mul(mul(-focal_x, g.tx), g.inv_z2);
  g.j11 = mul(focal_y, g.inv_z);
  g.j12 = mul(mul(-focal_y, g.ty), g.inv_z2);
  for (int k = 0; k < 3; ++k) {
    g.m0[k] = add(mul(g.j00, V[k]), mul(g.j02, V[8 + k]));
    g.m1[k] = add(mul(g.j11, V[4 + k]), mul(g.j12, V[8 + k]));
  }
  auto quad = [&](const float* a, const float* b) {
    const float u0 = add(add(mul(g.c00, b[0]), mul(g.c01, b[1])), mul(g.c02, b[2]));
    const float u1 = add(add(mul(g.c01, b[0]), mul(g.c11, b[1])), mul(g.c12, b[2]));
    const float u2 = add(add(mul(g.c02, b[0]), mul(g.c12, b[1])), mul(g.c22, b[2]));
    return add(add(mul(a[0], u0), mul(a[1], u1)), mul(a[2], u2));
  };
  g.cxx = add(quad(g.m0, g.m0), kLowpass);
  g.cyy = add(quad(g.m1, g.m1), kLowpass);
  g.cxy = quad(g.m0, g.m1);

  // Projection (forward.cu:197-200).
  g.depth = affine_mv(V + 8, X, Y, Z);
  g.in_front = g.depth > kZCull;
  const float w_safe = g.in_front ? add(affine_mm(P + 12, X, Y, Z), kWEps) : 1.0f;
  g.p_w = dvd(1.0f, w_safe);
  g.ph0 = affine_mm(P, X, Y, Z);
  g.ph1 = affine_mm(P + 4, X, Y, Z);

  // The conic's inverse determinant (forward.cu:216-222).
  g.det = sub(mul(g.cxx, g.cyy), mul(g.cxy, g.cxy));
  g.det_valid = g.det != 0.0f;
  g.inv_det = dvd(1.0f, g.det_valid ? g.det : 1.0f);
}

// The unit direction from the camera centre (cam[32..34]) to (X, Y, Z)
// over max(norm, 1e-12), as `preprocess` takes it; dnorm the norm.
__device__ __forceinline__ void view_dir(const float* cam, float X, float Y, float Z, float* d,
                                         float* d0, float& dnorm, float& dn) {
  d0[0] = sub(X, cam[32]), d0[1] = sub(Y, cam[33]), d0[2] = sub(Z, cam[34]);
  dnorm = root(add(add(mul(d0[0], d0[0]), mul(d0[1], d0[1])), mul(d0[2], d0[2])));
  dn = tmax(dnorm, kNormEps);
  for (int k = 0; k < 3; ++k) d[k] = dvd(d0[k], dn);
}

struct Params {
  const float* xyz;
  const float* opacity_logit;
  const float* log_scales;  // kBuilt: the scales
  const float* quats;       // kBuilt: the unit quaternions
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

template <bool kBuilt>
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
    const long long gi = g0 + t;
    const float X = s_xyz[3 * t], Y = s_xyz[3 * t + 1], Z = s_xyz[3 * t + 2];
    Splat g;
    project<kBuilt>(g, cam, X, Y, Z, s_ls + 3 * t, s_q + 4 * t, p.scale_mod, p.focal_x,
                    p.focal_y, p.lim_x, p.lim_y);
    // Sigmoid as torch takes it on the card.
    const float opac = dvd(1.0f, add(1.0f, expf(-s_op[t])));

    float ndc_x = mul(g.ph0, g.p_w);
    float ndc_y = mul(g.ph1, g.p_w);
    if (s_ndc) {
      ndc_x = add(ndc_x, s_ndc[2 * t]);
      ndc_y = add(ndc_y, s_ndc[2 * t + 1]);
    }
    const float mx = mul(sub(mul(add(ndc_x, 1.0f), static_cast<float>(p.width)), 1.0f), 0.5f);
    const float my = mul(sub(mul(add(ndc_y, 1.0f), static_cast<float>(p.height)), 1.0f), 0.5f);

    // Radius (forward.cu:227-232).
    const float mid = mul(0.5f, add(g.cxx, g.cyy));
    const float disc = root(tmax(sub(mul(mid, mid), g.det), kDiscFloor));
    const float lam_max = add(mid, disc);
    const float radius_f = ceilf(mul(kRadiusSigma, root(tmax(lam_max, 0.0f))));

    // Tile rect (auxiliary.h:46-56).
    const float tile = static_cast<float>(kTile);
    const int rmin_x = tile_index(dvd(sub(mx, radius_f), tile), p.tiles_x);
    const int rmin_y = tile_index(dvd(sub(my, radius_f), tile), p.tiles_y);
    const int rmax_x = tile_index(dvd(sub(add(add(mx, radius_f), tile), 1.0f), tile), p.tiles_x);
    const int rmax_y = tile_index(dvd(sub(add(add(my, radius_f), tile), 1.0f), tile), p.tiles_y);
    const bool alive = g.in_front && g.det_valid && (p.alive == nullptr || p.alive[gi] != 0);
    const int tiles = alive ? (rmax_x - rmin_x) * (rmax_y - rmin_y) : 0;

    p.mean2d[2 * gi] = mx;
    p.mean2d[2 * gi + 1] = my;
    p.depth[gi] = g.depth;
    p.opacity[gi] = opac;
    p.radius[gi] = tiles > 0 ? static_cast<int>(tmin(radius_f, kRadiusMax)) : 0;
    p.rect_min[2 * gi] = rmin_x;
    p.rect_min[2 * gi + 1] = rmin_y;
    p.rect_max[2 * gi] = rmax_x;
    p.rect_max[2 * gi + 1] = rmax_y;
    p.tiles[gi] = tiles;
    s_conic[3 * t] = mul(g.cyy, g.inv_det);
    s_conic[3 * t + 1] = mul(-g.cxy, g.inv_det);
    s_conic[3 * t + 2] = mul(g.cxx, g.inv_det);

    if (use_sh) {
      // SH colour (`preprocess` + core/sh.py `sh_to_rgb`): the unit
      // direction from the camera, max(eval + 0.5, 0) per channel.
      float d[3], d0[3], dnorm, dn;
      view_dir(cam, X, Y, Z, d, d0, dnorm, dn);
      for (int c = 0; c < 3; ++c) {
        const float v = add(
            eval_sh(p.deg, s_dc[3 * t + c], s_rest + (3 * t + c) * seg, d[0], d[1], d[2]), 0.5f);
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

struct BwdParams {
  const float* xyz;
  const float* opacity_logit;
  const float* log_scales;  // kBuilt: the scales
  const float* quats;       // kBuilt: the unit quaternions
  const float* sh_dc;       // nullptr: a colors override, no SH
  const float* sh_rest;
  int rest, deg;
  const float* view;
  const float* proj;
  const float* campos;
  long long n;
  int width, height;
  float focal_x, focal_y, lim_x, lim_y, scale_mod;
  const float* g_mean2d;  // the cotangents
  const float* g_conic;
  const float* g_opacity;
  const float* g_color;  // (n, 3); unread without SH
  float* g_xyz;  // the gradients
  float* g_opacity_logit;
  float* g_log_scales;  // kBuilt: of the scales
  float* g_quats;       // kBuilt: of the unit quaternions
  float* g_sh_dc;
  float* g_sh_rest;  // (n, 3, rest)
  float* g_ndc;      // (n, 2); nullptr: not asked
};

// Floats of shared memory a backward block needs: the staged fields, the
// conic's and (with SH) the colour's cotangents.
__host__ __device__ inline int bwd_shared_floats(const BwdParams& p) {
  const bool sh = p.sh_dc != nullptr;
  const int seg = (p.deg + 1) * (p.deg + 1) - 1;
  return kBlock * (3 + 3 + 4 + 1 + (sh ? 3 + 3 * seg + 3 : 0) + 3);
}

template <bool kBuilt>
__global__ void __launch_bounds__(kBlock) preprocess_bwd_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  __shared__ float cam[35];  // view (16), proj (16), campos (3)
  const bool use_sh = p.sh_dc != nullptr;
  const int seg = (p.deg + 1) * (p.deg + 1) - 1;
  const long long g0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int rows = static_cast<int>(min(static_cast<long long>(kBlock), p.n - g0));
  const int t = threadIdx.x;

  float* s_xyz = smem;
  float* s_ls = s_xyz + 3 * kBlock;
  float* s_q = s_ls + 3 * kBlock;
  float* s_op = s_q + 4 * kBlock;
  float* s_gconic = s_op + kBlock;
  float *s_dc = nullptr, *s_rest = nullptr, *s_gcolor = nullptr;
  if (use_sh) {
    s_dc = s_gconic + 3 * kBlock;
    s_gcolor = s_dc + 3 * kBlock;
    s_rest = s_gcolor + 3 * kBlock;
  }

  if (t < 16) cam[t] = p.view[t];
  else if (t < 32) cam[t] = p.proj[t - 16];
  else if (t < 35) cam[t] = p.campos[t - 32];
  stage(s_xyz, p.xyz + 3 * g0, 3 * rows);
  stage(s_ls, p.log_scales + 3 * g0, 3 * rows);
  stage(s_q, p.quats + 4 * g0, 4 * rows);
  stage(s_op, p.opacity_logit + g0, rows);
  stage(s_gconic, p.g_conic + 3 * g0, 3 * rows);
  if (use_sh) {
    stage(s_dc, p.sh_dc + 3 * g0, 3 * rows);
    stage(s_gcolor, p.g_color + 3 * g0, 3 * rows);
    if (seg == p.rest) {
      stage(s_rest, p.sh_rest + 3 * seg * g0, 3 * seg * rows);
    } else if (seg > 0) {
      stage_active(s_rest, p.sh_rest + 3 * static_cast<long long>(p.rest) * g0, rows, p.rest,
                   seg);
    }
  }
  __syncthreads();

  if (t < rows) {
    const long long gi = g0 + t;
    const float* V = cam;
    const float* P = cam + 16;
    const float X = s_xyz[3 * t], Y = s_xyz[3 * t + 1], Z = s_xyz[3 * t + 2];
    Splat g;
    project<kBuilt>(g, cam, X, Y, Z, s_ls + 3 * t, s_q + 4 * t, p.scale_mod, p.focal_x,
                    p.focal_y, p.lim_x, p.lim_y);
    const float opac = dvd(1.0f, add(1.0f, expf(-s_op[t])));
    const float g_op = p.g_opacity[gi];
    const float g_mx = p.g_mean2d[2 * gi], g_my = p.g_mean2d[2 * gi + 1];
    const float g_c0 = s_gconic[3 * t], g_c1 = s_gconic[3 * t + 1], g_c2 = s_gconic[3 * t + 2];

    // sigmoid: y (1 - y).
    const float g_ol = g_op * (1.0f - opac) * opac;

    // conic = (cyy, -cxy, cxx) / det, det = cxx cyy - cxy^2 (the guard
    // passes nothing where det == 0).
    float g_cxx = g_c2 * g.inv_det, g_cyy = g_c0 * g.inv_det, g_cxy = -g_c1 * g.inv_det;
    if (g.det_valid) {
      const float g_inv = g_c0 * g.cyy - g_c1 * g.cxy + g_c2 * g.cxx;
      const float g_det = -g_inv * g.inv_det * g.inv_det;
      g_cxx += g_det * g.cyy;
      g_cyy += g_det * g.cxx;
      g_cxy -= 2.0f * g_det * g.cxy;
    }

    // cov2D = (m0' S m0 + 0.3, m0' S m1, m1' S m1 + 0.3).
    const float* m0 = g.m0;
    const float* m1 = g.m1;
    float sm0[3], sm1[3];
    {
      const float S[3][3] = {{g.c00, g.c01, g.c02}, {g.c01, g.c11, g.c12},
                             {g.c02, g.c12, g.c22}};
      for (int i = 0; i < 3; ++i) {
        sm0[i] = S[i][0] * m0[0] + S[i][1] * m0[1] + S[i][2] * m0[2];
        sm1[i] = S[i][0] * m1[0] + S[i][1] * m1[1] + S[i][2] * m1[2];
      }
    }
    float g_m0[3], g_m1[3];
    for (int i = 0; i < 3; ++i) {
      g_m0[i] = 2.0f * g_cxx * sm0[i] + g_cxy * sm1[i];
      g_m1[i] = 2.0f * g_cyy * sm1[i] + g_cxy * sm0[i];
    }
    // Sigma's six channels; G[i][k] the gradient of the full symmetric
    // matrix's entry (an off-diagonal channel's gradient shared by its two
    // entries).
    float G[3][3];
    for (int i = 0; i < 3; ++i) {
      for (int k = i; k < 3; ++k) {
        const float gik = g_cxx * m0[i] * m0[k] + g_cyy * m1[i] * m1[k] +
                          0.5f * g_cxy * (m0[i] * m1[k] + m0[k] * m1[i]);
        G[i][k] = G[k][i] = gik;
      }
    }

    // m0 = j00 W0 + j02 W2, m1 = j11 W1 + j12 W2 (W the view rows).
    float g_j00 = 0.0f, g_j02 = 0.0f, g_j11 = 0.0f, g_j12 = 0.0f;
    for (int k = 0; k < 3; ++k) {
      g_j00 += g_m0[k] * V[k];
      g_j02 += g_m0[k] * V[8 + k];
      g_j11 += g_m1[k] * V[4 + k];
      g_j12 += g_m1[k] * V[8 + k];
    }
    // j00 = fx / tz, j02 = -fx tx / tz^2, j11 = fy / tz, j12 = -fy ty / tz^2.
    const float g_tx = -g_j02 * p.focal_x * g.inv_z2;
    const float g_ty = -g_j12 * p.focal_y * g.inv_z2;
    const float g_inv_z2 = -g_j02 * p.focal_x * g.tx - g_j12 * p.focal_y * g.ty;
    const float g_inv_z = p.focal_x * g_j00 + p.focal_y * g_j11 + 2.0f * g_inv_z2 * g.inv_z;
    float g_tz = -g_inv_z * g.inv_z * g.inv_z;
    // tx = clip(t0 / tz) tz, ty = clip(t1 / tz) tz.
    g_tz += g_tx * g.cu0 + g_ty * g.cu1;
    const float g_u0 = g_tx * g.tz * dmin(tmax(g.u0, -p.lim_x), p.lim_x) * dmax(g.u0, -p.lim_x);
    const float g_u1 = g_ty * g.tz * dmin(tmax(g.u1, -p.lim_y), p.lim_y) * dmax(g.u1, -p.lim_y);
    const float g_t0 = g_u0 / g.tz;
    const float g_t1 = g_u1 / g.tz;
    g_tz -= (g_u0 * g.t0 + g_u1 * g.t1) / (g.tz * g.tz);
    const float g_t2 = g.t2 > kZCull ? g_tz : 0.0f;

    // mean2d = ((ph / w_safe + ndc_offset + 1) (W, H) - 1) / 2.
    const float g_nx = g_mx * 0.5f * static_cast<float>(p.width);
    const float g_ny = g_my * 0.5f * static_cast<float>(p.height);
    const float g_ph0 = g_nx * g.p_w, g_ph1 = g_ny * g.p_w;
    const float g_pw = g_nx * g.ph0 + g_ny * g.ph1;
    const float g_ph3 = g.in_front ? -g_pw * g.p_w * g.p_w : 0.0f;
    if (p.g_ndc) {
      p.g_ndc[2 * gi] = g_nx;
      p.g_ndc[2 * gi + 1] = g_ny;
    }

    float gp[3];
    for (int j = 0; j < 3; ++j) {
      gp[j] = V[j] * g_t0 + V[4 + j] * g_t1 + V[8 + j] * g_t2 + P[j] * g_ph0 + P[4 + j] * g_ph1 +
              P[12 + j] * g_ph3;
    }

    if (use_sh) {
      // color = max(eval_sh(deg, sh, d) + 0.5, 0), d = d0 / max(|d0|, eps).
      float d[3], d0[3], dnorm, dn;
      view_dir(cam, X, Y, Z, d, d0, dnorm, dn);
      float g_d[3] = {0.0f, 0.0f, 0.0f};
      for (int c = 0; c < 3; ++c) {
        float* sh = s_rest + (3 * t + c) * seg;
        const float v = add(eval_sh(p.deg, s_dc[3 * t + c], sh, d[0], d[1], d[2]), 0.5f);
        const float g_v = s_gcolor[3 * t + c] * dmax(v, 0.0f);
        s_dc[3 * t + c] = g_v * kC0;
        eval_sh_bwd(p.deg, sh, d[0], d[1], d[2], g_v, g_d[0], g_d[1], g_d[2]);
      }
      const float g_dn = -(g_d[0] * d[0] + g_d[1] * d[1] + g_d[2] * d[2]) / dn;
      const float g_norm = g_dn * dmax(dnorm, kNormEps);
      for (int k = 0; k < 3; ++k) {
        gp[k] += g_d[k] / dn + (dnorm > 0.0f ? g_norm * d0[k] / dnorm : 0.0f);
      }
    }

    // Sigma_ik = sum_j r_ij v_j r_kj.
    float g_r[3][3], g_v[3];
    for (int j = 0; j < 3; ++j) {
      g_v[j] = 0.0f;
      for (int i = 0; i < 3; ++i) {
        const float gr = G[i][0] * g.r[0][j] + G[i][1] * g.r[1][j] + G[i][2] * g.r[2][j];
        g_r[i][j] = 2.0f * g.v[j] * gr;
        g_v[j] += g.r[i][j] * gr;
      }
    }
    // The rotation of the unit quaternion (w, x, y, z).
    const float w = g.w, x = g.x, y = g.y, z = g.z;
    float g_q[4];
    g_q[0] = 2.0f * (-z * g_r[0][1] + y * g_r[0][2] + z * g_r[1][0] - x * g_r[1][2] -
                     y * g_r[2][0] + x * g_r[2][1]);
    g_q[1] = 2.0f * (y * g_r[0][1] + z * g_r[0][2] + y * g_r[1][0] - 2.0f * x * g_r[1][1] -
                     w * g_r[1][2] + z * g_r[2][0] + w * g_r[2][1] - 2.0f * x * g_r[2][2]);
    g_q[2] = 2.0f * (-2.0f * y * g_r[0][0] + x * g_r[0][1] + w * g_r[0][2] + x * g_r[1][0] +
                     z * g_r[1][2] - w * g_r[2][0] + z * g_r[2][1] - 2.0f * y * g_r[2][2]);
    g_q[3] = 2.0f * (-2.0f * z * g_r[0][0] - w * g_r[0][1] + x * g_r[0][2] + w * g_r[1][0] -
                     2.0f * z * g_r[1][1] + y * g_r[1][2] + x * g_r[2][0] + y * g_r[2][1]);
    if (!kBuilt) {
      // q / max(|q|, eps).
      const float* q = s_q + 4 * t;
      const float g_qn = -(g_q[0] * g.w + g_q[1] * g.x + g_q[2] * g.y + g_q[3] * g.z) / g.qn;
      const float g_norm = g_qn * dmax(g.qnorm, kNormEps);
      float out[4];
      for (int k = 0; k < 4; ++k) {
        out[k] = g_q[k] / g.qn + (g.qnorm > 0.0f ? g_norm * q[k] / g.qnorm : 0.0f);
      }
      for (int k = 0; k < 4; ++k) g_q[k] = out[k];
    }
    // v = (scale_modifier e)^2, e = exp(log_scales) or the built scales.
    for (int k = 0; k < 3; ++k) {
      const float g_e = g_v[k] * 2.0f * g.s[k] * p.scale_mod;
      s_ls[3 * t + k] = kBuilt ? g_e : g_e * g.e[k];
    }
    for (int k = 0; k < 4; ++k) s_q[4 * t + k] = g_q[k];
    for (int k = 0; k < 3; ++k) s_xyz[3 * t + k] = gp[k];
    s_op[t] = g_ol;
  }
  __syncthreads();
  unstage(p.g_xyz + 3 * g0, s_xyz, 3 * rows);
  unstage(p.g_log_scales + 3 * g0, s_ls, 3 * rows);
  unstage(p.g_quats + 4 * g0, s_q, 4 * rows);
  unstage(p.g_opacity_logit + g0, s_op, rows);
  if (use_sh) {
    unstage(p.g_sh_dc + 3 * g0, s_dc, 3 * rows);
    if (seg == p.rest) {
      unstage(p.g_sh_rest + 3 * seg * g0, s_rest, 3 * seg * rows);
    } else if (p.rest > 0) {
      unstage_active(p.g_sh_rest + 3 * static_cast<long long>(p.rest) * g0, s_rest, rows,
                     p.rest, seg);
    }
  }
}

// Launch kernel on blocks of kBlock threads with smem bytes of dynamic
// shared memory (at most 48 KB: SH 4 with every option needs 47 KB).
template <typename Args>
int launch(void (*kernel)(Args), const Args& args, long long n, size_t smem,
           cudaStream_t stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (smem > 48 * 1024 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kBlock, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sugar_preprocess_fields(
    const float* xyz, const float* opacity_logit, const float* log_scales, const float* quats,
    const float* sh_dc, const float* sh_rest, int rest, int sh_degree, int built,
    const float* colors, int channels, const uint8_t* alive, const float* ndc_offset,
    const float* viewmatrix, const float* projmatrix, const float* campos, long long n,
    int width, int height, int tiles_x, int tiles_y, float focal_x, float focal_y, float lim_x,
    float lim_y, float scale_modifier, float* mean2d, float* depth, float* conic,
    float* opacity, float* color, int* radius, int* rect_min, int* rect_max,
    int* tiles_touched, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (sh_degree < 0 || sh_degree > 4) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{xyz, opacity_logit, log_scales, quats, sh_dc, sh_rest, rest, sh_degree, colors,
                 channels, alive, ndc_offset, viewmatrix, projmatrix, campos, n, width, height,
                 tiles_x, tiles_y, focal_x, focal_y, lim_x, lim_y, scale_modifier, mean2d,
                 depth, conic, opacity, color, radius, rect_min, rect_max, tiles_touched};
  const size_t smem = sizeof(float) * static_cast<size_t>(shared_floats(p));
  return built ? launch(preprocess_kernel<true>, p, n, smem, stream)
               : launch(preprocess_kernel<false>, p, n, smem, stream);
}

extern "C" int sugar_preprocess_fields_bwd(
    const float* xyz, const float* opacity_logit, const float* log_scales, const float* quats,
    const float* sh_dc, const float* sh_rest, int rest, int sh_degree, int built,
    const float* viewmatrix, const float* projmatrix, const float* campos, long long n,
    int width, int height, float focal_x, float focal_y, float lim_x, float lim_y,
    float scale_modifier, const float* g_mean2d, const float* g_conic, const float* g_opacity,
    const float* g_color, float* g_xyz, float* g_opacity_logit, float* g_log_scales,
    float* g_quats, float* g_sh_dc, float* g_sh_rest, float* g_ndc, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (sh_degree < 0 || sh_degree > 4) return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{xyz, opacity_logit, log_scales, quats, sh_dc, sh_rest, rest, sh_degree,
                    viewmatrix, projmatrix, campos, n, width, height, focal_x, focal_y, lim_x,
                    lim_y, scale_modifier, g_mean2d, g_conic, g_opacity, g_color, g_xyz,
                    g_opacity_logit, g_log_scales, g_quats, g_sh_dc, g_sh_rest, g_ndc};
  const size_t smem = sizeof(float) * static_cast<size_t>(bwd_shared_floats(p));
  return built ? launch(preprocess_bwd_kernel<true>, p, n, smem, stream)
               : launch(preprocess_bwd_kernel<false>, p, n, smem, stream);
}
