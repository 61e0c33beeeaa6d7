// The per-slot alpha evaluation shared by the compositing forward
// (tile_composite.cu) and backward (tile_composite_bwd.cu). One definition
// keeps the two kernels' arithmetic identical, so the backward's
// recomputed include decisions (running product >= T_EPS) are the ones
// the forward made. Semantics of pallas_composite.py `_chunk_alpha`.
#pragma once

namespace sugar {

constexpr int kChunk = 256;  // slots per chunk = pixels per tile
constexpr int kTile = 16;
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr float kOneMinusClamp = 0.01f;  // f32(1 - 0.99 in double), as the TPU kernel

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

}  // namespace sugar
