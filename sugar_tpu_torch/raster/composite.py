"""Depth-ordered alpha compositing as log-space scans (the oracle modes' core).

Port of ``sugar_tpu/raster/composite.py``. A block of K depth-ordered
Gaussians over P pixels is composited at once: alpha for the whole (K, P)
block, transmittance from log-space cumulative sums, the colour as a
(P, K) @ (K, C) product, and CUDA's early stop (the first Gaussian whose
inclusion would push T below T_EPS, forward.cu:256-261) as a monotone mask
on the raw running product. ``reference_impl`` and ``tiled`` are built on
it; the production paths composite in ``tile_composite`` instead.

Every function takes optional leading batch dimensions (the JAX package
``vmap``s them over tiles) and is differentiable; the include mask is
detached, as the CUDA backward treats inclusion as constant.
"""

from __future__ import annotations

import math

import torch

from sugar_tpu_torch.raster import common as rc

LOG_T_EPS = math.log(rc.T_EPS)


def alpha_from_conic(
    mean2d: torch.Tensor,  # (..., K, 2)
    conic: torch.Tensor,  # (..., K, 3) (a, b, c)
    opacity: torch.Tensor,  # (..., K)
    pix: torch.Tensor,  # (..., P, 2) pixel coords (integer centres, CUDA pixf)
    valid: torch.Tensor,  # (..., K) bool: padded/overflow slots contribute 0
) -> torch.Tensor:
    """Per-(Gaussian, pixel) alpha with CUDA's skip semantics: (..., K, P)
    in [0, ALPHA_CLAMP], skipped samples exactly 0."""
    dx = mean2d[..., :, 0:1] - pix[..., None, :, 0]
    dy = mean2d[..., :, 1:2] - pix[..., None, :, 1]
    a, b, c = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    # exp of the gated power only: a skipped sample's exp may overflow, and
    # autograd's exp backward multiplies its zero cotangent by the result
    # (0 * inf = NaN). Kept samples (power <= 0) see the same value.
    raw = opacity[..., None] * torch.exp(torch.where(power <= 0.0, power, 0.0))
    # Straight-through 0.99 clamp: the CUDA backward ignores the clamp
    # (backward.cu:509-554), so the value is clamped, the gradient is not.
    alpha = raw + (torch.clamp(raw, max=rc.ALPHA_CLAMP) - raw).detach()
    keep = (power <= 0.0) & (alpha >= rc.ALPHA_CUTOFF) & valid[..., None]
    return torch.where(keep, alpha, 0.0)


def composite_block(
    alpha: torch.Tensor,  # (..., K, P) depth-ordered alphas (0 = skip)
    color: torch.Tensor,  # (..., K, C)
    log_t: torch.Tensor,  # (..., P) log effective transmittance carried in
    log_p_raw: torch.Tensor,  # (..., P) log raw product carried in
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite one depth-ordered block of K Gaussians over P pixels.

    Returns (colour contribution (..., P, C), new log_t, new log_p_raw,
    n_included (..., P) int32). Chain blocks by threading (log_t,
    log_p_raw), both starting at zeros."""
    lp = torch.log1p(-alpha)  # 0 where skipped
    log_p_incl = log_p_raw[..., None, :] + torch.cumsum(lp, dim=-2)
    include = (log_p_incl >= LOG_T_EPS).detach()
    a_eff = alpha * include
    lp_eff = torch.log1p(-a_eff)
    # Exclusive cumsum: the transmittance before each Gaussian.
    log_t_in = log_t[..., None, :] + torch.cumsum(lp_eff, dim=-2) - lp_eff
    w = a_eff * torch.exp(log_t_in)
    contrib = torch.einsum("...kp,...kc->...pc", w, color)
    new_log_t = log_t + lp_eff.sum(dim=-2)
    new_log_p = log_p_raw + lp.sum(dim=-2)
    n_inc = (a_eff > 0.0).sum(dim=-2, dtype=torch.int32)
    return contrib, new_log_t, new_log_p, n_inc


def composite_depth_ordered(
    alpha: torch.Tensor,  # (..., K, P) full depth-ordered alphas
    color: torch.Tensor,  # (..., K, C)
    bg: torch.Tensor,  # (C,)
    block: int = 256,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite K Gaussians over P pixels, ``block`` at a time (the JAX
    package's ``lax.scan``; the block size sets how the log-space sums
    round). Returns (image (..., P, C), final_T (..., P), n_contrib (...,
    P) int32)."""
    k, p = alpha.shape[-2:]
    pad = (-k) % block
    if pad:
        alpha = torch.nn.functional.pad(alpha, (0, 0, 0, pad))
        color = torch.nn.functional.pad(color, (0, 0, 0, pad))
    batch = alpha.shape[:-2]
    log_t = alpha.new_zeros(batch + (p,))
    log_p = alpha.new_zeros(batch + (p,))
    acc = alpha.new_zeros(batch + (p, color.shape[-1]))
    n = torch.zeros(batch + (p,), dtype=torch.int32, device=alpha.device)
    for b0 in range(0, k + pad, block):
        contrib, log_t, log_p, n_inc = composite_block(
            alpha[..., b0:b0 + block, :], color[..., b0:b0 + block, :], log_t, log_p
        )
        acc = acc + contrib
        n = n + n_inc
    final_t = torch.exp(log_t)
    image = acc + final_t[..., None] * bg
    return image, final_t, n
