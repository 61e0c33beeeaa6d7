"""Gaussian density / SDF field evaluation and in-Gaussian point sampling.

Port of ``sugar_tpu/fields/density.py``:

- :func:`field_values` == SuGaR.get_field_values (sugar_model.py:1247-1316):
  density(x) = sum over the K nearest Gaussians of
  opacity_j * exp(-1/2 ||S_j^-1 R_j^T (x - mu_j)||^2), soft-clamped at 1
  inside the SDF; sdf(x) = beta * (sqrt(-2 ln d) - sqrt(-2 ln level));
  analytic sdf gradient, clamped to +-10.
- beta modes 'average', 'weighted_average' and 'learnable'
  (SuGaR.get_beta, sugar_model.py:1172-1245).
- :func:`sample_points_in_gaussians` == sugar_model.py:885-928, with the
  draw as an argument: a ``torch.Generator``, or ``(idx, noise)`` so a test
  can feed in the JAX package's ``jax.random`` draw.

Plain torch ops on the inputs' device, differentiable where the JAX
functions are; ``jax.lax.stop_gradient`` becomes ``.detach()``, and
``jnp.clip``/``maximum``/``min`` keep their tie gradients (``clip``,
``torch.maximum``, ``amin``/``amax``). The per-neighbor gathers are
component-major, as in the JAX package. The JAX package streams queries
in ``lax.map`` chunks to bound HBM; under autograd every chunk's
residuals stay alive anyway, so the port evaluates all queries in one
pass (1M samples x 16 neighbors: a 2.65 GB peak for forward and backward
on an H100, PERF.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sugar_tpu_torch.core.quaternions import quaternion_apply, quaternion_to_matrix
from sugar_tpu_torch.raster.common import clip


class GaussianFieldParams(NamedTuple):
    """Activated per-Gaussian quantities needed for field queries."""

    centers: torch.Tensor  # (N, 3)
    scales: torch.Tensor  # (N, 3)
    quaternions: torch.Tensor  # (N, 4) unit
    opacities: torch.Tensor  # (N,)


def inv_scaled_rotation(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """R diag(1/s): sqrt of the inverse-scale covariance
    (sugar_model.py:730-750 get_covariance(return_sqrt, inverse_scales))."""
    R = quaternion_to_matrix(quats)
    floor = torch.tensor(1e-8, dtype=scales.dtype, device=scales.device)
    return R * (1.0 / torch.maximum(scales, floor))[:, None, :]


def warp_neighbors(x: torch.Tensor, neighbor_idx: torch.Tensor, gp: GaussianFieldParams):
    """Component-major per-(query, neighbor) terms. Returns (m, warped, flat)
    where ``flat`` = neighbor_idx flattened (C*K,), ``m`` (9, C*K) with row
    3*i+j = isr[:, i, j] of each neighbor and ``warped`` a list of the three
    (C*K,) components of diag(1/s) R^T (x - mu)."""
    isr9 = inv_scaled_rotation(gp.scales, gp.quaternions).reshape(-1, 9).T.contiguous()
    c_n, k_n = neighbor_idx.shape
    flat = neighbor_idx.reshape(-1)
    m = isr9.index_select(1, flat)  # (9, C*K)
    cen = gp.centers.T.contiguous().index_select(1, flat)  # (3, C*K)
    # x repeated K times along the flat neighbor axis.
    shift = x.T[:, :, None].expand(3, c_n, k_n).reshape(3, -1) - cen
    # warped_j = sum_i isr[i, j] * shift_i (diag(1/s) R^T shift).
    warped = [m[j] * shift[0] + m[3 + j] * shift[1] + m[6 + j] * shift[2] for j in range(3)]
    return m, warped, flat


def field_values(
    x: torch.Tensor,  # (M, 3) query points
    neighbor_idx: torch.Tensor,  # (M, K) gaussian indices per query
    gp: GaussianFieldParams,
    density_factor: float = 1.0,
    density_threshold: float = 1.0,
    return_sdf: bool = True,
    return_sdf_grad: bool = False,
    return_beta: bool = False,
    sdf_grad_max_value: float = 10.0,
    beta_mode: str = "average",
    learnable_beta: torch.Tensor | None = None,
    opacity_min_clamp: float = 1e-16,
) -> dict:
    """Evaluate density / sdf / beta fields at x. Differentiable.

    ``return_beta`` asks for beta without the sdf (SuGaR's
    get_field_values(return_beta=True), which coarse density regularization
    needs); the JAX function computes beta only with the sdf or its
    gradient."""
    min_scale = gp.scales.amin(dim=-1)  # (N,)
    c_n, k_n = neighbor_idx.shape
    m, warped, flat = warp_neighbors(x, neighbor_idx, gp)
    quad = clip(warped[0] * warped[0] + warped[1] * warped[1] + warped[2] * warped[2], 0.0, 1e8)
    neigh_op = (density_factor * gp.opacities[flat] * torch.exp(-0.5 * quad)).reshape(c_n, k_n)
    density_raw = neigh_op.sum(dim=-1)  # (C,)
    # Soft clamp at 1 with pass-through gradient (sugar_model.py:1282-1284).
    density = torch.where(density_raw >= 1.0, density_raw / (density_raw.detach() + 1e-12),
                          density_raw)
    out = dict(density=density_raw)

    if return_sdf or return_sdf_grad or return_beta:
        if beta_mode == "learnable":
            beta = torch.exp(learnable_beta) * torch.ones_like(density)
        elif beta_mode == "average":
            beta = min_scale[neighbor_idx].mean(dim=-1)
        elif beta_mode == "weighted_average":
            op_sum = neigh_op.sum(dim=-1, keepdim=True)
            floor = torch.tensor(opacity_min_clamp, dtype=op_sum.dtype, device=op_sum.device)
            weights = neigh_op / torch.maximum(op_sum, floor)
            beta = (min_scale[neighbor_idx] * weights).sum(dim=-1)
            beta = torch.where(op_sum[..., 0] == 0.0, min_scale.amax().detach(), beta)
        else:
            raise ValueError(beta_mode)
        out["beta"] = beta

    if return_sdf or return_sdf_grad:
        # Upper clamp keeps sqrt(-2 ln d) differentiable at the density
        # ceiling (the reference's d/detach(d) trick evaluates to exactly
        # 1 there, where the sqrt's gradient blows up; 1e-7 below keeps
        # gradients finite with negligible value change).
        d_cl = clip(density, opacity_min_clamp, 1.0 - 1e-7)
        sqrt_term = torch.sqrt(torch.maximum(-2.0 * torch.log(d_cl), torch.zeros_like(d_cl)))

    if return_sdf:
        level_term = 0.0
        if density_threshold < 1.0:  # float32, as jnp computes it
            level = torch.tensor(density_threshold, dtype=torch.float32)
            level_term = float(torch.sqrt(-2.0 * torch.log(level)))
        out["sdf"] = beta * (sqrt_term - level_term)

    if return_sdf_grad:
        # sum_j o_j e^{-q/2} Sigma_j^{-1} (x - mu_j), scaled
        # (sugar_model.py:1310-1314). sigma_inv_shift_i =
        # sum_j isr[i, j] * warped_j, component-major like above.
        nf = neigh_op.reshape(-1)
        grad = torch.stack(
            [(nf * (m[3 * i] * warped[0] + m[3 * i + 1] * warped[1] + m[3 * i + 2] * warped[2]))
             .reshape(c_n, k_n).sum(dim=-1) for i in range(3)],
            dim=-1,
        )  # (C, 3)
        floor = torch.tensor(opacity_min_clamp, dtype=d_cl.dtype, device=d_cl.device)
        denom = torch.maximum(d_cl * sqrt_term, floor)
        grad = (beta / denom)[..., None] * grad
        out["sdf_grad"] = clip(grad, -sdf_grad_max_value, sdf_grad_max_value)
    return out


def sample_points_in_gaussians(
    draw: tuple[torch.Tensor, torch.Tensor] | torch.Generator,
    num_samples: int,
    gp: GaussianFieldParams,
    alive: torch.Tensor,  # (N,) bool
    sampling_scale_factor: float = 1.0,
    prob_proportional_to_volume: bool = True,
    prob_proportional_to_opacity: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample points from the Gaussian mixture (sugar_model.py:885-928).

    ``draw`` is either a ``torch.Generator`` on the params' device, from
    which the Gaussian of each sample (by the alive-masked probabilities)
    and its standard-normal offset (S, 3) are drawn, or that draw given as
    ``(idx (S,), noise (S, 3))``. With no alive Gaussian the probabilities
    are uniform, as the JAX function's categorical over all-equal logits.
    Returns (points (S, 3), gaussian_idx (S,)).
    """
    if isinstance(draw, torch.Generator):
        if prob_proportional_to_volume:
            areas = gp.scales[:, 0] * gp.scales[:, 1] * gp.scales[:, 2]
        else:
            areas = torch.ones_like(gp.scales[:, 0])
        if prob_proportional_to_opacity:
            areas = areas * gp.opacities
        areas = torch.where(alive, areas.abs(), 0.0).detach()
        total = areas.sum()
        probs = torch.where(total > 0, areas / torch.clamp_min(total, 1e-30), 1.0)
        idx = torch.multinomial(probs, num_samples, replacement=True, generator=draw)
        noise = torch.randn((num_samples, 3), generator=draw, device=probs.device)
    else:
        idx, noise = draw
        if idx.shape != (num_samples,) or noise.shape != (num_samples, 3):
            raise ValueError(f"draw shapes {tuple(idx.shape)}, {tuple(noise.shape)}; "
                             f"expected ({num_samples},), ({num_samples}, 3)")
    local = sampling_scale_factor * gp.scales[idx] * noise
    pts = gp.centers[idx] + quaternion_apply(gp.quaternions[idx], local)
    return pts, idx


def smallest_axes(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Unit normal direction of each Gaussian = rotation column of the
    smallest scale (sugar_model.py:930-946 get_smallest_axis)."""
    R = quaternion_to_matrix(quats)  # columns are principal axes
    k = torch.argmin(scales, dim=-1)
    return torch.take_along_dim(R, k[:, None, None], dim=2)[..., 0]


def local_variance(values: torch.Tensor, neighbor_idx: torch.Tensor) -> torch.Tensor:
    """Variance of values over each neighborhood (sugar_model.py:977-986)."""
    nv = values[neighbor_idx]  # (M, K, D)
    return ((nv - nv.mean(dim=1, keepdim=True)) ** 2).sum(dim=-1).mean(dim=1)


def depth_lookup_bilinear(
    depth: torch.Tensor,  # (H, W)
    pix_xy: torch.Tensor,  # (M, 2) float pixel coords
) -> torch.Tensor:
    """Bilinear depth-map lookup with border padding — replaces the
    grid_sample call of get_points_depth_in_depth_map
    (sugar_model.py:1318-1333)."""
    h, w = depth.shape
    x = clip(pix_xy[:, 0], 0.0, w - 1.0)
    y = clip(pix_xy[:, 1], 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = x - x0
    fy = y - y0
    d00 = depth[y0, x0]
    d01 = depth[y0, x1]
    d10 = depth[y1, x0]
    d11 = depth[y1, x1]
    return d00 * (1 - fx) * (1 - fy) + d01 * fx * (1 - fy) + d10 * (1 - fx) * fy + d11 * fx * fy
