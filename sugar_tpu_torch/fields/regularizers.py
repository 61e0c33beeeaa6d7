"""Gaussian-neighborhood regularizers: overlap and alignment.

Port of ``sugar_tpu/fields/regularizers.py``: SuGaR's
compute_gaussian_overlap_with_neighbors (sugar_model.py:1048-1114) and
compute_gaussian_alignment_with_neighbors (:1116-1170). Defined but unused
by the default trainers in the reference as well; exposed for
experimentation parity. The overlap's sample noise is an argument (the
JAX function draws it from ``jax.random``).
"""

from __future__ import annotations

import torch

from sugar_tpu_torch.core.quaternions import quaternion_apply, quaternion_invert
from sugar_tpu_torch.fields.density import GaussianFieldParams, smallest_axes


def gaussian_overlap_with_neighbors(
    gp: GaussianFieldParams,
    neighbor_idx: torch.Tensor,  # (M, K) — column 0 is the point itself
    noise: torch.Tensor | None = None,  # (M, n_samples, 3) standard normal
    use_gaussian_center_only: bool = True,
    n_samples: int = 32,
    weight_by_normal_angle: bool = False,
    propagate_gradient_to_points_only: bool = False,
) -> torch.Tensor:
    """Mean Gaussian weight of each point's samples under its K-1 neighbor
    Gaussians. Returns (M, K-1). ``noise`` is required when
    ``use_gaussian_center_only`` is False."""
    scales = gp.scales
    quats = gp.quaternions
    if propagate_gradient_to_points_only:
        scales = scales.detach()
        quats = quats.detach()

    pt_idx = neighbor_idx[:, 0]
    m = pt_idx.shape[0]
    if use_gaussian_center_only:
        samples = gp.centers[pt_idx][:, None, :]  # (M, 1, 3)
    else:
        if noise is None or tuple(noise.shape) != (m, n_samples, 3):
            raise ValueError(f"noise of shape ({m}, {n_samples}, 3) is required "
                             "when use_gaussian_center_only is False")
        samples = gp.centers[pt_idx][:, None, :] + quaternion_apply(
            quats[pt_idx][:, None, :], scales[pt_idx][:, None, :] * noise
        )

    nb = neighbor_idx[:, 1:]  # (M, K-1)
    shift = samples[:, None] - gp.centers[nb][:, :, None]  # (M, K-1, S, 3)
    inv_s = 1.0 / scales[nb][:, :, None]  # (M, K-1, 1, 3)
    gd = inv_s * quaternion_apply(quaternion_invert(quats[nb])[:, :, None], shift)
    weights = torch.exp(-0.5 * (gd * gd).sum(dim=-1))  # (M, K-1, S)
    overlaps = weights.mean(dim=-1)

    if weight_by_normal_angle:
        normals = smallest_axes(gp.scales, gp.quaternions)[neighbor_idx]
        w = (normals[:, 1:] * normals[:, 0:1]).sum(dim=-1).abs()
        overlaps = overlaps * w
    return overlaps


def gaussian_alignment_with_neighbors(
    gp: GaussianFieldParams,
    neighbor_idx: torch.Tensor,  # (M, K)
    std_factor: float = 1.0,
    weight_by_normal_angle: bool = False,
    propagate_gradient_to_points_only: bool = False,
) -> torch.Tensor:
    """|distance / (sigma_i + sigma_j) - 1| per neighbor pair. (M, K-1)."""
    scales = gp.scales
    quats = gp.quaternions
    if propagate_gradient_to_points_only:
        scales = scales.detach()
        quats = quats.detach()

    all_s = scales[neighbor_idx]  # (M, K, 3)
    all_qi = quaternion_invert(quats)[neighbor_idx]
    all_c = gp.centers[neighbor_idx]

    shifts = all_c[:, 1:] - all_c[:, :1]
    floor = torch.tensor(1e-8, dtype=shifts.dtype, device=shifts.device)
    dists = torch.maximum(torch.linalg.norm(shifts, dim=-1), floor)
    dirs = shifts / dists[..., None]

    std_self = torch.linalg.norm(all_s[:, :1] * quaternion_apply(all_qi[:, :1], dirs), dim=-1)
    std_nb = torch.linalg.norm(all_s[:, 1:] * quaternion_apply(all_qi[:, 1:], dirs), dim=-1)
    stab = torch.maximum((std_self + std_nb) * std_factor, floor)
    alignment = (dists / stab - 1.0).abs()

    if weight_by_normal_angle:
        normals = smallest_axes(gp.scales, gp.quaternions)[neighbor_idx]
        w = (normals[:, 1:] * normals[:, 0:1]).sum(dim=-1).abs()
        alignment = alignment * w
    return alignment
