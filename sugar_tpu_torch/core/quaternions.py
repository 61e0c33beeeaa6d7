"""Quaternion utilities (wxyz convention).

Port of ``sugar_tpu/core/quaternions.py``. The rotation matrix layout is
3DGS ``build_rotation``'s. All functions are batched over leading dims
and differentiable.
"""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions to unit norm."""
    norm = torch.linalg.norm(q, dim=-1, keepdim=True)
    # maximum, not clamp: a tie splits the gradient as jnp.maximum does.
    return q / torch.maximum(norm, torch.tensor(eps, dtype=norm.dtype, device=norm.device))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz.

    Branchless: all four candidates (each scaled by its pivot), then the
    one with the largest pivot, which is stable everywhere on SO(3).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw2 = torch.clamp(1.0 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    cand_w = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cand_x = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cand_y = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cand_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)

    pivots = torch.stack([qw2, qx2, qy2, qz2], dim=-1)  # (..., 4)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # (..., 4, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return normalize(q)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b (wxyz), no normalization."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion = conjugate."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quaternion_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate points v (..., 3) by unit quaternions q (..., 4)."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    out = quaternion_raw_multiply(quaternion_raw_multiply(q, qv), quaternion_invert(q))
    return out[..., 1:]
