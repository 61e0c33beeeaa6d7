"""Plain PyTorch reference of SuGaR's mesh-bound Gaussians, written for the
benchmark from the published description (sugar_scene/sugar_model.py:
149-224, 391-479; sugar_trainers/refine.py:774-783):

- n Gaussians per triangle at fixed barycentric coordinates; one per
  triangle sits at the centroid;
- initial in-plane scale = the triangle's shortest side times the radius
  of the bary table's circle, 1 / (2 sqrt 3) for one per triangle;
- 3D scales [thickness, exp(s1), exp(s2)], thickness = extent / 1e6;
- rotation columns (face normal, r1, r2), r1 and r2 the in-triangle base
  (edge v0 - v1 and normal x edge) turned by the learned unit complex
  number;
- normal consistency = mean(1 - cos) of the normals of faces that share
  an edge.

The covariance is built from the rotation directly. Imports nothing of the
program.
"""

from __future__ import annotations

import math

import torch

CIRCLE_RADIUS_1 = 1.0 / 2.0 / math.sqrt(3.0)


def _unit(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=1e-12)


def init_log_scales(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(F, 2) float32 initial in-plane log scales, one Gaussian per face,
    computed in float64."""
    fv = vertices.to(torch.float64)[faces]
    sides = torch.linalg.norm(fv - fv[:, [1, 2, 0]], dim=-1)
    s0 = torch.clamp(sides.min(dim=-1).values * CIRCLE_RADIUS_1, min=1e-7)
    return torch.log(s0)[:, None].expand(-1, 2).to(torch.float32)


def face_normals(vertices: torch.Tensor, faces: torch.Tensor):
    fv = vertices[faces]
    return fv, _unit(torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=-1))


def gaussians(vertices, faces, log_scales, complex_rot, thickness: float):
    """(centers (F, 3), rotations (F, 3, 3), scales (F, 3)) of one Gaussian
    per face."""
    fv, n0 = face_normals(vertices, faces)
    third = torch.tensor(1.0 / 3.0, dtype=torch.float32).to(vertices.dtype)
    centers = fv[:, 0] * third + fv[:, 1] * third + fv[:, 2] * third
    base1 = _unit(fv[:, 0] - fv[:, 1])
    base2 = _unit(torch.linalg.cross(n0, base1, dim=-1))
    c = _unit(complex_rot)
    r1 = c[:, 0:1] * base1 + c[:, 1:2] * base2
    r2 = -c[:, 1:2] * base1 + c[:, 0:1] * base2
    rot = torch.stack([n0, r1, r2], dim=-1)
    s = torch.exp(log_scales)
    scales = torch.cat([torch.full_like(s[:, :1], thickness), s], dim=-1)
    return centers, rot, scales


def normal_consistency(vertices: torch.Tensor, faces: torch.Tensor, pairs: torch.Tensor):
    _, n = face_normals(vertices, faces)
    return torch.mean(1.0 - (n[pairs[:, 0]] * n[pairs[:, 1]]).sum(dim=-1))
