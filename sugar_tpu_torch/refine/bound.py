"""Mesh-bound Gaussians: the refined SuGaR representation.

Port of ``sugar_tpu/refine/bound.py``. Reference semantics
(sugar_scene/sugar_model.py:149-479): Gaussians live at fixed barycentric
coordinates of mesh triangles (1/3/4/6 per triangle with the bary tables of
:172-212); learnable parameters are the mesh vertex positions, per-Gaussian
2D scales, an in-plane rotation encoded as a complex number, opacities and
SH. Derived 3D quantities (differentiable through the vertices):

- centers = barycentric combination of the triangle's vertices (:391-398);
- 3D scale = [thickness, exp(s1), exp(s2)] with thickness = extent / 1e6
  (:165-169, 438-441);
- rotation: first axis = face normal, second/third = learned 2D rotation of
  an in-triangle base (:444-479), converted to a quaternion.

Plain torch ops, differentiable where the JAX functions are. Faces are
int64 index tensors (the JAX package keeps int32; files keep int32). The
barycentric combinations are written out elementwise, so TF32 matmul
settings cannot change them. The adjacency helpers are host numpy, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sugar_tpu_torch.core import sh as sh_lib
from sugar_tpu_torch.core.quaternions import matrix_to_quaternion
from sugar_tpu_torch.raster.common import clip

BARY_TABLES = {
    1: (1.0 / 2.0 / np.sqrt(3.0), np.array([[1 / 3, 1 / 3, 1 / 3]])),
    3: (
        1.0 / 2.0 / (np.sqrt(3.0) + 1.0),
        np.array([[1 / 2, 1 / 4, 1 / 4], [1 / 4, 1 / 2, 1 / 4], [1 / 4, 1 / 4, 1 / 2]]),
    ),
    4: (
        1.0 / (4.0 * np.sqrt(3.0)),
        np.array(
            [
                [1 / 3, 1 / 3, 1 / 3],
                [2 / 3, 1 / 6, 1 / 6],
                [1 / 6, 2 / 3, 1 / 6],
                [1 / 6, 1 / 6, 2 / 3],
            ]
        ),
    ),
    6: (
        1.0 / (4.0 + 2.0 * np.sqrt(3.0)),
        np.array(
            [
                [2 / 3, 1 / 6, 1 / 6],
                [1 / 6, 2 / 3, 1 / 6],
                [1 / 6, 1 / 6, 2 / 3],
                [1 / 6, 5 / 12, 5 / 12],
                [5 / 12, 1 / 6, 5 / 12],
                [5 / 12, 5 / 12, 1 / 6],
            ]
        ),
    ),
}

BOUND_FIELDS = ("vertices", "log_scales", "complex_rot", "opacity_logit", "sh_dc", "sh_rest")


@dataclasses.dataclass(frozen=True)
class BoundParams:
    """Learnable parameters of the refined model."""

    vertices: torch.Tensor  # (V, 3)
    log_scales: torch.Tensor  # (G, 2) in-plane
    complex_rot: torch.Tensor  # (G, 2)
    opacity_logit: torch.Tensor  # (G,)
    sh_dc: torch.Tensor  # (G, 3)
    sh_rest: torch.Tensor  # (G, 3, K-1)


@dataclasses.dataclass(frozen=True)
class BoundMesh:
    """Fixed binding structure."""

    faces: torch.Tensor  # (F, 3) int64
    bary: torch.Tensor  # (gpt, 3) float32
    thickness: torch.Tensor  # () float32
    n_per_triangle: int


def _unit(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.maximum(n, n.new_tensor(1e-12))


def _bary_combine(fv: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """einsum("fv...,gv->fg...", fv, bary) for (F, 3, ...) corner values,
    written out over the three corners."""
    extra = (None,) * (fv.dim() - 2)
    b = [bary[(None, slice(None), v) + extra] for v in range(3)]
    return fv[:, None, 0] * b[0] + fv[:, None, 1] * b[1] + fv[:, None, 2] * b[2]


def face_geometry(vertices: torch.Tensor, faces: torch.Tensor):
    """(face verts (F,3,3), unit normals (F,3))."""
    fv = vertices[faces]
    n = torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=-1)
    return fv, _unit(n)


def gaussian_centers(params: BoundParams, bm: BoundMesh) -> torch.Tensor:
    return _bary_combine(params.vertices[bm.faces], bm.bary).reshape(-1, 3)


def gaussian_scales(params: BoundParams, bm: BoundMesh) -> torch.Tensor:
    """(G, 3): [thickness, s1, s2] (sugar_model.py:438-441)."""
    s = torch.exp(params.log_scales)
    th = bm.thickness.to(s.dtype).expand(s.shape[0], 1)
    return torch.cat([th, s], dim=-1)


def _rotations(n0, base1, base2, c):
    """(G, 3, 3) with columns (normal, r1, r2): the in-plane axes are the
    base rotated by the unit complex numbers c (F, gpt, 2)."""
    r1 = c[..., 0:1] * base1[:, None] + c[..., 1:2] * base2[:, None]
    r2 = -c[..., 1:2] * base1[:, None] + c[..., 0:1] * base2[:, None]
    r0 = n0[:, None].expand(r1.shape)
    return torch.stack([r0, r1, r2], dim=-1).reshape(-1, 3, 3)


def gaussian_quaternions(params: BoundParams, bm: BoundMesh) -> torch.Tensor:
    """(G, 4): rotation whose first column is the face normal and whose
    in-plane axes are rotated by the learned complex number
    (sugar_model.py:444-479)."""
    fv, n0 = face_geometry(params.vertices, bm.faces)
    base1 = _unit(fv[:, 0] - fv[:, 1])
    base2 = _unit(torch.linalg.cross(n0, base1, dim=-1))
    c = _unit(params.complex_rot).reshape(-1, bm.n_per_triangle, 2)
    return matrix_to_quaternion(_rotations(n0, base1, base2, c))


def bound_sh(params: BoundParams) -> torch.Tensor:
    return torch.cat([params.sh_dc[:, :, None], params.sh_rest], dim=-1)


def init_bound_params(
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_colors: np.ndarray | None,
    n_gaussians_per_triangle: int = 1,
    extent: float = 1.0,
    sh_degree: int = 3,
    initial_opacity: float = 0.1,
    learn_opacity: bool = True,
    device: str | torch.device = "cuda",
) -> tuple[BoundParams, BoundMesh]:
    """Bind a mesh (sugar_model.py:149-224, 320-345) on ``device``:
    per-triangle initial scale = min side length * circle radius; identity
    in-plane rotation; colors = barycentric vertex colors. The values are
    computed in numpy as the JAX package computes them."""
    circle_radius, bary = BARY_TABLES[n_gaussians_per_triangle]
    f = faces.astype(np.int32)
    fv = vertices[f]  # (F, 3, 3)
    sides = np.linalg.norm(fv - fv[:, [1, 2, 0]], axis=-1)  # (F, 3)
    scale0 = np.maximum(sides.min(axis=-1) * circle_radius, 1e-7)  # (F,)
    g = len(f) * n_gaussians_per_triangle
    log_scales = np.log(scale0)[:, None, None].repeat(n_gaussians_per_triangle, 1).repeat(2, 2)

    cplx = np.zeros((g, 2), np.float32)
    cplx[:, 0] = 1.0

    if vertex_colors is None:
        vertex_colors = np.full((len(vertices), 3), 0.5, np.float32)
    fc = vertex_colors[f]  # (F, 3, 3)
    colors = np.einsum("fvc,gv->fgc", fc, bary).reshape(-1, 3)

    k = sh_lib.num_sh_coeffs(sh_degree)
    opacity = initial_opacity if learn_opacity else 0.9999
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)  # noqa: E731
    params = BoundParams(
        vertices=t(vertices.astype(np.float32)),
        log_scales=t(log_scales.reshape(g, 2).astype(np.float32)),
        complex_rot=t(cplx),
        opacity_logit=torch.full((g,), float(np.log(opacity / (1 - opacity))),
                                 dtype=torch.float32, device=device),
        sh_dc=t(np.asarray(sh_lib.rgb_to_sh0(colors)).astype(np.float32)),
        sh_rest=torch.zeros((g, 3, k - 1), dtype=torch.float32, device=device),
    )
    bm = BoundMesh(
        faces=t(f.astype(np.int64)),
        bary=t(bary.astype(np.float32)),
        thickness=torch.tensor(extent / 1e6, dtype=torch.float32, device=device),
        n_per_triangle=n_gaussians_per_triangle,
    )
    return params, bm


def to_gaussian_arrays(params: BoundParams, bm: BoundMesh) -> dict[str, torch.Tensor]:
    """Activated (centers, scales, quats, opacities, sh) for rendering or
    export (convert_refined_sugar_into_gaussians, sugar_model.py:2680)."""
    return dict(
        centers=gaussian_centers(params, bm),
        scales=gaussian_scales(params, bm),
        quaternions=gaussian_quaternions(params, bm),
        opacities=torch.sigmoid(params.opacity_logit),
        sh=bound_sh(params),
    )


def edited_quaternions_and_scales(
    params: BoundParams,
    bm: BoundMesh,
    reference_vertices: torch.Tensor,  # (V, 3) undeformed mesh
) -> tuple[torch.Tensor, torch.Tensor]:
    """Deformation transfer for edited/animated meshes
    (sugar_model.py:573-667 get_edited_quaternions_and_scales): when the
    bound mesh is deformed (e.g. by Blender-exported animation), the
    in-plane rotations and scales of the bound Gaussians are adjusted so
    they follow the local triangle deformation instead of staying rigid.

    Returns (quaternions (G, 4), scales (G, 3))."""
    gpt = bm.n_per_triangle
    fv = params.vertices[bm.faces]  # (F, 3, 3) deformed
    rv = reference_vertices[bm.faces]  # (F, 3, 3) reference

    _, n0 = face_geometry(params.vertices, bm.faces)
    base1 = _unit(fv[:, 0] - fv[:, 1])
    base2 = _unit(torch.linalg.cross(n0, base1, dim=-1))

    def corner_axes(v):
        """Unit corner-to-centroid axes with the third negated, and the unit
        edge 0 -> 1 (per-corner angular deviation)."""
        ax = _unit(v - v.mean(dim=-2, keepdim=True))
        ax = torch.cat([ax[:, :2], -ax[:, 2:3]], dim=1)
        return ax, _unit(v[:, 0:1] - v[:, 1:2])

    ref_axis, ref_base = corner_axes(rv)
    cur_axis, cur_base = corner_axes(fv)
    ref_ang = torch.arccos(clip((ref_axis * ref_base).sum(dim=-1, keepdim=True), -1.0, 1.0))
    cur_ang = torch.arccos(clip((cur_axis * cur_base).sum(dim=-1, keepdim=True), -1.0, 1.0))
    angles = cur_ang - ref_ang  # (F, 3, 1)
    pt_ang = _bary_combine(angles, bm.bary)[..., 0]  # (F, gpt)

    c = _unit(params.complex_rot).reshape(-1, gpt, 2)
    x, y = c[..., 0], c[..., 1]
    a, b = torch.cos(pt_ang), torch.sin(pt_ang)
    c_adj = torch.stack([x * a - y * b, x * b + y * a], dim=-1)
    R = _rotations(n0, base1, base2, c_adj)
    quats = matrix_to_quaternion(R)
    r1 = R[:, :, 1].reshape(-1, gpt, 3)
    r2 = R[:, :, 2].reshape(-1, gpt, 3)

    # Scale adjustment: stretch along each corner's center-axis by the edge
    # length ratio (sugar_model.py:633-659).
    cur_ax = fv.mean(dim=-2, keepdim=True) - fv  # (F, 3, 3)
    cur_ax_n = torch.linalg.norm(cur_ax, dim=-1, keepdim=True)
    cur_ax_u = _unit(cur_ax)
    cur_orth = torch.linalg.cross(cur_ax_u, n0[:, None].expand_as(cur_ax_u), dim=-1)
    ref_ax = rv.mean(dim=-2, keepdim=True) - rv
    ref_ax_n = torch.linalg.norm(ref_ax, dim=-1, keepdim=True)
    ref_ax_n = torch.maximum(ref_ax_n, ref_ax_n.new_tensor(1e-12))

    def corner_scale(rdir):  # rdir: (F, gpt, 3) -> (F, gpt)
        ax_p = (rdir[:, :, None] * cur_ax_u[:, None]).sum(dim=-1, keepdim=True)
        or_p = (rdir[:, :, None] * cur_orth[:, None]).sum(dim=-1, keepdim=True)
        s = torch.sqrt((ax_p * cur_ax_n[:, None] / ref_ax_n[:, None]) ** 2 + or_p**2)
        return (s[..., 0] * bm.bary[None]).sum(dim=-1)

    s1 = corner_scale(r1)
    s2 = corner_scale(r2)
    plane = torch.exp(params.log_scales).reshape(-1, gpt, 2)
    plane = torch.stack([plane[..., 0] * s1, plane[..., 1] * s2], dim=-1).reshape(-1, 2)
    th = bm.thickness.to(plane.dtype).expand(plane.shape[0], 1)
    return quats, torch.cat([th, plane], dim=-1)


def normal_consistency_pairs(faces: np.ndarray) -> np.ndarray:
    """(P, 2) adjacent-face index pairs sharing an edge — host-side setup for
    the normal-consistency loss (replaces PyTorch3D mesh_normal_consistency,
    refine.py:775-783). The JAX package's loop, pairs in its order."""
    edges = {}
    pairs = []
    for fi, (a, b, c) in enumerate(np.asarray(faces)):
        for e in ((a, b), (b, c), (c, a)):
            key = (min(e), max(e))
            if key in edges:
                pairs.append((edges[key], fi))
            else:
                edges[key] = fi
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def normal_consistency_loss(
    vertices: torch.Tensor, faces: torch.Tensor, pairs: torch.Tensor
) -> torch.Tensor:
    """mean(1 - cos(n_i, n_j)) over adjacent face pairs."""
    _, n = face_geometry(vertices, faces)
    n1 = n[pairs[:, 0]]
    n2 = n[pairs[:, 1]]
    return torch.mean(1.0 - (n1 * n2).sum(dim=-1))


def laplacian_uniform_loss(
    vertices: torch.Tensor, adj_idx: torch.Tensor, adj_mask: torch.Tensor
) -> torch.Tensor:
    """Uniform mesh Laplacian smoothing ||v - mean(neighbors)||
    (PyTorch3D mesh_laplacian_smoothing 'uniform', coarse_sdf.py:736-739)."""
    nb = vertices[adj_idx]  # (V, K, 3)
    m = adj_mask[..., None].to(vertices.dtype)
    one = vertices.new_tensor(1.0)
    mean_nb = (nb * m).sum(dim=1) / torch.maximum(m.sum(dim=1), one)
    diff = torch.linalg.norm(vertices - mean_nb, dim=-1)
    has_nb = (adj_mask.sum(dim=1) > 0).to(vertices.dtype)
    return (diff * has_nb).sum() / torch.maximum(has_nb.sum(), one)


def vertex_adjacency(faces: np.ndarray, n_vertices: int, max_degree: int = 16):
    """Host-side padded vertex adjacency (idx (V, K) int32, mask (V, K))."""
    adj = [[] for _ in range(n_vertices)]
    for a, b, c in np.asarray(faces):
        for u, v in ((a, b), (b, c), (c, a)):
            if v not in adj[u]:
                adj[u].append(v)
            if u not in adj[v]:
                adj[v].append(u)
    idx = np.zeros((n_vertices, max_degree), np.int32)
    mask = np.zeros((n_vertices, max_degree), bool)
    for i, lst in enumerate(adj):
        k = min(len(lst), max_degree)
        idx[i, :k] = lst[:k]
        mask[i, :k] = True
    return idx, mask
