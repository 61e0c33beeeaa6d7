"""UV texture baking for the refined mesh.

Port of ``sugar_tpu/refine/texture.py``. Reference semantics
(sugar_model.py:2464-2677 extract_texture_image_and_uv_from_gaussians):
consecutive face pairs (2i, 2i+1) share square i of a square texture atlas
(bottom/top diagonal split, corners inset by a few pixels against
bleeding); texels are initialized from the SH-DC color of the face's
Gaussians and then refined by averaging back-projected Gaussian renders
over all training cameras: each image pixel is mapped through the mesh
rasterizer to (face, barycentric) -> UV -> texel, and colors are
scatter-averaged into texel bins (sugar_model.py:2648-2675).

The rasterizer runs on the vertices' device and its outputs come to the
host once per camera; the atlas, the UV interpolation, the texel binning
and the accumulation are the JAX package's host numpy, unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from sugar_tpu_torch.core import sh as sh_lib
from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.refine import bound as B
from sugar_tpu_torch.refine.mesh_raster import rasterize_mesh


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_uv_atlas(n_triangles: int, square_size: int = 10):
    """Per-face-corner UVs. Returns (verts_uv (F, 3, 2) in [0,1],
    texture_size). Layout: faces (2i, 2i+1) = bottom/top triangles of square
    i, with the reference's pixel insets (sugar_model.py:2502-2533)."""
    if square_size < 3:
        raise ValueError(f"square_size must be at least 3, got {square_size}")
    n_squares = n_triangles // 2 + 1
    n_axis = int(np.sqrt(n_squares) + 1)
    tex_size = square_size * n_axis

    sq = np.arange(n_squares)
    su = sq // n_axis
    sv = sq % n_axis
    base = np.stack([su, sv], axis=-1)[:, None, :]  # (S, 1, 2)
    u = np.array([[1, 0]])
    v = np.array([[0, 1]])
    # bottom: (base+u, base, base+u+v); top: (base+v, base, base+u+v).
    bottom = np.concatenate([base + u[None], base, base + (u + v)[None]], axis=1)
    top = np.concatenate([base + v[None], base, base + (u + v)[None]], axis=1)
    bottom = bottom * square_size + np.array([[-2, 1], [2, 1], [-2, -3]])[None]
    top = top * square_size + np.array([[1, -1], [1, 3], [-3, -1]])[None]

    verts_uv = np.empty((2 * n_squares, 3, 2), np.float64)
    verts_uv[0::2] = bottom
    verts_uv[1::2] = top
    verts_uv = verts_uv[:n_triangles] / tex_size
    return verts_uv.astype(np.float32), tex_size


def bake_texture(
    params: B.BoundParams,
    bm: B.BoundMesh,
    cameras: list[Camera],
    render_fn,
    square_size: int = 10,
    raster_dup_capacity: int = 2**20,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Bake the texture. ``render_fn(camera) -> (H, W, 3)`` renders the
    refined Gaussians (a tensor or an array). Returns (texture (S, S, 3)
    float, verts_uv (F, 3, 2), texture_size)."""
    faces = bm.faces.cpu().numpy()
    n_faces = len(faces)
    verts_uv, tex_size = build_uv_atlas(n_faces, square_size)

    acc = np.zeros((tex_size * tex_size, 3), np.float64)
    cnt = np.zeros((tex_size * tex_size,), np.float64)
    for cam in cameras:
        img = np.clip(_host(render_fn(cam)), 0.0, 1.0)  # (H, W, 3)
        ras = rasterize_mesh(params.vertices, bm.faces, cam, dup_capacity=raster_dup_capacity)
        fidx = ras["face_idx"].cpu().numpy().reshape(-1)
        bary = ras["bary"].cpu().numpy().reshape(-1, 3)
        hit = fidx >= 0
        f_h = fidx[hit]
        uv = np.einsum("nkc,nk->nc", verts_uv[f_h], bary[hit])  # (N, 2) in [0,1]
        # uv -> texel (row = u axis * size, col = v axis * size), matching the
        # atlas build above.
        ti = np.clip((uv[:, 0] * tex_size).astype(np.int64), 0, tex_size - 1)
        tj = np.clip((uv[:, 1] * tex_size).astype(np.int64), 0, tex_size - 1)
        lin = ti * tex_size + tj
        np.add.at(acc, lin, img.reshape(-1, 3)[hit])
        np.add.at(cnt, lin, 1.0)

    # Initialize texels with per-face SH-DC color (argmax opacity gaussian,
    # sugar_model.py:2585-2607), then overwrite observed texels.
    gpt = bm.n_per_triangle
    op = _host(params.opacity_logit).reshape(n_faces, gpt)
    sh_dc = _host(params.sh_dc).reshape(n_faces, gpt, 3)
    best = np.argmax(op, axis=1)
    base_rgb = np.asarray(sh_lib.sh0_to_rgb(sh_dc[np.arange(n_faces), best])).clip(0, 1)

    texture = np.zeros((tex_size * tex_size, 3), np.float32)
    # paint each face's square region with its base color
    centers_uv = verts_uv.mean(axis=1)  # (F, 2)
    ci = np.clip((centers_uv[:, 0] * tex_size).astype(np.int64), 0, tex_size - 1)
    cj = np.clip((centers_uv[:, 1] * tex_size).astype(np.int64), 0, tex_size - 1)
    # fill whole squares (both triangles of a square share the base color of
    # the first one for the unobserved-texel fallback)
    for k in range(0, n_faces, 2):
        su, sv = ci[k] // square_size, cj[k] // square_size
        i0, j0 = su * square_size, sv * square_size
        block = np.broadcast_to(base_rgb[k], (square_size, square_size, 3))
        texture.reshape(tex_size, tex_size, 3)[i0 : i0 + square_size, j0 : j0 + square_size] = block

    observed = cnt > 0
    texture[observed] = (acc[observed] / cnt[observed, None]).astype(np.float32)
    return texture.reshape(tex_size, tex_size, 3), verts_uv, tex_size


def render_textured_mesh(
    vertices,
    faces,
    verts_uv: np.ndarray,
    texture: np.ndarray,
    camera: Camera,
    bg: np.ndarray | None = None,
    dup_capacity: int = 2**20,
    k_max: int = 256,
) -> np.ndarray:
    """Render the UV-textured mesh for one camera: rasterize (face id +
    barycentrics) on the camera's device, interpolate per-face-corner UVs
    and sample the texture with nearest texels on the host (the atlas has
    per-square insets so nearest matches the bake). The equivalent of the
    reference's textured-render evaluation (metrics.py:283-300,
    MeshRasterizer + TexturesUV).

    ``verts_uv`` is (F, 3, 2) per-face-corner UVs (build_uv_atlas layout);
    ``texture`` is (S, S, 3) float. Returns (H, W, 3) float image.
    """
    dev = camera.world_view.device
    ras = rasterize_mesh(
        torch.as_tensor(vertices, dtype=torch.float32, device=dev),
        torch.as_tensor(faces, device=dev), camera, dup_capacity=dup_capacity, k_max=k_max,
    )
    fidx = ras["face_idx"].cpu().numpy()  # (H, W)
    bary = ras["bary"].cpu().numpy()  # (H, W, 3)
    h, w = fidx.shape
    tex_size = texture.shape[0]
    hit = fidx >= 0
    f_h = fidx[hit]
    uv = np.einsum("nkc,nk->nc", verts_uv[f_h], bary[hit])
    ti = np.clip((uv[:, 0] * tex_size).astype(np.int64), 0, tex_size - 1)
    tj = np.clip((uv[:, 1] * tex_size).astype(np.int64), 0, tex_size - 1)
    img = np.zeros((h, w, 3), np.float32)
    if bg is not None:
        img[:] = np.asarray(bg, np.float32)
    img[hit] = texture.reshape(-1, 3)[ti * tex_size + tj]
    return img
