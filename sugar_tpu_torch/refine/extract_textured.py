"""Stage 4: textured mesh extraction from a refined model.

Port of ``sugar_tpu/refine/extract_textured.py``, which mirrors
sugar_extractors/refined_mesh.py:14-222: optionally post-process the mesh
(drop low-density border faces), bake the UV texture from Gaussian renders
over all training cameras, and save the textured .obj (+ .mtl + .png).
The renders run on the params' device (K1 on CUDA tensors, one launch per
camera), at the JAX package's fixed caps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.io.obj import save_obj
from sugar_tpu_torch.refine import bound as B
from sugar_tpu_torch.refine.texture import bake_texture
from sugar_tpu_torch.refine.trainer import render_bound


@dataclasses.dataclass
class TextureConfig:
    square_size: int = 10
    postprocess_mesh: bool = False
    postprocess_density_threshold: float = 0.1
    postprocess_iterations: int = 5


def postprocess_mesh(
    params: B.BoundParams, bm: B.BoundMesh, cfg: TextureConfig
) -> tuple[B.BoundParams, B.BoundMesh]:
    """Iteratively peel border faces whose Gaussians have low opacity
    (refined_mesh.py:125-187): a face is dropped when it lies on the mesh
    border (an edge not shared by two faces) and its max Gaussian opacity is
    below the threshold."""
    faces = bm.faces.cpu().numpy()
    gpt = bm.n_per_triangle
    op = torch.sigmoid(params.opacity_logit).cpu().numpy().reshape(-1, gpt).max(axis=1)
    keep_face = np.ones(len(faces), bool)
    for _ in range(cfg.postprocess_iterations):
        f = faces[keep_face]
        edges = np.sort(
            np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1
        )
        _, inv, counts = np.unique(edges, axis=0, return_inverse=True, return_counts=True)
        border_edge = counts[inv.reshape(-1)] == 1  # (3F,)
        border_face_local = border_edge.reshape(3, -1).any(axis=0)
        idx_global = np.nonzero(keep_face)[0]
        drop = border_face_local & (op[idx_global] < cfg.postprocess_density_threshold)
        if not drop.any():
            break
        keep_face[idx_global[drop]] = False

    keep_g = torch.as_tensor(np.repeat(keep_face, gpt), device=params.vertices.device)
    new_params = B.BoundParams(
        vertices=params.vertices,
        log_scales=params.log_scales[keep_g],
        complex_rot=params.complex_rot[keep_g],
        opacity_logit=params.opacity_logit[keep_g],
        sh_dc=params.sh_dc[keep_g],
        sh_rest=params.sh_rest[keep_g],
    )
    new_bm = dataclasses.replace(bm, faces=bm.faces[torch.as_tensor(keep_face, device=bm.faces.device)])
    return new_params, new_bm


def extract_textured_mesh(
    params: B.BoundParams,
    bm: B.BoundMesh,
    cameras: list[Camera],
    output_path: str,
    cfg: TextureConfig = TextureConfig(),
    sh_degree: int = 3,
    dup_capacity: int = 2**21,
    k_max: int = 1024,
) -> str:
    """Bake texture + save the textured OBJ. Returns the obj path."""
    if cfg.postprocess_mesh:
        params, bm = postprocess_mesh(params, bm, cfg)

    bg = torch.zeros((3,), dtype=torch.float32, device=params.vertices.device)

    @torch.no_grad()
    def render_fn(cam):
        out = render_bound(params, bm, cam, sh_degree, bg, dup_capacity, k_max)
        return out["image"]

    texture, verts_uv, _ = bake_texture(
        params, bm, cameras, render_fn, square_size=cfg.square_size
    )
    save_obj(
        output_path,
        params.vertices.cpu().numpy(),
        bm.faces.cpu().numpy(),
        verts_uv=verts_uv,
        texture=texture,
    )
    return output_path
