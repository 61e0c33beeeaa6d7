"""Coarse mesh extraction pipeline: level-set cloud -> Poisson -> mesh.

Port of ``sugar_tpu/meshing/extract.py``, which mirrors
sugar_extractors/coarse_mesh.py:13-489:
1. hard-prune Gaussians with opacity < 0.5 (:188-197);
2. accumulate the level-set point cloud (10M points) with colors/normals
   over all training cameras (:230-327), on the model's device;
3. split foreground / background by the camera-bbox (factors 1.0 / 4.0,
   :40-41, 337-359);
4. per part, on the host: statistical outlier removal (20 NN, 20 sigma,
   :382), Poisson reconstruction (:389-390; the FFT solver of
   meshing.poisson), drop the lowest-10% density vertices (:392-395), QEM
   decimation to the target vertex budget (:434-449), cleanup (:451-463);
5. merge parts and write the `.ply` (:465-489).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sugar_tpu_torch.core import sh as sh_lib
from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.io import ply as ply_io
from sugar_tpu_torch.meshing import levelset, meshops, poisson
from sugar_tpu_torch.models.densifier import prune_low_opacity
from sugar_tpu_torch.models.gaussians import GaussianModel
from sugar_tpu_torch.parallel.meshing import collect_surface_points_sharded


@dataclasses.dataclass
class ExtractConfig:
    surface_level: float = 0.3
    decimation_target: int = 1_000_000
    total_points: int = 10_000_000
    poisson_resolution: int = 256
    vertices_density_quantile: float = 0.1
    fg_bbox_factor: float = 1.0
    bg_bbox_factor: float = 4.0
    prune_opacity_threshold: float = 0.5
    outlier_nb_neighbors: int = 20
    outlier_std_ratio: float = 20.0
    dup_capacity: int = 2**22
    k_max: int = 1024


def _bbox_mask(points: np.ndarray, centers: np.ndarray, factor: float) -> np.ndarray:
    lo, hi = centers.min(0), centers.max(0)
    c = (lo + hi) / 2
    half = (hi - lo) / 2
    # Coplanar/collinear camera rigs give a degenerate bbox axis; widen such
    # axes to the largest extent so the split doesn't reject everything.
    half = np.where(half < 1e-3 * half.max(), half.max(), half) * factor
    return np.all(np.abs(points - c) <= half + 1e-9, axis=-1)


def extract_mesh_from_coarse_model(
    model: GaussianModel,
    cameras: list[Camera],
    cfg: ExtractConfig = ExtractConfig(),
    output_path: str | None = None,
    rng: np.random.Generator | None = None,
    device_mesh: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Run the full extraction on the model's device (the level set) and
    the host (the rest); returns (vertices, faces) and optionally writes
    the PLY, with vertex colors.

    With ``device_mesh`` (a number of ranks; the JAX package takes a
    ``jax.sharding.Mesh``), the per-camera level-set collection runs over
    that many ranks on the model's device type (``parallel.meshing``); the
    collected cloud is the single-device one."""
    rng = rng or np.random.default_rng(0)
    model = prune_low_opacity(model, cfg.prune_opacity_threshold)

    # SH-0 colors per gaussian for the cloud (coarse_mesh.py:254-264 renders
    # them; DC-only evaluation is equivalent for deg 0).
    colors = sh_lib.sh0_to_rgb(model.params.sh_dc).cpu().numpy()

    collect_kwargs = dict(
        surface_level=cfg.surface_level,
        total_points=cfg.total_points,
        rng=rng,
        dup_capacity=cfg.dup_capacity,
        k_max=cfg.k_max,
        colors_per_gaussian=colors,
    )
    if device_mesh is not None:
        cloud = collect_surface_points_sharded(device_mesh, model, cameras,
                                               device=model.device.type, **collect_kwargs)
    else:
        cloud = levelset.collect_surface_points(model, cameras, **collect_kwargs)
    pts, normals = cloud["points"], cloud["normals"]
    centers = np.stack([c.cam_center.cpu().numpy() for c in cameras])

    fg_mask = _bbox_mask(pts, centers, cfg.fg_bbox_factor)
    bg_mask = _bbox_mask(pts, centers, cfg.bg_bbox_factor) & ~fg_mask

    parts = []
    for mask, n_dec in (
        (fg_mask, cfg.decimation_target),
        (bg_mask, cfg.decimation_target),
    ):
        p = pts[mask]
        if len(p) < 100:
            continue
        nrm = normals[mask]
        p, (nrm,) = meshops.remove_statistical_outliers(
            p, [nrm], cfg.outlier_nb_neighbors, cfg.outlier_std_ratio
        )
        res = poisson.poisson_reconstruct(p, nrm, resolution=cfg.poisson_resolution)
        v, f = poisson.remove_low_density_vertices(res, cfg.vertices_density_quantile)
        v, f = meshops.decimate(v, f, n_dec)
        v, f = meshops.clean_mesh(v, f)
        parts.append((v, f))

    verts, faces = meshops.merge_meshes(parts)
    # Vertex colors: nearest level-set point's color (the reference's Open3D
    # Poisson interpolates cloud colors onto the mesh, coarse_mesh.py:389,
    # 465-489; refine initializes its SH-DC from these vertex colors,
    # sugar_model.py:216-224).
    vcolors = None
    if cloud.get("colors") is not None and len(verts) > 0:
        from scipy.spatial import cKDTree

        _, nn = cKDTree(pts).query(verts, k=1)
        vcolors = np.clip(cloud["colors"][nn], 0.0, 1.0)
    if output_path is not None:
        ply_io.save_mesh_ply(output_path, verts, faces, vertex_colors=vcolors)
    return verts, faces
