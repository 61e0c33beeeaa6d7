"""Mesh-extraction ablation paths from the reference extractor.

Port of ``sugar_tpu/meshing/ablations.py``. coarse_mesh.py keeps two
alternative extraction strategies next to the main level-set+Poisson path:

- :func:`extract_mesh_from_gaussian_centers` (coarse_mesh.py:491-622):
  Poisson directly on the Gaussian centers with PCA normals.
- :func:`extract_mesh_with_marching_cubes` (coarse_mesh.py:623-757):
  density field evaluated on a regular grid, iso-surface at the surface
  level (surface nets stand in for PyMCubes; same watertight output class).

KNN, the PCA normals and the field query run on the model's device; the
rest is the host numpy of ``meshing.poisson`` and ``meshing.meshops``.
"""

from __future__ import annotations

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.fields import density as df
from sugar_tpu_torch.fields.knn import knn
from sugar_tpu_torch.fields.normals import estimate_pointcloud_normals
from sugar_tpu_torch.meshing import meshops
from sugar_tpu_torch.meshing.poisson import (
    poisson_reconstruct,
    remove_low_density_vertices,
    surface_nets,
)
from sugar_tpu_torch.models.gaussians import GaussianModel


def _field_params(model: GaussianModel) -> df.GaussianFieldParams:
    return df.GaussianFieldParams(
        centers=model.params.xyz,
        scales=model.scales,
        quaternions=model.quaternions,
        opacities=model.opacities,
    )


@torch.no_grad()
def extract_mesh_from_gaussian_centers(
    model: GaussianModel,
    cameras: list[Camera],
    poisson_resolution: int = 192,
    decimation_target: int = 200_000,
    density_quantile: float = 0.1,
    neighborhood_size: int = 32,
) -> tuple[np.ndarray, np.ndarray]:
    """Poisson over the Gaussian centers with PCA-estimated normals
    (get_normals(estimate_from_points=True), sugar_model.py:956-961)."""
    centers = model.params.xyz[model.alive]
    normals = estimate_pointcloud_normals(
        centers,
        neighborhood_size=min(neighborhood_size, max(len(centers), 1)),
        disambiguate_directions=True,
    ).cpu().numpy()
    centers = centers.cpu().numpy()

    centers, (normals,) = meshops.remove_statistical_outliers(centers, [normals])
    res = poisson_reconstruct(centers, normals, resolution=poisson_resolution)
    v, f = remove_low_density_vertices(res, density_quantile)
    v, f = meshops.decimate(v, f, decimation_target)
    return meshops.clean_mesh(v, f)


@torch.no_grad()
def extract_mesh_with_marching_cubes(
    model: GaussianModel,
    surface_level: float = 0.5,
    resolution: int = 256,
    knn_neighbors: int = 16,
    padding: float = 0.05,
    decimation_target: int | None = None,
    chunk: int = 2**17,
) -> tuple[np.ndarray, np.ndarray]:
    """Iso-surface of the density field on a regular grid."""
    gp = _field_params(model)
    pts = model.params.xyz[model.alive].cpu().numpy()
    lo, hi = pts.min(0), pts.max(0)
    span = (hi - lo).max()
    c = (hi + lo) / 2
    half = span * (0.5 + padding)
    origin = c - half
    scale = 2 * half / (resolution - 1)

    axes = [np.arange(resolution) * scale + origin[i] for i in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    grid_pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)

    dens = np.empty(len(grid_pts), np.float32)
    for i in range(0, len(grid_pts), chunk):
        q = torch.as_tensor(grid_pts[i : i + chunk], device=model.device)
        _, idx = knn(q, model.params.xyz, k=knn_neighbors, ref_mask=model.alive)
        out = df.field_values(q, idx, gp, return_sdf=False)
        dens[i : i + chunk] = torch.clamp_max(out["density"], 1.0).cpu().numpy()
    field = dens.reshape(resolution, resolution, resolution)

    verts_g, faces = surface_nets(field, surface_level)
    verts = verts_g * scale + origin
    if decimation_target:
        verts, faces = meshops.decimate(verts, faces, decimation_target)
    return meshops.clean_mesh(verts.astype(np.float32), faces)
