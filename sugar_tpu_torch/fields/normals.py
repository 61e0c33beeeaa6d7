"""PCA point-cloud normal estimation.

Port of ``sugar_tpu/fields/normals.py`` (which replaces PyTorch3D's
``estimate_pointcloud_normals``, used by
SuGaR.get_normals(estimate_from_points=True), sugar_model.py:946-961, for
the Gaussian-centers mesh-extraction ablation, coarse_mesh.py:499): for
each point, the normal is the smallest-eigenvalue eigenvector of its
k-neighborhood covariance, with the PyTorch3D majority disambiguation
(flip when fewer than half the neighbor offsets lie in the normal's
positive halfspace). ``torch.linalg.eigh`` picks its own eigenvector signs,
so normals agree with the JAX package's after the disambiguation, and only
where the smallest eigenvalue is simple and the vote is not tied.
"""

from __future__ import annotations

import torch

from sugar_tpu_torch.fields.knn import knn


def estimate_pointcloud_normals(
    points: torch.Tensor,  # (N, 3)
    neighborhood_size: int = 32,
    disambiguate_directions: bool = True,
    mask: torch.Tensor | None = None,  # (N,) bool
) -> torch.Tensor:
    """Returns unit normals (N, 3)."""
    k = neighborhood_size
    _, idx = knn(points, points, k=k, ref_mask=mask)
    nbrs = points[idx]  # (N, K, 3)
    d = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", d, d) / k
    # eigh returns ascending eigenvalues; the first eigenvector spans the
    # direction of least variance = the surface normal.
    _, vecs = torch.linalg.eigh(cov)
    normals = vecs[..., 0]
    if disambiguate_directions:
        proj = (normals[:, None, :] * (nbrs - points[:, None, :])).sum(dim=-1)
        n_pos = (proj > 0).sum(dim=1)
        normals = torch.where((n_pos < 0.5 * k)[:, None], -normals, normals)
    norm = torch.linalg.norm(normals, dim=-1, keepdim=True)
    return normals / torch.clamp_min(norm, 1e-12)
