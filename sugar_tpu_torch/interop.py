"""Carrying Gaussian weights across from the JAX package.

The JAX package's ``GaussianParams`` fields, as numpy arrays (for example
``{f: np.asarray(getattr(params, f)) for f in PARAM_FIELDS}``), become the
port's tensors; nothing is converted in value. Its optimizer state
(``AdamState``: mu, nu, count, at any iteration), densify statistics
(``DensifyStats``) and the coarse stage's KNN table cross the same way, so
a training run can move between the packages. The PLY format is the other
route (``models.gaussians.load_ply`` reads files the JAX package wrote).
The refined stage's mesh-bound state (``BoundParams`` fields, the faces,
the Gaussians per triangle and the thickness) and its ``BoundAdamState``
cross as numpy too.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from sugar_tpu_torch.models.densifier import DensifyStats
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel, GaussianParams
from sugar_tpu_torch.refine import bound as B
from sugar_tpu_torch.refine.trainer import BoundAdamState
from sugar_tpu_torch.trainers.optimizer import AdamState


def params_from_numpy(
    d: Mapping[str, np.ndarray], device: str | torch.device = "cuda"
) -> GaussianParams:
    """GaussianParams from a dict of the six raw fields (xyz, sh_dc,
    sh_rest, opacity_logit, log_scales, quaternions) as float32 arrays."""
    missing = [f for f in PARAM_FIELDS if f not in d]
    if missing:
        raise KeyError(f"missing GaussianParams fields: {missing}")
    return GaussianParams(
        **{
            f: torch.as_tensor(np.ascontiguousarray(d[f], dtype=np.float32), device=device)
            for f in PARAM_FIELDS
        }
    )


def model_from_numpy(
    d: Mapping[str, np.ndarray],
    alive: np.ndarray,
    sh_degree: int,
    device: str | torch.device = "cuda",
) -> GaussianModel:
    """GaussianModel from raw fields, the (N,) alive mask and the SH degree."""
    return GaussianModel(
        params_from_numpy(d, device),
        torch.as_tensor(np.asarray(alive, dtype=bool), device=device),
        int(sh_degree),
    )


def adam_from_numpy(
    mu: Mapping[str, np.ndarray],
    nu: Mapping[str, np.ndarray],
    count: int,
    device: str | torch.device = "cuda",
) -> AdamState:
    """AdamState from the first and second moments (dicts of the six
    fields) and the global step count."""
    return AdamState(
        mu=params_from_numpy(mu, device),
        nu=params_from_numpy(nu, device),
        count=torch.tensor(int(count), dtype=torch.int32, device=device),
    )


def stats_from_numpy(
    grad_accum: np.ndarray,
    denom: np.ndarray,
    max_radii: np.ndarray,
    device: str | torch.device = "cuda",
) -> DensifyStats:
    """DensifyStats from its three (N,) float32 arrays."""
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)  # noqa: E731
    return DensifyStats(grad_accum=t(grad_accum), denom=t(denom), max_radii=t(max_radii))


def knn_table_from_numpy(idx: np.ndarray, device: str | torch.device = "cuda") -> torch.Tensor:
    """The coarse stage's (N, K) neighbor table (the JAX package keeps it
    int32) as the port's int64 index tensor."""
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


def _bound_params(d: Mapping[str, np.ndarray], device) -> B.BoundParams:
    missing = [f for f in B.BOUND_FIELDS if f not in d]
    if missing:
        raise KeyError(f"missing BoundParams fields: {missing}")
    return B.BoundParams(**{
        f: torch.as_tensor(np.ascontiguousarray(d[f], dtype=np.float32), device=device)
        for f in B.BOUND_FIELDS
    })


def bound_from_numpy(
    d: Mapping[str, np.ndarray],
    faces: np.ndarray,
    n_per_triangle: int,
    thickness: float,
    device: str | torch.device = "cuda",
) -> tuple[B.BoundParams, B.BoundMesh]:
    """(BoundParams, BoundMesh) from the six raw fields (vertices,
    log_scales, complex_rot, opacity_logit, sh_dc, sh_rest) as float32
    arrays, the (F, 3) faces (int32 in the JAX package; int64 here), the
    Gaussians per triangle and the thickness."""
    _, bary = B.BARY_TABLES[int(n_per_triangle)]
    bm = B.BoundMesh(
        faces=torch.as_tensor(np.asarray(faces, dtype=np.int64), device=device),
        bary=torch.as_tensor(np.asarray(bary, dtype=np.float32), device=device),
        thickness=torch.tensor(float(thickness), dtype=torch.float32, device=device),
        n_per_triangle=int(n_per_triangle),
    )
    return _bound_params(d, device), bm


def bound_adam_from_numpy(
    mu: Mapping[str, np.ndarray],
    nu: Mapping[str, np.ndarray],
    count: int,
    device: str | torch.device = "cuda",
) -> BoundAdamState:
    """BoundAdamState from the first and second moments (dicts of the six
    BoundParams fields) and the step count."""
    return BoundAdamState(
        mu=_bound_params(mu, device),
        nu=_bound_params(nu, device),
        count=torch.tensor(int(count), dtype=torch.int32, device=device),
    )
