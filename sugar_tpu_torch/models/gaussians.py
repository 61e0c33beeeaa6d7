"""Padded 3D Gaussian model.

Port of ``sugar_tpu/models/gaussians.py``. Parameters live in fixed-
``capacity`` tensors with an ``alive`` mask (dead slots are force-culled
by the rasterizer), as in the JAX package, so checkpoints and PLY files
carry over slot for slot.

Activations match the reference: scales = exp(log_scales), opacity =
sigmoid(logit), rotation = L2-normalized quaternion. SH layout: ``sh_dc``
(N, 3) + ``sh_rest`` (N, 3, K-1), channel-major, as in the PLY contract.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sugar_tpu_torch.core import sh as sh_lib
from sugar_tpu_torch.core.quaternions import normalize as quat_normalize
from sugar_tpu_torch.io import ply as ply_io

PARAM_FIELDS = ("xyz", "sh_dc", "sh_rest", "opacity_logit", "log_scales", "quaternions")


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


@dataclasses.dataclass(frozen=True)
class GaussianParams:
    """Raw (pre-activation) parameters; all (capacity, ...)."""

    xyz: torch.Tensor  # (N, 3)
    sh_dc: torch.Tensor  # (N, 3)
    sh_rest: torch.Tensor  # (N, 3, K-1)
    opacity_logit: torch.Tensor  # (N,)
    log_scales: torch.Tensor  # (N, 3)
    quaternions: torch.Tensor  # (N, 4) raw; normalized on use


@dataclasses.dataclass(frozen=True)
class GaussianModel:
    """Params + aliveness + SH degree."""

    params: GaussianParams
    alive: torch.Tensor  # (N,) bool
    sh_degree: int

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device

    @property
    def n_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.params.log_scales)

    @property
    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity_logit)

    @property
    def quaternions(self) -> torch.Tensor:
        return quat_normalize(self.params.quaternions)

    @property
    def sh(self) -> torch.Tensor:
        """(N, 3, K) full SH coefficient tensor."""
        return torch.cat([self.params.sh_dc[:, :, None], self.params.sh_rest], dim=-1)


def mean_sq_dist_3nn(points: np.ndarray) -> np.ndarray:
    """Mean squared distance to the 3 nearest neighbors (simple-knn
    ``distCUDA2`` semantics, spatial.cu:15-27). Host-side init helper."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    d, _ = tree.query(points, k=4)  # includes self at d[:,0]=0
    return np.mean(d[:, 1:4] ** 2, axis=1)


def create_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    capacity: int,
    sh_degree: int = 3,
    initial_opacity: float = 0.1,
    device: str | torch.device = "cuda",
) -> GaussianModel:
    """Initialize from a COLMAP/random point cloud, on ``device``.

    Reference semantics (gaussian_model.py:124-147): SH-DC from RGB2SH,
    isotropic log-scale = log(sqrt(mean 3-NN sq dist)) clamped at 1e-7,
    identity rotations, opacity logit = inverse_sigmoid(0.1). Padding
    slots get the fill values of ``load_ply`` and are not alive.
    """
    n = points.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < point count {n}")
    k = sh_lib.num_sh_coeffs(sh_degree)

    dist2 = np.maximum(mean_sq_dist_3nn(points), 1e-7)
    log_s = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)

    def pad(x, fill=0.0):
        shape = (capacity - n,) + x.shape[1:]
        return np.concatenate([x, np.full(shape, fill, x.dtype)], axis=0)

    # x / (1 - x) in double, the log in float32: the JAX package's order.
    ratio = initial_opacity / (1.0 - initial_opacity)
    logit = float(torch.log(torch.tensor(ratio, dtype=torch.float32)))
    quats = pad(np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)))
    quats[n:, 0] = 1.0
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    arrays = dict(
        xyz=pad(points.astype(np.float32)),
        sh_dc=pad(np.asarray(sh_lib.rgb_to_sh0(colors)).astype(np.float32)),
        sh_rest=pad(np.zeros((n, 3, k - 1), np.float32)),
        opacity_logit=pad(np.full(n, logit, np.float32), fill=-10.0),
        log_scales=pad(log_s.astype(np.float32), fill=-10.0),
        quaternions=quats,
    )
    params = GaussianParams(**{f: torch.as_tensor(v, device=device) for f, v in arrays.items()})
    return GaussianModel(params, torch.as_tensor(alive, device=device), sh_degree)


def save_ply(model: GaussianModel, path: str) -> None:
    """Write alive Gaussians in the canonical 3DGS PLY format."""
    alive = model.alive.cpu().numpy()
    p = model.params
    arrays = {f: getattr(p, f).detach().cpu().numpy()[alive] for f in PARAM_FIELDS}
    ply_io.save_gaussian_ply(path, **arrays)


def load_ply(
    path: str,
    capacity: int | None = None,
    sh_degree: int | None = None,
    device: str | torch.device = "cuda",
) -> GaussianModel:
    """Load a 3DGS PLY into a padded model on ``device``.

    ``capacity`` defaults to the count rounded up to a multiple of 256;
    ``sh_degree`` is inferred from the f_rest attribute count when not
    given. Padding slots get the JAX package's fill values (opacity and
    log-scale -10, identity rotation) and are not alive.
    """
    d = ply_io.load_gaussian_ply(path)
    n = d["xyz"].shape[0]
    if sh_degree is None:
        k_total = d["sh_rest"].shape[-1] + 1
        sh_degree = int(round(np.sqrt(k_total))) - 1
    k = sh_lib.num_sh_coeffs(sh_degree)
    if d["sh_rest"].shape[-1] != k - 1:
        raise ValueError(f"PLY has {d['sh_rest'].shape[-1]} rest coeffs, expected {k - 1}")
    if capacity is None:
        capacity = ((n + 255) // 256) * 256

    def pad(x, fill=0.0):
        shape = (capacity - n,) + x.shape[1:]
        return np.concatenate([x, np.full(shape, fill, x.dtype)], axis=0)

    quats = pad(d["quaternions"])
    quats[n:, 0] = 1.0
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    arrays = dict(
        xyz=pad(d["xyz"]),
        sh_dc=pad(d["sh_dc"]),
        sh_rest=pad(d["sh_rest"]),
        opacity_logit=pad(d["opacity_logit"], fill=-10.0),
        log_scales=pad(d["log_scales"], fill=-10.0),
        quaternions=quats,
    )
    params = GaussianParams(**{f: torch.as_tensor(v, device=device) for f, v in arrays.items()})
    return GaussianModel(params, torch.as_tensor(alive, device=device), sh_degree)
