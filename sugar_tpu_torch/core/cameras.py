"""Camera containers.

Port of ``sugar_tpu/core/cameras.py``. A :class:`Camera` carries the
world-to-view and full projection matrices in row convention
(``p_cam = W2C @ p_h``) as torch tensors; image size and FoV tangents are
plain Python numbers. Cameras are built from the same numpy (R, T, fov,
size) arguments as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sugar_tpu_torch.core import transforms as tf


@dataclasses.dataclass(frozen=True)
class Camera:
    """One pinhole camera.

    Attributes:
      world_view: (4,4) world-to-camera, row convention.
      full_proj: (4,4) projection @ world_view.
      cam_center: (3,) camera position in world space.
      height, width: image size in pixels.
      tan_half_fov_x, tan_half_fov_y: FoV tangents.
    """

    world_view: torch.Tensor
    full_proj: torch.Tensor
    cam_center: torch.Tensor
    height: int
    width: int
    tan_half_fov_x: float
    tan_half_fov_y: float

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tan_half_fov_x)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tan_half_fov_y)


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    fov_x: float,
    fov_y: float,
    height: int,
    width: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    cx: float | None = None,
    cy: float | None = None,
    device: str | torch.device = "cuda",
) -> Camera:
    """Build a Camera from 3DGS-convention (R, T) + FoV.

    ``R`` is the cam-to-world rotation (stored transposed as in 3DGS), ``T``
    the world-to-cam translation. (cx, cy) are pixel-space principal points
    (default: image center). The matrices are computed in numpy exactly as
    the JAX package computes them, then placed on ``device``.
    """
    w2v = tf.world_to_view(R, T)
    cx_ndc = 0.0 if cx is None else 2.0 * cx / width - 1.0
    cy_ndc = 0.0 if cy is None else 2.0 * cy / height - 1.0
    proj = tf.projection_matrix(znear, zfar, fov_x, fov_y, cx_ndc, cy_ndc)
    full = (proj @ w2v).astype(np.float32)
    cam_center = np.linalg.inv(w2v)[:3, 3].astype(np.float32)
    return Camera(
        world_view=torch.as_tensor(w2v, device=device),
        full_proj=torch.as_tensor(full, device=device),
        cam_center=torch.as_tensor(cam_center, device=device),
        height=int(height),
        width=int(width),
        tan_half_fov_x=float(np.tan(fov_x / 2.0)),
        tan_half_fov_y=float(np.tan(fov_y / 2.0)),
    )


@dataclasses.dataclass(frozen=True)
class Cameras:
    """A batch of same-resolution cameras (leading axis = camera index)."""

    world_view: torch.Tensor  # (N, 4, 4)
    full_proj: torch.Tensor  # (N, 4, 4)
    cam_center: torch.Tensor  # (N, 3)
    height: int
    width: int
    tan_half_fov_x: float
    tan_half_fov_y: float

    def __len__(self) -> int:
        return self.world_view.shape[0]

    def __getitem__(self, i: Any) -> Camera:
        return Camera(
            world_view=self.world_view[i],
            full_proj=self.full_proj[i],
            cam_center=self.cam_center[i],
            height=self.height,
            width=self.width,
            tan_half_fov_x=self.tan_half_fov_x,
            tan_half_fov_y=self.tan_half_fov_y,
        )

    @staticmethod
    def stack(cams: list[Camera]) -> "Cameras":
        c0 = cams[0]
        for c in cams:
            if (c.height, c.width) != (c0.height, c0.width):
                raise ValueError("Cameras.stack requires equal resolutions")
        return Cameras(
            world_view=torch.stack([c.world_view for c in cams]),
            full_proj=torch.stack([c.full_proj for c in cams]),
            cam_center=torch.stack([c.cam_center for c in cams]),
            height=c0.height,
            width=c0.width,
            tan_half_fov_x=c0.tan_half_fov_x,
            tan_half_fov_y=c0.tan_half_fov_y,
        )


def spatial_extent(cam_centers: torch.Tensor) -> torch.Tensor:
    """1.1 x the largest distance of the camera centers (M, 3) from their
    mean: the reference's ``get_spatial_extent`` (sugar_scene/cameras.py:
    418-545) and the nerf++ radius (dataset_readers.py:45-66)."""
    center = torch.mean(cam_centers, dim=0, keepdim=True)
    dist = torch.linalg.norm(cam_centers - center, dim=-1)
    return 1.1 * torch.max(dist)
