"""Shared constants and settings for the Gaussian rasterizer.

Port of ``sugar_tpu/raster/common.py``. The constants are part of the
gradient semantics and must equal the reference CUDA rasterizer's (and the
JAX package's) exactly:

- ``ALPHA_CLAMP``  — per-sample alpha ceiling 0.99 (forward.cu:253).
- ``ALPHA_CUTOFF`` — samples with alpha < 1/255 are skipped (forward.cu:254).
- ``T_EPS``        — a pixel stops compositing when its transmittance would
  drop below 1e-4 (forward.cu:256-261).
- ``LOWPASS``      — +0.3 px² screen-space low-pass on cov2D diagonals.
- ``Z_CULL``       — near-cull at view z <= 0.2.
- ``RADIUS_SIGMA`` — bounding radius = ceil(3 * sqrt(max eigenvalue)).
- ``FOV_CLAMP``    — EWA Jacobian input clamped to 1.3 * tan(fov/2).
"""

from __future__ import annotations

import dataclasses

import torch

ALPHA_CLAMP = 0.99
ALPHA_CUTOFF = 1.0 / 255.0
T_EPS = 1e-4
LOWPASS = 0.3
Z_CULL = 0.2
RADIUS_SIGMA = 3.0
FOV_CLAMP = 1.3
W_EPS = 1e-7  # added to homogeneous w before divide (forward.cu:197-199)

TILE_X = 16
TILE_Y = 16


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    """Settings for one rasterization call (GaussianRasterizationSettings).

    The tensor fields live on the device the render runs on.
    """

    viewmatrix: torch.Tensor  # (4,4) world-to-cam, row convention
    projmatrix: torch.Tensor  # (4,4) full projection = P @ W2C, row convention
    campos: torch.Tensor  # (3,)
    bg: torch.Tensor  # (C,) background color
    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    sh_degree: int = 0
    scale_modifier: float = 1.0

    @property
    def focal_x(self) -> float:
        return self.image_width / (2.0 * self.tanfovx)

    @property
    def focal_y(self) -> float:
        return self.image_height / (2.0 * self.tanfovy)

    @property
    def tiles_x(self) -> int:
        return (self.image_width + TILE_X - 1) // TILE_X

    @property
    def tiles_y(self) -> int:
        return (self.image_height + TILE_Y - 1) // TILE_Y


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient: maximum then minimum,
    which split the gradient 0.5/0.5 at a tie (a background pixel is
    exactly 0) where ``torch.clamp`` passes all of it."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), lo_t.new_tensor(hi))


def from_camera(camera, bg: torch.Tensor | None = None, device=None) -> RasterSettings:
    """Build RasterSettings from a core.cameras.Camera, on ``device``
    (default: the camera's)."""
    device = camera.world_view.device if device is None else torch.device(device)
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=device)
    return RasterSettings(
        viewmatrix=camera.world_view.to(device),
        projmatrix=camera.full_proj.to(device),
        campos=camera.cam_center.to(device),
        bg=bg.to(device),
        image_height=camera.height,
        image_width=camera.width,
        tanfovx=camera.tan_half_fov_x,
        tanfovy=camera.tan_half_fov_y,
    )
