"""Scene composition: render several Gaussian sets in one pass.

Port of ``sugar_tpu/models/compositor.py`` (reference: SuGaRCompositor,
sugar_scene/sugar_compositor.py:12-245). Several (possibly edited or
animated) models are concatenated, each optionally sub-selected by a mask
and moved by a rigid transform, and rendered through ONE rasterizer call,
so occlusion between them is resolved per pixel. The transforms are what
the Blender export scripts write (``io/blender_interop.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.core.quaternions import matrix_to_quaternion, quaternion_raw_multiply
from sugar_tpu_torch.raster import common as rcm
from sugar_tpu_torch.raster.api import rasterize_gaussians


@dataclasses.dataclass
class GaussianSet:
    """One renderable component: activated Gaussian tensors and an optional
    rigid transform (R (3,3), t (3,)) applied at composite time."""

    centers: torch.Tensor
    scales: torch.Tensor
    quaternions: torch.Tensor
    opacities: torch.Tensor
    colors: torch.Tensor  # (N, 3) precomputed RGB (viewer-style)
    transform_R: torch.Tensor | None = None
    transform_t: torch.Tensor | None = None
    mask: torch.Tensor | None = None  # bool subset (idx_to_render analog)


def composite_render(
    sets: Sequence[GaussianSet],
    camera: Camera,
    bg: torch.Tensor | None = None,
    dup_capacity: int | None = None,
    k_max: int = 1024,
) -> dict:
    """Concatenate all sets (transforms applied) and render once, in the
    ``"tiled"`` mode as the JAX package does, on the sets' device."""
    centers, scales, quats, opac, colors, alive = [], [], [], [], [], []
    for s in sets:
        c, q = s.centers, s.quaternions
        if s.transform_R is not None:
            c = c @ s.transform_R.T
            if s.transform_t is not None:
                c = c + s.transform_t
            qr = matrix_to_quaternion(s.transform_R[None])[0]
            q = quaternion_raw_multiply(qr[None, :], q)
        centers.append(c)
        scales.append(s.scales)
        quats.append(q)
        opac.append(s.opacities)
        colors.append(s.colors)
        alive.append(s.mask if s.mask is not None
                     else torch.ones(c.shape[0], dtype=torch.bool, device=c.device))
    centers = torch.cat(centers)
    if dup_capacity is None:
        dup_capacity = 8 * centers.shape[0]
    settings = rcm.from_camera(camera, bg=bg, device=centers.device)
    return rasterize_gaussians(
        centers,
        torch.cat(opac),
        settings,
        scales=torch.cat(scales),
        quaternions=torch.cat(quats),
        colors=torch.cat(colors),
        alive_mask=torch.cat(alive),
        mode="tiled",
        dup_capacity=dup_capacity,
        k_max=k_max,
    )
