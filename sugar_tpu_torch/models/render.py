"""Model-level rendering: GaussianModel + Camera -> image.

Port of ``sugar_tpu/models/render.py``: builds raster settings from the
camera, applies the activations and renders through
``raster.api.rasterize_gaussians`` on the model's device. ``render_params``
is the training path's entry: differentiable in the raw params through
sigmoid, exp and the quaternion normalization.
"""

from __future__ import annotations

import dataclasses

import torch

from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.core.quaternions import normalize as quat_normalize
from sugar_tpu_torch.models.gaussians import GaussianModel, GaussianParams
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.api import rasterize_gaussians
from sugar_tpu_torch.utils import profiling


def render_model(
    model: GaussianModel,
    camera: Camera,
    bg: torch.Tensor | None = None,
    active_sh_degree: int | None = None,
    ndc_offset: torch.Tensor | None = None,
    colors_override: torch.Tensor | None = None,
    dup_capacity: int | None = None,
    k_max: int = 1024,
    mode: str = "auto",
    tile_cap: int | None = None,
    cap_a: int = 4,
    big_cap: int | None = None,
) -> dict:
    """Render one view of the model. ``colors_override`` bypasses SH (depth
    or feature renders). Its top span is ``render.model`` when no other
    is open (the served view)."""
    if active_sh_degree is None:
        active_sh_degree = model.sh_degree
    with profiling.span("render.model", outermost=True):
        with profiling.span("render.setup"):
            settings = dataclasses.replace(
                rc.from_camera(camera, bg=bg, device=model.device), sh_degree=active_sh_degree
            )
            k = (active_sh_degree + 1) ** 2
            opacities, scales, quaternions = model.opacities, model.scales, model.quaternions
            shs = None if colors_override is not None else model.sh[:, :, :k]
        return rasterize_gaussians(
            model.params.xyz,
            opacities,
            settings,
            scales=scales,
            quaternions=quaternions,
            colors=colors_override,
            shs=shs,
            alive_mask=model.alive,
            ndc_offset=ndc_offset,
            mode=mode,
            dup_capacity=dup_capacity,
            k_max=k_max,
            tile_cap=tile_cap,
            cap_a=cap_a,
            big_cap=big_cap,
        )


def render_params(
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    active_sh_degree: int,
    bg: torch.Tensor,
    ndc_offset: torch.Tensor | None = None,
    dup_capacity: int | None = None,
    k_max: int = 1024,
    mode: str = "auto",
    tile_cap: int | None = None,
    cap_a: int = 4,
    big_cap: int | None = None,
) -> dict:
    """Render from raw params (the training path's entry point); the image
    is differentiable in every field of ``params`` and in ``ndc_offset``."""
    with profiling.span("render.setup"):
        settings = dataclasses.replace(
            rc.from_camera(camera, bg=bg, device=params.xyz.device), sh_degree=active_sh_degree
        )
        k = (active_sh_degree + 1) ** 2
        sh = torch.cat([params.sh_dc[:, :, None], params.sh_rest], dim=-1)
        opacities = torch.sigmoid(params.opacity_logit)
        scales = torch.exp(params.log_scales)
        quaternions = quat_normalize(params.quaternions)
    return rasterize_gaussians(
        params.xyz,
        opacities,
        settings,
        scales=scales,
        quaternions=quaternions,
        shs=sh[:, :, :k],
        alive_mask=alive,
        ndc_offset=ndc_offset,
        mode=mode,
        dup_capacity=dup_capacity,
        k_max=k_max,
        tile_cap=tile_cap,
        cap_a=cap_a,
        big_cap=big_cap,
    )
