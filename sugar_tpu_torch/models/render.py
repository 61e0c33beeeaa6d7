"""Model-level rendering: GaussianModel + Camera -> image.

Port of ``sugar_tpu/models/render.py``: builds raster settings from the
camera and renders the model's raw fields on its device through
``raster.preprocess.preprocess_fields`` and
``raster.api.rasterize_preprocessed``. On a CUDA device
``preprocess_fields`` takes the activations and preprocess in one kernel
launch, and a render that needs its gradient (a training render) their
VJP in one launch of the backward kernel; on the CPU it takes
differentiable torch ops. ``render_params`` is the training path's entry:
differentiable in the raw params through sigmoid, exp and the quaternion
normalization.
"""

from __future__ import annotations

import dataclasses

import torch

from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.models.gaussians import GaussianModel, GaussianParams
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.api import rasterize_preprocessed
from sugar_tpu_torch.raster.preprocess import preprocess_fields
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
        return _render(
            model.params, model.alive, camera, active_sh_degree, bg, ndc_offset, colors_override,
            dict(mode=mode, dup_capacity=dup_capacity, k_max=k_max, tile_cap=tile_cap,
                 cap_a=cap_a, big_cap=big_cap),
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
    is differentiable in every field of ``params`` and in ``ndc_offset``
    whenever one of them requires grad."""
    return _render(
        params, alive, camera, active_sh_degree, bg, ndc_offset, None,
        dict(mode=mode, dup_capacity=dup_capacity, k_max=k_max, tile_cap=tile_cap, cap_a=cap_a,
             big_cap=big_cap),
    )


def _render(params, alive, camera, active_sh_degree, bg, ndc_offset, colors, raster_kw) -> dict:
    """Settings from the camera, ``preprocess_fields``, then
    ``rasterize_preprocessed`` with ``raster_kw``."""
    with profiling.span("render.setup"):
        settings = dataclasses.replace(
            rc.from_camera(camera, bg=bg, device=params.xyz.device), sh_degree=active_sh_degree
        )
    prep = preprocess_fields(
        params.xyz, params.opacity_logit, params.log_scales, params.quaternions, params.sh_dc,
        params.sh_rest, settings, alive_mask=alive, colors=colors, ndc_offset=ndc_offset,
    )
    return rasterize_preprocessed(prep, settings, **raster_kw)
