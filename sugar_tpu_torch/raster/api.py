"""High-level rasterization API.

Port of ``sugar_tpu/raster/api.py``: ``rasterize_gaussians`` wires
preprocess -> binning -> compositing; ``rasterize_preprocessed`` is its
part after preprocess, for callers that preprocess another way
(``models/render.py`` through ``preprocess_fields``). Outputs mirror the
JAX package's (image, radii, final_T, n_contrib) plus the capacity
diagnostics that ``raster.adaptive`` reads.

The mode names are the JAX package's, so call sites carry over:

- ``"pallas"``: the fused production path (``raster/fused.py``; the CUDA
  kernels on CUDA tensors, their plain versions on CPU tensors).
  ``"auto"`` resolves to it on every device.
- ``"pallas_twopass"``: dense binning + one dup gather + the same
  compositing kernels (``raster/twopass.py``).
- ``"tiled"``: tile-binned compositing in plain torch
  (``raster/tiled.py``), the oracle the JAX package trains with on a CPU.
- ``"reference"``: brute force over every (pixel, Gaussian) pair
  (``raster/reference_impl.py``); small scenes only.

The render is differentiable with respect to means3d, scales,
quaternions, cov3d, opacities, colors or shs, and the ``ndc_offset``
screen-space probe, whose gradient feeds densification (as
viewspace_points.grad does in the reference). On CUDA tensors the
backward of the two kernel modes runs the compositing-backward kernel (K2)
and the gradient segment-sum kernel (K3).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any

import numpy as np
import torch

from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.binning import bin_gaussians, bin_gaussians_dense
from sugar_tpu_torch.raster.fused import render_fused
from sugar_tpu_torch.raster.preprocess import Preprocessed, preprocess
from sugar_tpu_torch.raster.reference_impl import render_reference
from sugar_tpu_torch.raster.tiled import render_tiled
from sugar_tpu_torch.raster.twopass import render_twopass

MODES = ("pallas", "pallas_twopass", "tiled", "reference")


def resolve_mode(mode: str) -> str:
    """Resolve ``mode='auto'`` to the fused production path, ``"pallas"``,
    on every device (the JAX package sends a CPU to its tiled path; the
    port's CPU runs the kernels' plain versions instead)."""
    if mode == "auto":
        return "pallas"
    if mode not in MODES:
        raise ValueError(f"unknown mode: {mode}")
    return mode


def rasterize_gaussians(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    settings: rc.RasterSettings,
    scales: torch.Tensor | None = None,
    quaternions: torch.Tensor | None = None,
    cov3d: torch.Tensor | None = None,
    colors: torch.Tensor | None = None,
    shs: torch.Tensor | None = None,
    alive_mask: torch.Tensor | None = None,
    ndc_offset: torch.Tensor | None = None,
    mode: str = "auto",
    dup_capacity: int | None = None,
    k_max: int = 1024,
    tile_chunk: int = 64,
    tile_cap: int | None = None,
    cap_a: int = 4,
    big_cap: int | None = None,
    debug: bool = False,
) -> dict[str, Any]:
    """Render one view on the device of ``means3d``. Returns dict(image
    (H,W,C), radii, final_T, n_contrib) plus the overflow diagnostics of
    the mode (none for ``"reference"``).

    ``dup_capacity`` defaults to 8 * N. ``tile_cap`` (the kernel modes'
    per-Gaussian cap on covered tile rects) defaults to max(16,
    dup_capacity // N); excess rects are dropped and counted in
    ``bin_overflow`` (or let ``raster.adaptive.render_adaptive`` grow the
    caps). ``tile_chunk`` is the ``"tiled"`` mode's tiles per batch;
    ``cap_a`` and ``big_cap`` size the fused path's buckets.

    ``debug``: the analog of the CUDA rasterizer's debug flag
    (diff_gaussian_rasterization/__init__.py:83-90): after the render, the
    host checks every input and the output image for non-finite values
    and, on failure, writes an ``.npz`` input snapshot to
    ``$SUGAR_TPU_SNAPSHOT_DIR`` (default: the temporary directory) for
    offline forwarding, as the JAX package does. Only this check reads the
    render back to the host.
    """
    mode = resolve_mode(mode)
    prep = preprocess(
        means3d,
        opacities,
        settings,
        scales=scales,
        quaternions=quaternions,
        cov3d=cov3d,
        colors=colors,
        shs=shs,
        alive_mask=alive_mask,
        ndc_offset=ndc_offset,
    )
    out = rasterize_preprocessed(
        prep, settings, mode=mode, dup_capacity=dup_capacity, k_max=k_max,
        tile_chunk=tile_chunk, tile_cap=tile_cap, cap_a=cap_a, big_cap=big_cap,
    )
    if debug:
        _debug_snapshot(dict(
            means3d=means3d, opacities=opacities, scales=scales, quaternions=quaternions,
            colors=colors, shs=shs, image=out["image"],
        ))
    return out


def rasterize_preprocessed(
    prep: Preprocessed,
    settings: rc.RasterSettings,
    mode: str = "auto",
    dup_capacity: int | None = None,
    k_max: int = 1024,
    tile_chunk: int = 64,
    tile_cap: int | None = None,
    cap_a: int = 4,
    big_cap: int | None = None,
) -> dict[str, Any]:
    """Everything of ``rasterize_gaussians`` after preprocess: binning and
    compositing of ``prep`` in ``mode``, and ``radii``. The arguments and
    outputs are ``rasterize_gaussians``'s."""
    mode = resolve_mode(mode)
    n = prep.mean2d.shape[0]
    if dup_capacity is None:
        dup_capacity = 8 * n
    if tile_cap is None:
        # Floored at 16 so large near-camera splats are not clipped when
        # dup_capacity / N is small (overflow is still counted).
        tile_cap = max(16, dup_capacity // n)
    if mode == "reference":
        out = render_reference(prep, settings)
    elif mode == "tiled":
        binning = bin_gaussians(prep, settings, dup_capacity)
        out = render_tiled(prep, binning, settings, k_max=k_max, tile_chunk=tile_chunk)
        out["bin_overflow"] = binning.overflow
        out["num_rendered"] = binning.num_rendered
        # The tiled path's bin overflow is a total-capacity truncation, so
        # it doubles as cap_overflow; k_max sizing reads max_tile_count.
        out["cap_overflow"] = binning.overflow
        out["max_tile_count"] = binning.tile_count.max()
    elif mode == "pallas":
        out = render_fused(
            prep, settings, tile_cap=tile_cap, capacity=dup_capacity,
            max_per_tile=k_max, cap_a=cap_a, big_cap=big_cap,
        )
    else:  # pallas_twopass
        binning = bin_gaussians_dense(prep, settings, tile_cap, capacity=dup_capacity)
        out = render_twopass(prep, binning, settings, max_per_tile=k_max)
        out["bin_overflow"] = binning.overflow
        out["num_rendered"] = binning.num_rendered
        d = binning.sorted_gauss.shape[0]
        out["cap_overflow"] = torch.clamp(binning.num_rendered - d, min=0)
        out["max_tiles_touched"] = prep.tiles_touched.max()
    out["radii"] = prep.radius
    return out


def _debug_snapshot(arrays: dict) -> None:
    """Host-side finiteness check + input snapshot dump (debug=True)."""
    host = {k: v.detach().cpu().numpy() for k, v in arrays.items() if v is not None}
    bad = [k for k, v in host.items() if not np.isfinite(v).all()]
    if not bad:
        return
    out_dir = os.environ.get("SUGAR_TPU_SNAPSHOT_DIR", tempfile.gettempdir())
    path = os.path.join(out_dir, f"sugar_tpu_snapshot_{int(time.time())}.npz")
    np.savez_compressed(path, **host)
    print(
        f"[sugar_tpu debug] non-finite values in {bad}; "
        f"input snapshot written to {path} (forward it in a bug report, "
        f"as with the CUDA rasterizer's snapshot_fw.dump)"
    )
