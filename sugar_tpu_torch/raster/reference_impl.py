"""Brute-force O(pixels x Gaussians) renderer: the ``"reference"`` oracle mode.

Port of ``sugar_tpu/raster/reference_impl.py``. It keeps the CUDA
pipeline's semantics, tile-rect visibility included (a Gaussian reaches a
pixel iff the pixel's 16x16 tile meets its bounding rect, forward.cu:
276-282 + auxiliary.h:46-56), without any binning: one global stable depth
sort, then every Gaussian against every pixel, ``pixel_chunk`` pixels at a
time. Differentiable; slow by design, for small scenes only.
"""

from __future__ import annotations

import torch

from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster import composite as comp
from sugar_tpu_torch.raster.preprocess import Preprocessed


def render_reference(
    prep: Preprocessed,
    settings: rc.RasterSettings,
    pixel_chunk: int = 2048,
) -> dict:
    """Returns dict(image (H, W, C), final_T (H, W), n_contrib (H, W))."""
    h, w = settings.image_height, settings.image_width
    dev = prep.depth.device

    # A global stable depth sort equals the per-tile [tile | depth] CUDA
    # order restricted to each tile (ties keep Gaussian index order).
    alive = prep.tiles_touched > 0
    sort_depth = torch.where(alive, prep.depth.detach(), torch.inf)
    order = torch.sort(sort_depth, stable=True).indices
    mean2d = prep.mean2d[order]
    conic = prep.conic[order]
    opacity = prep.opacity[order]
    color = prep.color[order]
    rect_min = prep.rect_min[order]
    rect_max = prep.rect_max[order]
    valid = alive[order]

    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij"
    )
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    pix = torch.stack([xs, ys], dim=-1).to(torch.float32)
    tiles = torch.stack([xs // rc.TILE_X, ys // rc.TILE_Y], dim=-1).to(torch.int32)

    imgs, fts, ncs = [], [], []
    for p0 in range(0, h * w, pixel_chunk):
        pix_c, tile_c = pix[p0:p0 + pixel_chunk], tiles[p0:p0 + pixel_chunk]
        covered = (
            (tile_c[None, :, 0] >= rect_min[:, None, 0])
            & (tile_c[None, :, 0] < rect_max[:, None, 0])
            & (tile_c[None, :, 1] >= rect_min[:, None, 1])
            & (tile_c[None, :, 1] < rect_max[:, None, 1])
        )  # (N, P)
        alpha = comp.alpha_from_conic(mean2d, conic, opacity, pix_c, valid)
        alpha = torch.where(covered, alpha, 0.0)
        img, ft, nc = comp.composite_depth_ordered(alpha, color, settings.bg)
        imgs.append(img)
        fts.append(ft)
        ncs.append(nc)
    c = color.shape[-1]
    return dict(
        image=torch.cat(imgs).reshape(h, w, c),
        final_T=torch.cat(fts).reshape(h, w),
        n_contrib=torch.cat(ncs).reshape(h, w),
    )
