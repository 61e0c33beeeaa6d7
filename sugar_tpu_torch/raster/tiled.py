"""Tile-binned renderer in plain torch: the ``"tiled"`` oracle mode.

Port of ``sugar_tpu/raster/tiled.py`` (the recast of renderCUDA,
forward.cu:261-374): for ``tile_chunk`` tiles at once, gather each tile's
first ``k_max`` binned slots, evaluate (tiles, K, pixels) alphas, and
composite them with ``raster.composite``. Gradients come from autograd:
the gathers' backward is a scatter-add, as their transpose is in JAX.

Each tile's list is capped at ``k_max`` slots in depth order, so a deeper
tile loses its farthest Gaussians; ``tile_overflow`` reports the excess of
the deepest tile.
"""

from __future__ import annotations

import torch

from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster import composite as comp
from sugar_tpu_torch.raster.binning import Binning
from sugar_tpu_torch.raster.fused import assemble_tiles
from sugar_tpu_torch.raster.preprocess import Preprocessed


def render_tiled(
    prep: Preprocessed,
    binning: Binning,
    settings: rc.RasterSettings,
    k_max: int = 1024,
    tile_chunk: int = 64,
    compose_block: int = 128,
) -> dict:
    tx_n = settings.tiles_x
    num_tiles = tx_n * settings.tiles_y
    capacity = binning.sorted_gauss.shape[0]
    n = prep.mean2d.shape[0]
    dev = prep.mean2d.device

    # Per-tile pixel coordinates (CUDA pixf = integer pixel coordinates).
    t_ids = torch.arange(num_tiles, device=dev)
    py, px = torch.meshgrid(
        torch.arange(rc.TILE_Y, device=dev), torch.arange(rc.TILE_X, device=dev), indexing="ij"
    )
    pix_all = torch.stack(
        [
            (t_ids % tx_n)[:, None] * rc.TILE_X + px.reshape(-1)[None, :],
            torch.div(t_ids, tx_n, rounding_mode="floor")[:, None] * rc.TILE_Y
            + py.reshape(-1)[None, :],
        ],
        dim=-1,
    ).to(torch.float32)  # (T, 256, 2)

    k = torch.arange(k_max, device=dev)
    imgs, fts, ncs = [], [], []
    for t0 in range(0, num_tiles, tile_chunk):
        start = binning.tile_start[t0:t0 + tile_chunk].to(torch.int64)
        count = binning.tile_count[t0:t0 + tile_chunk]
        slots = torch.clamp(start[:, None] + k, max=capacity - 1)
        in_list = k < count[:, None]  # (B, K)
        # Ids past n (a dense binning's sentinel) read n - 1, as JAX's
        # clamped gather does; in_list masks them.
        gid = torch.clamp(binning.sorted_gauss[slots].to(torch.int64), max=n - 1)
        alpha = comp.alpha_from_conic(
            prep.mean2d[gid], prep.conic[gid], prep.opacity[gid], pix_all[t0:t0 + tile_chunk],
            in_list,
        )
        img, ft, nc = comp.composite_depth_ordered(
            alpha, prep.color[gid], settings.bg, block=compose_block
        )
        imgs.append(img)
        fts.append(ft)
        ncs.append(nc)

    image = assemble_tiles(torch.cat(imgs), settings)
    final_t = assemble_tiles(torch.cat(fts)[..., None], settings)[..., 0]
    n_contrib = assemble_tiles(torch.cat(ncs)[..., None], settings)[..., 0]
    tile_overflow = torch.clamp(binning.tile_count.max().to(torch.int64) - k_max, min=0)
    return dict(
        image=image,
        final_T=final_t,
        n_contrib=n_contrib,
        tile_overflow=tile_overflow,
    )
