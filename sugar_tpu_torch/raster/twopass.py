"""The two-pass render: dense binning, one dup gather, then tile compositing.

Port of ``render_pallas`` (``sugar_tpu/raster/pallas_render.py:137-207``),
the ``"pallas_twopass"`` mode: ``bin_gaussians_dense`` lays the dup slots
out in [tile | depth] order without exact-support culling, ``gather_dup``
pulls the packed render data into that order, and ``tile_composite``
composites it (K1 forward, K2 backward and K3 in the gather's backward on
CUDA tensors; their plain versions on CPU tensors). It is the fused path's
cross-check and the basis of the JAX package's per-band compositing.
"""

from __future__ import annotations

import torch

from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.binning import Binning
from sugar_tpu_torch.raster.dup_gather import gather_dup, pack_params, pad_rows
from sugar_tpu_torch.raster.fused import composite_outputs
from sugar_tpu_torch.raster.preprocess import Preprocessed
from sugar_tpu_torch.raster.tile_composite import C_CHUNK, tile_composite


def render_twopass(
    prep: Preprocessed,
    binning: Binning,
    settings: rc.RasterSettings,
    max_per_tile: int = 8192,
) -> dict:
    """Composite a dense binning. Differentiable in ``prep``'s mean2d,
    conic, opacity and color and in ``settings.bg``; the gradient is zero
    when the binning's capacity truncated real slots."""
    ch = prep.color.shape[-1]
    n = prep.mean2d.shape[0]
    max_chunks = max(1, (max_per_tile + C_CHUNK - 1) // C_CHUNK)

    d = binning.sorted_gauss.shape[0]
    # Pad with the sentinel so the last tile's chunk walk stays in bounds.
    d_pad = ((d + C_CHUNK - 1) // C_CHUNK) * C_CHUNK + C_CHUNK
    gid = torch.cat([
        binning.sorted_gauss,
        torch.full((d_pad - d,), n, dtype=torch.int32, device=prep.mean2d.device),
    ])
    count_clip = torch.clamp(binning.tile_count, max=max_chunks * C_CHUNK)
    grads_exact = binning.num_rendered <= d

    packed = pad_rows(pack_params(prep.mean2d, prep.conic, prep.opacity, prep.color))
    dup_data = gather_dup(packed, gid, n, grads_exact, 6 + ch)

    img_t, final_t, n_contrib = tile_composite(
        binning.tile_start, count_clip, dup_data, settings.bg, settings.tiles_x, ch, max_chunks
    )
    return composite_outputs(img_t, final_t, n_contrib, binning.tile_count, max_chunks, settings)
