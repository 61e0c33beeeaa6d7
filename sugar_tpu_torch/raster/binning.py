"""Static-capacity duplication helper.

Port of ``bucketize_by_offsets`` from ``sugar_tpu/raster/binning.py``, which
the mesh rasterizer (``refine/mesh_raster.py``) uses to expand faces into
per-tile slots. The rest of that module is the ``tiled`` oracle mode's
binning, not ported yet (ROADMAP.md, queue 1, oracle modes).
"""

from __future__ import annotations

import torch


def bucketize_by_offsets(offsets: torch.Tensor, size: int) -> torch.Tensor:
    """For sorted exclusive-cumsum ``offsets`` (N,), return g (size,) int64
    with g[d] = last index whose offset <= d (-1 where none is)."""
    d = torch.arange(size, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets, d, right=True) - 1
