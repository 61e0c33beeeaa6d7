"""Packing per-Gaussian render data and gathering it into dup-slot order.

Port of ``sugar_tpu/raster/pallas_render.py`` (``pack_params``,
``gather_dup`` and its custom VJP) plus the row pad of
``sugar_tpu/raster/fused.py:354-362``. The packed layout is the
compositing kernel's input: component-major rows 0:2 mean2d, 2:5 conic,
5 opacity, 6:6+CH color, zero-padded to a multiple of 8 rows.

The gather's transpose reduces dup-slot cotangents onto Gaussians without
a scatter: sort the slots by Gaussian id, permute the cotangent columns
with one ``index_select``, then sum each id's contiguous segment
(``raster.segsum``, the kernel K3 on the card). Only the live rows are
reduced; the padding rows are constants and their cotangent is dropped.
"""

from __future__ import annotations

import torch

from sugar_tpu_torch.raster.segsum import segment_sum_sorted
from sugar_tpu_torch.utils import profiling


def round8(x: int) -> int:
    return ((x + 7) // 8) * 8


def pack_params(mean, conic, opac, color) -> torch.Tensor:
    """(N,2),(N,3),(N,),(N,CH) -> packed (6+CH, N)."""
    return torch.cat([mean.T, conic.T, opac[None, :], color.T], dim=0)


def pad_rows(packed: torch.Tensor) -> torch.Tensor:
    """Zero-pad packed rows to the next multiple of 8 (the kernel layout)."""
    rows, n = packed.shape
    pad = round8(rows) - rows
    if pad == 0:
        return packed
    return torch.cat([packed, packed.new_zeros((pad, n))], dim=0)


class GatherDup(torch.autograd.Function):
    """dup_data = packed[:, min(gid, n-1)], with the segment-sum backward of
    ``pallas_render._gather_dup_bwd``."""

    @staticmethod
    def forward(ctx, packed, gid, n, grads_exact, live_rows):
        safe = torch.clamp(gid, max=n - 1).to(torch.int64)
        ctx.save_for_backward(gid, grads_exact)
        ctx.n = n
        ctx.live_rows = live_rows
        ctx.rows = packed.shape[0]
        return packed.index_select(1, safe)

    @staticmethod
    @profiling.spanned("raster.gather_bwd")
    def backward(ctx, ct):
        gid, grads_exact = ctx.saved_tensors
        n, live = ctx.n, ctx.live_rows
        gid_sorted, perm = torch.sort(gid.to(torch.int32), stable=True)
        y = ct[:live].index_select(1, perm).contiguous()
        d = segment_sum_sorted(y, gid_sorted.contiguous(), n)
        if ctx.rows > live:
            d = torch.cat([d, d.new_zeros((ctx.rows - live, n))], dim=0)
        # Truncated capacity leaves the slot -> Gaussian map incomplete: give
        # zeros, not misattributed gradients (selected on the device, no sync).
        d = torch.where(grads_exact, d, 0.0)
        return d, None, None, None, None


def gather_dup(
    packed: torch.Tensor,
    gid: torch.Tensor,
    n: int,
    grads_exact: torch.Tensor,
    live_rows: int,
) -> torch.Tensor:
    """dup_data (ROWS, D) = packed (ROWS, n) [:, gid (D,)].

    ``gid`` entries equal to ``n`` mark padding/invalid slots; they read
    column n-1, as in the JAX package (their values are never composited),
    and their cotangent is dropped. ``grads_exact`` () bool: False when the
    capacity truncated real slots, and the backward then returns zeros.
    ``live_rows`` bounds the rows whose cotangent is reduced. The backward
    needs no per-Gaussian counts: the segments come from the sorted ids.
    """
    return GatherDup.apply(packed, gid, n, grads_exact, live_rows)


def gather_dup_searchsorted(
    packed: torch.Tensor, gid: torch.Tensor, n: int, live_rows: int
) -> torch.Tensor:
    """``pallas_render.gather_dup_searchsorted``: the gather whose backward
    is correct for ANY multiset of ``gid`` (a Gaussian's slots split across
    bands, with no per-band counts). ``GatherDup``'s backward already finds
    the segments from the sorted ids alone, so this is the same gather with
    its gradient always exact (K3 on the card)."""
    exact = torch.ones((), dtype=torch.bool, device=packed.device)
    return GatherDup.apply(packed, gid, n, exact, live_rows)
