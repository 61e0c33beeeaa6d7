"""Tile binning with static capacities: duplicate -> sort -> per-tile ranges.

Port of ``sugar_tpu/raster/binning.py``, the binning of the oracle modes
(the production path bins in ``raster/fused.py``):

- ``bin_gaussians`` (the ``"tiled"`` mode): a stable depth presort of the
  Gaussians, an exclusive cumsum of their tile counts, each dup slot's
  source found by a searchsorted over those offsets, then one stable sort
  by tile id.
- ``bin_gaussians_dense`` (the ``"pallas_twopass"`` mode): every Gaussian
  owns a row of ``tile_cap`` slots whose tile ids are elementwise math,
  then one sort by [tile | depth rank].

Both give the JAX package's arrays bit for bit: within a tile, slots keep
depth order and equal depths keep Gaussian index order (the depth presort
is stable), as in the CUDA rasterizer's [tileID | depth] radix sort.
``bucketize_by_offsets`` is also the mesh rasterizer's slot expansion
(``refine/mesh_raster.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.preprocess import Preprocessed


@dataclasses.dataclass(frozen=True)
class Binning:
    sorted_gauss: torch.Tensor  # (capacity,) int32 Gaussian index per dup slot
    sorted_tile: torch.Tensor  # (capacity,) int32 tile id (num_tiles = invalid)
    tile_start: torch.Tensor  # (num_tiles,) int32 offset into the sorted arrays
    tile_count: torch.Tensor  # (num_tiles,) int32
    num_rendered: torch.Tensor  # () int64 true total duplications
    overflow: torch.Tensor  # () int64 dropped duplications (0 = exact)


def bucketize_by_offsets(offsets: torch.Tensor, size: int) -> torch.Tensor:
    """For sorted exclusive-cumsum ``offsets`` (N,), return g (size,) int64
    with g[d] = last index whose offset <= d (-1 where none is)."""
    d = torch.arange(size, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets, d, right=True) - 1


def depth_order(depth: torch.Tensor) -> torch.Tensor:
    """Stable depth presort of all N Gaussians (culled ones included):
    equal depths keep index order. torch.sort and lax.sort both keep -0.0
    and +0.0 tied, and sort NaN last."""
    return torch.sort(depth, stable=True).indices


def tile_ranges(sorted_tile: torch.Tensor, num_tiles: int):
    """Per-tile [start, count) from sorted tile ids: dense ids, so end[t]
    == start[t+1]."""
    bounds = torch.searchsorted(
        sorted_tile,
        torch.arange(num_tiles + 1, dtype=torch.int32, device=sorted_tile.device),
        side="left",
    ).to(torch.int32)
    return bounds[:num_tiles].contiguous(), (bounds[1:] - bounds[:num_tiles]).contiguous()


@torch.no_grad()
def bin_gaussians(prep: Preprocessed, settings: rc.RasterSettings, capacity: int) -> Binning:
    """Searchsorted binning into ``capacity`` dup slots; slots past the
    true total carry tile id ``num_tiles`` (and the last depth-ranked
    Gaussian's id, as in the JAX package). ``overflow`` counts the
    duplications beyond ``capacity``."""
    n = prep.tiles_touched.shape[0]
    dev = prep.depth.device
    num_tiles = settings.tiles_x * settings.tiles_y

    # 1. Depth presort (N keys). Culled Gaussians emit no dups.
    gsort = depth_order(prep.depth)
    counts = prep.tiles_touched[gsort].to(torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts  # exclusive
    total = offsets[-1] + counts[-1]

    # 2. Dense expansion: dup slot -> depth rank r -> Gaussian g.
    d = torch.arange(capacity, dtype=torch.int32, device=dev)
    r = torch.clamp(bucketize_by_offsets(offsets, capacity), 0, n - 1)
    g = gsort[r].to(torch.int32)
    local = d - offsets[r]
    in_range = (d < total) & (local < counts[r])

    rmin = prep.rect_min[g]  # (capacity, 2)
    rw_safe = torch.clamp(prep.rect_max[g, 0] - rmin[:, 0], min=1)
    # local >= 0 always (r is the last offset <= d), so floor division is
    # the JAX package's truncating // and %.
    tx = rmin[:, 0] + local % rw_safe
    ty = rmin[:, 1] + torch.div(local, rw_safe, rounding_mode="floor")
    tile_id = torch.where(in_range, ty * settings.tiles_x + tx, num_tiles).to(torch.int32)

    # 3. One stable sort by tile: emission is depth-major, so within-tile
    # order is depth order (ties: Gaussian index).
    sorted_tile, perm = torch.sort(tile_id, stable=True)
    sorted_gauss = g[perm]

    tile_start, tile_count = tile_ranges(sorted_tile, num_tiles)
    total = total.to(torch.int64)
    return Binning(
        sorted_gauss=sorted_gauss,
        sorted_tile=sorted_tile,
        tile_start=tile_start,
        tile_count=tile_count,
        num_rendered=total,
        overflow=torch.clamp(total - capacity, min=0),
    )


@torch.no_grad()
def bin_gaussians_dense(
    prep: Preprocessed,
    settings: rc.RasterSettings,
    tile_cap: int,
    capacity: int | None = None,
) -> Binning:
    """Dense binning: Gaussian i (in depth order) owns ``tile_cap`` slots,
    slot (i, j) being the j-th tile of its rect, row-major (duplicateWithKeys
    order, rasterizer_impl.cu:70-111); invalid slots carry tile id
    ``num_tiles`` and the sentinel Gaussian id ``n`` and sort to the tail.

    Rect tiles past ``tile_cap`` are dropped and counted in ``overflow``.
    ``capacity`` (default N * tile_cap, lossless) truncates the sorted
    arrays; the duplications past it are counted in ``overflow`` too.
    """
    n = prep.tiles_touched.shape[0]
    dev = prep.depth.device
    num_tiles = settings.tiles_x * settings.tiles_y

    # 1. Depth presort + one packed gather into depth order.
    gsort = depth_order(prep.depth)
    counts = torch.clamp(prep.tiles_touched, max=tile_cap).to(torch.int32)
    pk = torch.stack(
        [
            prep.rect_min[:, 0],
            prep.rect_min[:, 1],
            torch.clamp(prep.rect_max[:, 0] - prep.rect_min[:, 0], min=1),
            counts,
        ]
    )[:, gsort]  # (4, N)

    # 2. Slot (i, j) -> tile id. j // w as floor(f32(j) / f32(w)), exactly
    # as the JAX package takes it (exact for j < 2^24).
    j = torch.arange(tile_cap, dtype=torch.int32, device=dev)[None, :]
    w = pk[2][:, None]
    ty_off = torch.floor(j.to(torch.float32) / w.to(torch.float32)).to(torch.int32)
    tx_off = j - ty_off * w
    tile_e = (pk[1][:, None] + ty_off) * settings.tiles_x + pk[0][:, None] + tx_off
    valid_e = j < pk[3][:, None]
    tile_e = torch.where(valid_e, tile_e, num_tiles)
    gid_e = torch.where(valid_e, gsort.to(torch.int32)[:, None], n)

    # 3. One sort by [tile | depth rank] (int64, so no 31-bit limit): valid
    # keys are unique, and each Gaussian has one slot per tile, so this is
    # the order of both of the JAX package's branches. Invalid slots all
    # carry (num_tiles, n), whatever their order.
    rank_bits = max(1, (n - 1).bit_length())
    rank_e = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    key_e = (tile_e.to(torch.int64) << rank_bits) | rank_e
    sorted_key, order = torch.sort(key_e.reshape(-1))
    sorted_tile = (sorted_key >> rank_bits).to(torch.int32)
    sorted_gauss = gid_e.reshape(-1)[order].to(torch.int32)

    num_rendered = counts.sum(dtype=torch.int64)
    cap_overflow = torch.zeros((), dtype=torch.int64, device=dev)
    if capacity is not None and capacity < n * tile_cap:
        sorted_tile = sorted_tile[:capacity].contiguous()
        sorted_gauss = sorted_gauss[:capacity].contiguous()
        cap_overflow = torch.clamp(num_rendered - capacity, min=0)

    tile_start, tile_count = tile_ranges(sorted_tile, num_tiles)
    rect_overflow = torch.clamp(prep.tiles_touched - tile_cap, min=0).sum(dtype=torch.int64)
    return Binning(
        sorted_gauss=sorted_gauss,
        sorted_tile=sorted_tile,
        tile_start=tile_start,
        tile_count=tile_count,
        num_rendered=num_rendered,
        overflow=rect_overflow + cap_overflow,
    )
