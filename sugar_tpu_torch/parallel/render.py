"""Tile-sharded differentiable rendering across ranks.

Port of ``sugar_tpu/parallel/render.py`` (``render_sharded``). Gaussians
are sharded across the ranks of one axis, and the image's tile rows are
split into as many horizontal bands, rank i owning band i. Per view, on
each rank:

1. preprocess its Gaussian shard (local);
2. gather the packed per-Gaussian render rows (ROWS, N) from every rank
   (``comm.all_gather``, "partitioned": each rank composites its own band,
   so the backward sums the packed cotangents and keeps this rank's slice,
   JAX's ``psum_scatter``);
3. expand the shard into (tile, depth, gid) slots with the fused path's
   exact-support culling (``raster.fused.expand_support_culled``, the
   float depth as payload: a per-shard depth rank would not be globally
   consistent) and group them by destination band (a sort by tile). This
   is the torch route of the fused binning on every device, the card
   included (the path has no benchmark cell): ``tile_cap``, ``cap_a``
   and ``big_cap`` bound it here, and rect or bucket slots past them are
   dropped and counted, where ``bin_fused`` on the card has no such caps;
4. route fixed-capacity blocks of slots to the band owners
   (``comm.all_to_all``); slots past ``route_cap`` per (source, band) are
   dropped and counted in ``route_overflow``;
5. merge-sort the received slots by (tile, float depth, gid): the CUDA
   rasterizer's [tile | depth] order with index ties, independent of the
   rank count;
6. gather the band's slot data from the gathered packed rows
   (``raster.dup_gather.gather_dup_searchsorted``: its backward runs K3 on
   the card, over the band's slots into the whole Gaussian axis), with
   mean y moved to band-local pixel rows, and composite the band
   (``raster.tile_composite``: K1 forward, K2 backward);
7. sum the three overflow counters over the ranks.

Every piece is differentiable (the collectives, the gather's segment-sum
backward, the compositor's), so autograd of a loss over the band gives
the sharded backward: per-band K2 -> K3 onto the whole Gaussian axis ->
the reduce-scatter back to the shards.

The JAX package's ``tile_composite_reference`` (its pure-JAX CPU stand-in)
has no counterpart: ``tile_composite`` runs its plain version on CPU
tensors.
"""

from __future__ import annotations

import torch

from sugar_tpu_torch.parallel import comm
from sugar_tpu_torch.parallel.mesh import Axis, rows
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.dup_gather import gather_dup_searchsorted, pack_params, pad_rows
from sugar_tpu_torch.raster.fused import default_big_cap, expand_support_culled
from sugar_tpu_torch.raster.preprocess import preprocess
from sugar_tpu_torch.raster.tile_composite import C_CHUNK, R_MY, tile_composite


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def default_route_cap(n: int, size: int, tile_cap: int) -> int:
    """Slots per (source, band) block: twice the even share,
    ``tile_cap * n / size^2``, chunk-aligned (``render.py:155``)."""
    return _round_up(max(tile_cap * n // (size * size) * 2, C_CHUNK), C_CHUNK)


def check_shapes(axis: Axis, settings: rc.RasterSettings, n: int) -> None:
    """The JAX function's refusals: the tile rows and the Gaussians must
    divide among the ranks."""
    s = axis.size
    if settings.tiles_y % s != 0:
        raise ValueError(
            f"tiles_y={settings.tiles_y} must divide by the shard axis size {s} "
            "(pad the image height)"
        )
    if n % s != 0:
        raise ValueError(f"N={n} must divide by shard axis size {s}")


def _merge_order(tile: torch.Tensor, depth: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """The permutation sorting slots by (tile, depth, gid): stable passes
    from the last key to the first. Real slots' keys are unique (a
    Gaussian meets a tile once); sentinels (num_tiles, inf, n) tie."""
    o = torch.sort(gid, stable=True).indices
    o = o[torch.sort(depth[o], stable=True).indices]
    return o[torch.sort(tile[o], stable=True).indices]


def render_band(
    axis: Axis,
    n_total: int,
    means_l: torch.Tensor,
    opac_l: torch.Tensor,
    settings: rc.RasterSettings,
    scales_l: torch.Tensor | None = None,
    quats_l: torch.Tensor | None = None,
    colors_l: torch.Tensor | None = None,
    shs_l: torch.Tensor | None = None,
    alive_l: torch.Tensor | None = None,
    ndc_l: torch.Tensor | None = None,
    tile_cap: int = 16,
    route_cap: int | None = None,
    k_max: int = 8192,
    cap_a: int = 4,
    big_cap: int | None = None,
) -> dict:
    """This rank's band from this rank's Gaussian shard (the ``*_l``
    arrays, rows [index * n_total / size, ...) of the whole model).
    Returns dict(image (band_h, W, C), final_T, n_contrib (band_h, W),
    radii (shard), route_overflow, tile_overflow, kmax_overflow (summed
    over the ranks)); band_h = tiles_y / size * 16. Differentiable in every
    float input."""
    s, sidx = axis.size, axis.index
    n = n_total
    check_shapes(axis, settings, n)
    n_loc = means_l.shape[0]
    if n_loc * s != n:
        raise ValueError(f"the shard has {n_loc} rows, not {n} / {s}")
    tiles_x = settings.tiles_x
    ty_local = settings.tiles_y // s
    band_tiles = tiles_x * ty_local
    num_tiles = tiles_x * settings.tiles_y
    ch = 3 if colors_l is None else colors_l.shape[-1]
    if route_cap is None:
        route_cap = default_route_cap(n, s, tile_cap)
    route_cap = _round_up(route_cap, C_CHUNK)
    max_chunks = max(1, (k_max + C_CHUNK - 1) // C_CHUNK)
    dev = means_l.device

    prep = preprocess(means_l, opac_l, settings, scales=scales_l, quaternions=quats_l,
                      colors=colors_l, shs=shs_l, alive_mask=alive_l, ndc_offset=ndc_l)

    # (2) packed rows of every shard, mean y already in this band's pixel
    # rows (a shift of the packed row rather than of the slot data).
    packed_l = pack_params(prep.mean2d, prep.conic, prep.opacity, prep.color)
    packed = pad_rows(comm.all_gather(packed_l, axis, dim=1, backward="partitioned"))
    row_shift = torch.zeros((packed.shape[0], 1), dtype=packed.dtype, device=dev)
    row_shift[R_MY] = float(sidx * ty_local * rc.TILE_Y)
    packed = packed - row_shift

    with torch.no_grad():
        # (3) local expansion, float depth as payload; local -> global ids.
        big_cap_l = default_big_cap(n_loc) if big_cap is None else big_cap
        tile_e, depth_e, gid_l, _cc, _nr, big_ovf = expand_support_culled(
            prep, num_tiles, tiles_x, tile_cap, cap_a, big_cap_l, prep.depth.detach())
        gid_e = torch.where(gid_l < n_loc, sidx * n_loc + gid_l, n).to(torch.int32)
        tile_cap_overflow = (
            torch.clamp(prep.tiles_touched - tile_cap, min=0).sum(dtype=torch.int64) + big_ovf)

        # Group by destination band (bands are contiguous tile-id ranges).
        order = torch.sort(tile_e).indices
        tile_s, depth_s, gid_s = tile_e[order], depth_e[order], gid_e[order]
        d_loc = tile_s.shape[0]
        bstart = torch.searchsorted(
            tile_s, torch.arange(s + 1, dtype=torch.int32, device=dev) * band_tiles,
            side="left")

        # (4) fixed-capacity routing blocks: block b = slots bound for band b.
        src = bstart[:-1, None] + torch.arange(route_cap, device=dev)[None, :]
        ok = src < bstart[1:, None]
        src_c = torch.clamp(src, max=d_loc - 1)
        tile_r = torch.where(ok, tile_s[src_c], num_tiles).to(torch.int32)
        depth_r = torch.where(ok, depth_s[src_c], torch.inf)
        gid_r = torch.where(ok, gid_s[src_c], n).to(torch.int32)
        route_overflow = torch.clamp(bstart[1:] - bstart[:-1] - route_cap, min=0).sum()

        tile_a = comm.all_to_all(tile_r.reshape(-1), axis)
        depth_a = comm.all_to_all(depth_r.reshape(-1), axis)
        gid_a = comm.all_to_all(gid_r.reshape(-1), axis)

        # (5) merge: (tile, float depth, gid).
        m = _merge_order(tile_a, depth_a, gid_a)
        tile_m, gid_m = tile_a[m], gid_a[m]
        d_band = tile_m.shape[0]
        bounds = torch.searchsorted(
            tile_m,
            sidx * band_tiles + torch.arange(band_tiles + 1, dtype=torch.int32, device=dev),
            side="left").to(torch.int32)
        tile_start = bounds[:band_tiles].contiguous()
        tile_count_raw = bounds[1:] - bounds[:band_tiles]
        tile_count = torch.clamp(tile_count_raw, max=max_chunks * C_CHUNK).contiguous()
        kmax_overflow = torch.clamp(
            tile_count_raw.to(torch.int64) - max_chunks * C_CHUNK, min=0).sum()
        d_pad = _round_up(d_band, C_CHUNK) + C_CHUNK
        gid_pad = torch.cat([gid_m, torch.full((d_pad - d_band,), n, dtype=torch.int32,
                                               device=dev)])

    # (6) the band's slot data (K3 in the backward) and its composite.
    dup = gather_dup_searchsorted(packed, gid_pad, n, 6 + ch)
    img_t, final_t, n_contrib = tile_composite(
        tile_start, tile_count, dup, settings.bg, tiles_x, ch, max_chunks)

    def assemble(x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        x = x.reshape(ty_local, tiles_x, rc.TILE_Y, rc.TILE_X, c).permute(0, 2, 1, 3, 4)
        return x.reshape(ty_local * rc.TILE_Y, tiles_x * rc.TILE_X, c)[:, :settings.image_width]

    counts = comm.all_reduce(torch.stack([route_overflow.to(torch.int64), tile_cap_overflow,
                                          kmax_overflow]), axis)
    return dict(
        image=assemble(img_t),
        final_T=assemble(final_t[..., None])[..., 0],
        n_contrib=assemble(n_contrib[..., None])[..., 0],
        radii=prep.radius,
        route_overflow=counts[0],
        tile_overflow=counts[1],
        kmax_overflow=counts[2],
    )


def shard_of(x: torch.Tensor | None, axis: Axis) -> torch.Tensor | None:
    """This rank's rows of ``x`` (``mesh.rows``), or None."""
    return None if x is None else rows(x, axis)


def render_sharded(
    axis: Axis,
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    settings: rc.RasterSettings,
    scales: torch.Tensor | None = None,
    quaternions: torch.Tensor | None = None,
    colors: torch.Tensor | None = None,
    shs: torch.Tensor | None = None,
    alive_mask: torch.Tensor | None = None,
    ndc_offset: torch.Tensor | None = None,
    tile_cap: int = 16,
    route_cap: int | None = None,
    k_max: int = 8192,
    cap_a: int = 4,
    big_cap: int | None = None,
) -> dict:
    """The JAX function's signature on every rank: whole (N, ...) arrays
    in (each rank renders from its own rows), this rank's band out (see
    :func:`render_band`; :func:`gather_band` assembles the image).
    ``route_cap`` defaults to ``default_route_cap``."""
    n = means3d.shape[0]
    check_shapes(axis, settings, n)
    return render_band(
        axis, n, *(shard_of(x, axis) for x in (means3d, opacities)), settings,
        *(shard_of(x, axis) for x in (scales, quaternions, colors, shs, alive_mask, ndc_offset)),
        tile_cap=tile_cap, route_cap=route_cap, k_max=k_max, cap_a=cap_a, big_cap=big_cap,
    )


def gather_band(x: torch.Tensor, axis: Axis, settings: rc.RasterSettings) -> torch.Tensor:
    """The whole (H, W, ...) image from every rank's band. Every rank gets
    it, and its backward hands each rank its own band's cotangent (the
    ranks compute one loss on the same image: ``"replicated"``)."""
    return comm.all_gather(x, axis, dim=0, backward="replicated")[: settings.image_height]
