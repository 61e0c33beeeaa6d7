"""Fused binning and the production render path.

Port of ``sugar_tpu/raster/fused.py``: binning that carries only (depth
rank, gaussian id) per dup slot, then ONE column gather of the packed
render data into dup order (``dup_gather``), then per-tile compositing
(``tile_composite``).

``bin_fused`` takes one of two routes, by the device its input lies on:

- CPU tensors: the JAX package's bucketed static expansion, bit-equal
  with it. Bucket A: every Gaussian owns ``cap_a`` rect slots. Bucket B:
  the Gaussians whose rect exceeds ``cap_a`` tiles are compacted into
  ``big_cap`` extra rows of ``tile_cap - cap_a`` slots. Then one sort of
  the whole buffer by [tile | depth rank], truncated to the capacity.
  ``tile_cap``, ``cap_a`` and ``big_cap`` bound this route (and the
  tile-sharded path of ``parallel/render.py``, which expands per band with
  ``expand_support_culled``) and nothing else.
- CUDA tensors: the hand-written kernels of ``csrc/binning.cu``
  (``bin_fused_cuda``): every tile of every rect is tested, only the kept
  slots are written, and each tile's slots are ordered by depth rank. The
  capacity is the only capacity; no rect or bucket slot is dropped, and
  the host reads nothing from the card. Its plain version,
  ``bin_fused_plain``, is the CPU route at covering caps. The two routes
  agree whenever the CPU route drops no rect or bucket slot.

- Exact-support culling: a rect tile whose pixel box lies wholly outside
  the alpha >= 1/255 ellipse (continuous box minimum of the conic
  quadratic vs ln(opacity * 255)) is dropped; the compositing gate would
  zero all its samples, so images and gradients are unchanged.
- Order: slots sort by (tile, depth rank); equal depths keep Gaussian
  index order (the depth sort is stable), as in the CUDA rasterizer's
  [tileID | depth] radix sort.

The CPU route keeps every diagnostic counter of the JAX package; the card
route returns those of the one capacity it has. ``raster.adaptive`` grows
the capacities from them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sugar_tpu_torch import native
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.binning import depth_order, tile_ranges
from sugar_tpu_torch.raster.dup_gather import gather_dup, pack_params, pad_rows
from sugar_tpu_torch.raster.preprocess import Preprocessed
from sugar_tpu_torch.raster.tile_composite import C_CHUNK, tile_composite
from sugar_tpu_torch.utils import profiling

# Safety margin on the support test: the continuous box minimum is computed
# in f32; err on the side of KEEPING a boundary tile.
_Q_EPS = 1e-3


def _box_qmin(lx, hx, ly, hy, a, b, c):
    """Min over the box [lx,hx]x[ly,hy] of q = 0.5 a dx^2 + b dx dy + 0.5 c dy^2.

    q is positive definite for valid conics, so the minimum is 0 when the
    box holds the mean and otherwise lies on one of the four edges (each a
    1-D quadratic with a clamped vertex).
    """
    inside = (lx <= 0.0) & (hx >= 0.0) & (ly <= 0.0) & (hy >= 0.0)
    a_s = torch.clamp(a, min=1e-30)
    c_s = torch.clamp(c, min=1e-30)

    def edge_x(ex):
        dy = torch.minimum(torch.maximum(-b * ex / c_s, ly), hy)
        return 0.5 * a * ex * ex + b * ex * dy + 0.5 * c * dy * dy

    def edge_y(ey):
        dx = torch.minimum(torch.maximum(-b * ey / a_s, lx), hx)
        return 0.5 * c * ey * ey + b * ey * dx + 0.5 * a * dx * dx

    qmin = torch.minimum(
        torch.minimum(edge_x(lx), edge_x(hx)),
        torch.minimum(edge_y(ly), edge_y(hy)),
    )
    return torch.where(inside, 0.0, qmin)


def _slot_tiles(rmin_x, rmin_y, rect_w, j):
    """Row-major tile coordinates of slot j inside a Gaussian's rect.

    j // w is taken as floor(f32(j) / f32(w)) exactly as the JAX package
    takes it (exact for j < 2^24), so both pick the same tile."""
    ty_off = torch.floor(j.to(torch.float32) / rect_w.to(torch.float32)).to(torch.int32)
    tx_off = j - ty_off * rect_w
    return rmin_x + tx_off, rmin_y + ty_off


def _slot_valid(tx, ty, j, counts, mx, my, ca, cb, cc, qmax):
    """Validity of expansion slots: inside the (capped) rect AND the tile's
    pixel box meets the alpha >= cutoff support ellipse."""
    in_rect = j < counts
    x0 = (tx * rc.TILE_X).to(torch.float32)
    y0 = (ty * rc.TILE_Y).to(torch.float32)
    qmin = _box_qmin(
        x0 - mx,
        x0 + (rc.TILE_X - 1) - mx,
        y0 - my,
        y0 + (rc.TILE_Y - 1) - my,
        ca,
        cb,
        cc,
    )
    return in_rect & (qmin <= qmax + _Q_EPS)


def support_qmax(opacity: torch.Tensor) -> torch.Tensor:
    """ln(opacity / ALPHA_CUTOFF), opacity floored at 1e-30: the largest
    conic quadratic whose alpha reaches the cutoff. Both routes take it
    with these torch ops, so a boundary tile falls the same way."""
    return torch.log(torch.clamp(opacity, min=1e-30) / rc.ALPHA_CUTOFF)


def expand_support_culled(
    prep: Preprocessed,
    num_tiles: int,
    tiles_x: int,
    tile_cap: int,
    cap_a: int,
    big_cap: int,
    payload: torch.Tensor,  # (N,) float32 per-Gaussian sort payload
):
    """Bucketed, exact-support-culled dup expansion (see module docstring).

    Returns (tile_e, pay_e, gid_e (E,), counts_culled (N,), num_rendered (),
    big_overflow ()) with sentinel tile = num_tiles / gid = n on invalid
    slots. ``payload`` must be exactly representable in f32.
    """
    n = prep.tiles_touched.shape[0]
    # Integer fields round-trip through an f32 stack (bucket-B compaction)
    # and _slot_tiles divides in f32: both exact only below 2^24.
    if n >= 2**24:
        raise ValueError(f"fused binning supports < 2^24 Gaussians, got {n}")
    dev = prep.mean2d.device
    cap_a = min(cap_a, tile_cap)
    big_cap = min(big_cap, n)
    cap_b = tile_cap - cap_a

    mx, my = prep.mean2d[:, 0], prep.mean2d[:, 1]
    ca, cb, cc = prep.conic[:, 0], prep.conic[:, 1], prep.conic[:, 2]
    qmax = support_qmax(prep.opacity)
    counts = torch.clamp(prep.tiles_touched, max=tile_cap).to(torch.int32)
    rmin_x, rmin_y = prep.rect_min[:, 0], prep.rect_min[:, 1]
    rect_w = torch.clamp(prep.rect_max[:, 0] - rmin_x, min=1)
    iota = torch.arange(n, dtype=torch.int32, device=dev)

    # Exact-support validity over the FULL capped rect, original order:
    # per-Gaussian culled counts = the backward's exact segment sizes.
    j_full = torch.arange(tile_cap, dtype=torch.int32, device=dev)[:, None]
    txf, tyf = _slot_tiles(rmin_x[None, :], rmin_y[None, :], rect_w[None, :], j_full)
    valid_full = _slot_valid(
        txf, tyf, j_full, counts[None, :], mx[None, :], my[None, :],
        ca[None, :], cb[None, :], cc[None, :], qmax[None, :],
    )
    counts_culled = valid_full.sum(dim=0, dtype=torch.int32)
    num_rendered = counts_culled.sum(dtype=torch.int64)

    # Bucket A: every Gaussian owns cap_a slots (slot axis leading).
    sentinel_tile = torch.tensor(num_tiles, dtype=torch.int32, device=dev)
    sentinel_gid = torch.tensor(n, dtype=torch.int32, device=dev)
    tile_a = torch.where(valid_full[:cap_a], tyf[:cap_a] * tiles_x + txf[:cap_a], sentinel_tile)
    gid_a = torch.where(valid_full[:cap_a], iota[None, :], sentinel_gid)
    pay_a = payload[None, :].expand(cap_a, n)

    parts_tile = [tile_a.reshape(-1)]
    parts_pay = [pay_a.reshape(-1)]
    parts_gid = [gid_a.reshape(-1)]

    big_overflow = torch.zeros((), dtype=torch.int64, device=dev)
    if cap_b > 0 and big_cap > 0:
        # Bucket B: Gaussians with rect > cap_a tiles, compacted into
        # big_cap rows: a stable partition sort finds them (in index
        # order), then one narrow column gather pulls their rows.
        is_big = counts > cap_a
        bkey = torch.where(is_big, 0, 1).to(torch.int32)
        big_iota = torch.sort(bkey, stable=True).indices
        b_iota = big_iota[:big_cap]
        brows = torch.stack(
            [payload, counts.to(torch.float32),
             rmin_x.to(torch.float32), rmin_y.to(torch.float32),
             rect_w.to(torch.float32), mx, my, ca, cb, cc, qmax]
        )[:, b_iota]  # (11, big_cap)
        b_pay = brows[0]
        b_counts = brows[1].to(torch.int32)
        b_rx = brows[2].to(torch.int32)
        b_ry = brows[3].to(torch.int32)
        b_rw = brows[4].to(torch.int32)
        b_mx, b_my, b_ca, b_cb, b_cc, b_qmax = brows[5:11]
        # Rows beyond the real big count are small Gaussians (counts <=
        # cap_a): their j >= cap_a slots fail the in_rect test.
        j_b = cap_a + torch.arange(cap_b, dtype=torch.int32, device=dev)[:, None]
        txb, tyb = _slot_tiles(b_rx[None, :], b_ry[None, :], b_rw[None, :], j_b)
        valid_b = _slot_valid(
            txb, tyb, j_b, b_counts[None, :], b_mx[None, :], b_my[None, :],
            b_ca[None, :], b_cb[None, :], b_cc[None, :], b_qmax[None, :],
        )
        parts_tile.append(
            torch.where(valid_b, tyb * tiles_x + txb, sentinel_tile).reshape(-1)
        )
        parts_pay.append(b_pay[None, :].expand(cap_b, big_cap).reshape(-1))
        parts_gid.append(
            torch.where(valid_b, b_iota.to(torch.int32)[None, :], sentinel_gid).reshape(-1)
        )
        # Big Gaussians that did not fit in big_cap rows lose their j >=
        # cap_a slots (their A slots remain): count them.
        excess_all = torch.clamp(counts - cap_a, min=0).sum(dtype=torch.int64)
        excess_kept = torch.clamp(b_counts - cap_a, min=0).sum(dtype=torch.int64)
        big_overflow = excess_all - excess_kept

    return (
        torch.cat(parts_tile),
        torch.cat(parts_pay),
        torch.cat(parts_gid),
        counts_culled,
        num_rendered,
        big_overflow,
    )


def dup_pad(capacity: int) -> int:
    """D_pad: the chunk-aligned capacity plus one chunk, which keeps the
    last tile's chunk walk in bounds."""
    return ((capacity + C_CHUNK - 1) // C_CHUNK) * C_CHUNK + C_CHUNK


def depth_rank(prep: Preprocessed) -> tuple[torch.Tensor, torch.Tensor]:
    """(gsort, rank) (N,) int64: the stable sort of ALL n depths and each
    Gaussian's place in it."""
    gsort = depth_order(prep.depth)
    rank = torch.empty_like(gsort)
    rank[gsort] = torch.arange(gsort.shape[0], device=gsort.device)
    return gsort, rank


def bin_fused_torch(
    prep: Preprocessed,
    num_tiles: int,
    tiles_x: int,
    tile_cap: int,
    cap_a: int,
    big_cap: int,
    capacity: int,
) -> dict:
    """The CPU route of ``bin_fused``: the bucketed static expansion, then
    the [tile | depth rank] sort of the whole buffer, truncated to D_pad.

    While a profiler collects it counts the slots kept
    (``raster.slots_kept``, the device scalar ``num_rendered``) and the
    expansion's validity tests (``raster.slots_tested``: the full capped
    rect of every row, then bucket B's slots past ``cap_a``).
    """
    n = prep.tiles_touched.shape[0]
    dev = prep.mean2d.device
    cap_a = min(cap_a, tile_cap)
    big_cap = min(big_cap, n)

    _, rank = depth_rank(prep)
    tile_e, pay_e, gid_e, counts_culled, num_rendered, big_overflow = (
        expand_support_culled(
            prep, num_tiles, tiles_x, tile_cap, cap_a, big_cap,
            rank.to(torch.float32),
        )
    )
    profiling.count("raster.slots_kept", num_rendered)
    profiling.count("raster.slots_tested", tile_cap * n + (tile_cap - cap_a) * big_cap)
    rank_e = pay_e.to(torch.int64)

    # THE sort: [tile | depth-rank] as one int64 key. (tile, rank) pairs
    # are unique among valid slots, so the order is the JAX package's;
    # invalid slots (sentinel tile) all carry gid n.
    rank_bits = max(1, (n - 1).bit_length())
    key_e = (tile_e.to(torch.int64) << rank_bits) | rank_e
    sorted_key, order = torch.sort(key_e)
    sorted_tile = (sorted_key >> rank_bits).to(torch.int32)
    gid_s = gid_e[order]

    # Truncate to the chunk-aligned capacity (valid slots sort first).
    d_pad = dup_pad(capacity)
    e_total = tile_e.shape[0]
    if e_total < d_pad:
        pad = d_pad - e_total
        sorted_tile = torch.cat(
            [sorted_tile, torch.full((pad,), num_tiles, dtype=torch.int32, device=dev)]
        )
        gid_s = torch.cat([gid_s, torch.full((pad,), n, dtype=torch.int32, device=dev)])
    else:
        sorted_tile = sorted_tile[:d_pad]
        gid_s = gid_s[:d_pad]

    tile_start, tile_count = tile_ranges(sorted_tile, num_tiles)

    rect_overflow = torch.clamp(prep.tiles_touched - tile_cap, min=0).sum(dtype=torch.int64)
    cap_overflow = torch.clamp(num_rendered - capacity, min=0)
    return dict(
        gid=gid_s,
        tile_start=tile_start,
        tile_count=tile_count,
        counts_culled=counts_culled,
        num_rendered=num_rendered,
        overflow=rect_overflow + big_overflow + cap_overflow,
        inexact=big_overflow + cap_overflow,
        big_overflow=big_overflow,
        cap_overflow=cap_overflow,
        num_big=_num_big(prep, tile_cap, cap_a),
        max_tiles_touched=prep.tiles_touched.max(),
    )


@torch.no_grad()
def bin_fused_plain(prep: Preprocessed, num_tiles: int, tiles_x: int, capacity: int) -> dict:
    """The plain version of ``bin_fused_cuda``: ``bin_fused_torch`` at
    covering caps (tile_cap = cap_a = the largest rect, so bucket A holds
    every rect tile), with the card route's counters. It reads the largest
    rect to the host, and its expansion costs n x that many slots."""
    n = prep.tiles_touched.shape[0]
    cover = max(1, int(prep.tiles_touched.max())) if n else 1
    b = bin_fused_torch(prep, num_tiles, tiles_x, cover, cover, n, capacity)
    del b["num_big"], b["max_tiles_touched"]
    return b


def _num_big(prep: Preprocessed, tile_cap: int, cap_a: int) -> torch.Tensor:
    """The CPU route's Gaussians whose capped rect spills past bucket A."""
    return (torch.clamp(prep.tiles_touched, max=tile_cap) > min(cap_a, tile_cap)).sum(
        dtype=torch.int64)


def _kernel_fns():
    lib = native.load("binning")
    run, grid = lib.sugar_bin_fused, lib.sugar_bin_fused_grid
    if run.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        grid.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
        grid.restype = ctypes.c_int
        run.argtypes = [vp] * 8 + [i32] * 3 + [i64] * 2 + [i32] + [vp] * 11
        run.restype = ctypes.c_int
    return run, grid


@functools.lru_cache(maxsize=64)
def _visit_grid(device_index: int, num_tiles: int, n: int) -> int:
    """Blocks of the kernels' visit passes: as many as stay resident on
    the card (each holds a histogram row of ``num_tiles`` ints, in shared
    memory up to 24,576 tiles and in global memory past that, where at
    most four blocks an SM run), no more than n needs."""
    _, fn = _kernel_fns()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(num_tiles, n, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"binning grid query failed for {num_tiles} tiles: CUDA error {err}")
    return out.value


def _check_cuda_inputs(prep: Preprocessed, num_tiles: int, tiles_x: int) -> None:
    dev = prep.mean2d.device
    fields = dict(mean2d=(torch.float32, (2,)), conic=(torch.float32, (3,)),
                  opacity=(torch.float32, ()), depth=(torch.float32, ()),
                  rect_min=(torch.int32, (2,)), rect_max=(torch.int32, (2,)),
                  tiles_touched=(torch.int32, ()))
    n = prep.tiles_touched.shape[0]
    for name, (dtype, tail) in fields.items():
        x = getattr(prep, name)
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != (n, *tail):
            raise ValueError(f"prep.{name} must be {dtype} {(n, *tail)} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not 1 <= tiles_x <= num_tiles or num_tiles % tiles_x:
        raise ValueError(f"{num_tiles} tiles is not a grid {tiles_x} tiles wide")
    if n >= 2**31 - 1:
        raise ValueError(f"binning on the card supports < 2^31 - 1 Gaussians, got {n}")


@torch.no_grad()
def bin_fused_cuda(prep: Preprocessed, num_tiles: int, tiles_x: int, capacity: int) -> dict:
    """The CUDA route of ``bin_fused``: ``csrc/binning.cu`` on the current
    stream (count, scan, emit, per-tile order). Every rect tile is tested,
    so only the capacity bounds it: ``overflow`` = ``inexact`` =
    ``cap_overflow`` = the slots past it, ``big_overflow`` 0, all written
    by the kernels. Any frame size: past 24,576 tiles (a 4K frame has
    32,400) the count and emit passes keep their per-block tile histograms
    in global memory instead of shared memory. Reads nothing to the host.
    ``bin_fused_cuda.launches`` counts successful calls (six kernels each).

    While a profiler collects it counts the slots kept
    (``raster.slots_kept``) and the rect tiles tested
    (``raster.slots_tested``: the sum of ``tiles_touched``), both device
    scalars.
    """
    _check_cuda_inputs(prep, num_tiles, tiles_x)
    n = prep.tiles_touched.shape[0]
    dev = prep.mean2d.device
    d_pad = dup_pad(capacity)
    gsort, rank = depth_rank(prep)
    qmax = support_qmax(prep.opacity)
    ins = [prep.mean2d.contiguous(), prep.conic.contiguous(), qmax,
           prep.rect_min.contiguous(), prep.rect_max.contiguous(),
           prep.tiles_touched.contiguous(), rank, gsort]
    grid = _visit_grid(dev.index, num_tiles, n)
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    hist = torch.empty(grid * num_tiles, **i32)
    total = torch.empty(num_tiles, **i32)
    raw_start = torch.empty(num_tiles, **i64)
    deep = torch.empty(num_tiles + 1, **i32)
    stats = torch.empty(3, **i64)
    keys = torch.empty(2 * (d_pad + n), **i32)
    gid = torch.empty(d_pad, **i32)
    counts_culled = torch.empty(n, **i32)
    tile_start = torch.empty(num_tiles, **i32)
    tile_count = torch.empty(num_tiles, **i32)
    run, _ = _kernel_fns()
    with torch.cuda.device(dev):
        err = run(
            *(x.data_ptr() for x in ins), n, tiles_x, num_tiles, d_pad, capacity, grid,
            *(x.data_ptr() for x in (hist, total, raw_start, deep, stats, keys, gid,
                                     counts_culled, tile_start, tile_count)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"binning kernel launch failed: CUDA error {err}")
    bin_fused_cuda.launches += 1
    if profiling.collecting():
        profiling.count("raster.slots_kept", stats[0])
        profiling.count("raster.slots_tested", prep.tiles_touched.sum(dtype=torch.int64))
    return dict(
        gid=gid,
        tile_start=tile_start,
        tile_count=tile_count,
        counts_culled=counts_culled,
        num_rendered=stats[0],
        overflow=stats[1],
        inexact=stats[1],
        big_overflow=stats[2],
        cap_overflow=stats[1],
    )


bin_fused_cuda.launches = 0


@torch.no_grad()  # the stop_gradient(prep) of the JAX package's render_fused
@profiling.spanned("raster.binning")
def bin_fused(
    prep: Preprocessed,
    num_tiles: int,
    tiles_x: int,
    tile_cap: int,
    cap_a: int,
    big_cap: int,
    capacity: int,
) -> dict:
    """Support-culled binning. Carries no gradient (the support and order
    decisions are not differentiable, as CUDA's rect is not). CUDA tensors
    go through ``bin_fused_cuda`` (``tile_cap``, ``cap_a`` and ``big_cap``
    unused), CPU tensors through ``bin_fused_torch``.

    Returns dict(gid (D_pad,), tile_start (T,), tile_count (T,),
    counts_culled (N,), num_rendered (), overflow (), inexact (),
    big_overflow (), cap_overflow ()) where D_pad is the chunk-aligned
    capacity plus one chunk and ``gid`` holds the sentinel n on
    invalid/padding slots. ``inexact`` counts real dup slots dropped by
    big_cap/capacity truncation; ``overflow`` adds the rect slots past
    ``tile_cap``. The CPU route adds ``num_big`` and
    ``max_tiles_touched``, which size its rect and bucket caps.
    """
    if prep.mean2d.is_cuda:
        return bin_fused_cuda(prep, num_tiles, tiles_x, capacity)
    if prep.mean2d.device.type == "cpu":
        return bin_fused_torch(prep, num_tiles, tiles_x, tile_cap, cap_a, big_cap, capacity)
    raise ValueError(f"no binning path for device {prep.mean2d.device}")


def default_big_cap(n: int) -> int:
    """Bucket-B rows when the caller gives none: n below 65,536 Gaussians
    (lossless), max(n // 8, 65536) above."""
    return n if n < 65536 else max(n // 8, 65536)


def bin_and_gather(
    prep: Preprocessed,
    settings: rc.RasterSettings,
    tile_cap: int,
    capacity: int,
    cap_a: int = 4,
    big_cap: int | None = None,
) -> tuple[dict, torch.Tensor]:
    """Binning plus the dup gather: (bin_fused's dict, dup_data (ROWS,
    D_pad)), the compositing kernel's inputs. ``big_cap`` None means
    ``default_big_cap(n)``. dup_data carries the gradient to ``prep``
    (the gather's segment-sum backward; zeros when the capacity truncated
    real slots, ``inexact`` > 0).
    """
    n = prep.mean2d.shape[0]
    if big_cap is None:
        big_cap = default_big_cap(n)
    num_tiles = settings.tiles_x * settings.tiles_y
    b = bin_fused(prep, num_tiles, settings.tiles_x, tile_cap, cap_a, big_cap, capacity)
    live_rows = 6 + prep.color.shape[-1]
    with profiling.span("raster.gather"):
        packed = pad_rows(pack_params(prep.mean2d, prep.conic, prep.opacity, prep.color))
        return b, gather_dup(packed, b["gid"], n, b["inexact"] == 0, live_rows)


def assemble_tiles(x: torch.Tensor, settings: rc.RasterSettings) -> torch.Tensor:
    """(T, 256, C) tile-major -> (H, W, C) image."""
    tx_n, ty_n, c = settings.tiles_x, settings.tiles_y, x.shape[-1]
    x = x.reshape(ty_n, tx_n, rc.TILE_Y, rc.TILE_X, c)
    x = x.permute(0, 2, 1, 3, 4).reshape(ty_n * rc.TILE_Y, tx_n * rc.TILE_X, c)
    return x[: settings.image_height, : settings.image_width]


def composite_outputs(img_t, final_t, n_contrib, tile_count, max_chunks: int,
                      settings: rc.RasterSettings) -> dict:
    """``tile_composite``'s tile-major outputs as images, with the deepest
    tile's count and its excess over the composited max_chunks * 256
    slots (the k_max a re-render needs, and what this one dropped)."""
    max_tile_count = tile_count.max()
    return dict(
        image=assemble_tiles(img_t, settings),
        final_T=assemble_tiles(final_t[..., None], settings)[..., 0],
        n_contrib=assemble_tiles(n_contrib[..., None], settings)[..., 0],
        tile_overflow=torch.clamp(max_tile_count - max_chunks * C_CHUNK, min=0),
        max_tile_count=max_tile_count,
    )


def render_fused(
    prep: Preprocessed,
    settings: rc.RasterSettings,
    tile_cap: int,
    capacity: int,
    max_per_tile: int = 8192,
    cap_a: int = 4,
    big_cap: int | None = None,
) -> dict:
    """Production render: fused binning + dup gather + tile compositing.

    Overflow of ``tile_cap`` and ``big_cap`` (see ``bin_and_gather``),
    which bound the CPU route of ``bin_fused`` only, is reported in
    ``big_overflow`` and ``bin_overflow`` and handled by
    ``raster.adaptive`` like every other capacity; the counters are the
    ones ``bin_fused``'s route returned. Differentiable in
    ``prep``'s mean2d, conic, opacity and color (and ``settings.bg``);
    binning carries no gradient, as the JAX package's
    ``stop_gradient(prep)``.
    """
    ch = prep.color.shape[-1]
    max_chunks = max(1, (max_per_tile + C_CHUNK - 1) // C_CHUNK)

    b, dup_data = bin_and_gather(prep, settings, tile_cap, capacity, cap_a, big_cap)

    img_t, final_t, n_contrib = tile_composite(
        b["tile_start"], b["tile_count"], dup_data, settings.bg, settings.tiles_x, ch, max_chunks
    )

    counters = ("big_overflow", "num_big", "num_rendered", "cap_overflow", "max_tiles_touched")
    return dict(
        **composite_outputs(img_t, final_t, n_contrib, b["tile_count"], max_chunks, settings),
        bin_overflow=b["overflow"],
        **{k: b[k] for k in counters if k in b},
    )
