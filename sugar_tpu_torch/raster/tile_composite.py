"""Per-tile alpha compositing: the CUDA kernels, their plain versions, dispatch.

Port of ``sugar_tpu/raster/pallas_composite.py`` (``tile_composite`` and
its custom VJP over the Pallas kernels ``_fwd_kernel`` and
``_bwd_kernel``). On CUDA tensors ``tile_composite`` launches the
hand-written Hopper kernels ``csrc/tile_composite.cu`` (forward, K1) and
``csrc/tile_composite_bwd.cu`` (backward, K2); on CPU tensors it runs
``tile_composite_plain`` and ``tile_composite_bwd_plain``. For a CUDA
tensor there is no fallback: the kernel is built and launched, or the call
raises.

The kernels are instantiated for 1..MAX_CH colour channels. A wider input
(the Pallas kernels take any channel count) is composited in channel
groups of at most MAX_CH, one launch per group (``channel_groups``): the
compositing weights do not depend on the colour rows, so each group's
image channels are the numbers one wide launch would give, and its
final_T, n_contrib, entry_p and nch are the same in every group. The
backward is linear in the image and final_T cotangents and gates only on
forward values, so each group gets its own channels' cotangent (the
final_T cotangent goes to the first group alone), the groups' mean2d,
conic and opacity rows are summed and their colour rows placed side by
side.

Both kernels and both plain versions split the work the same way: the
unit is a (tile, chunk) pair, listed tile-major by ``work_items``. A
chunk's include decisions depend on earlier chunks only through the
pixel's entry product, and its gradient on later chunks only through
their per-pixel totals, so pairs are computed apart and combined per tile
in chunk order (see the kernel sources).

Both versions return the same five arrays with the TPU kernel's meanings
(see the kernel source): the image without background, final_T,
n_contrib (a count of included slots), the per-chunk entry products and
the processed-chunk count. The background term bg * final_T is added
outside the kernel, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sugar_tpu_torch import native
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.dup_gather import round8
from sugar_tpu_torch.utils import profiling

C_CHUNK = 256  # dup slots per chunk
P_TILE = rc.TILE_X * rc.TILE_Y  # pixels per tile
MAX_CH = 4  # colour channels per kernel launch; wider inputs go in groups
# Pairs per step of the plain versions: one (128, 256, 256) float32
# intermediate is 32 MiB, so a full-width frame stays well under 1 GiB.
_TILE_BATCH = 128

# Packed row indices.
R_MX, R_MY = 0, 1
R_CA, R_CB, R_CC = 2, 3, 4
R_OP = 5
R_COL = 6  # 6 .. 6+CH


class CompositeOut(NamedTuple):
    img: torch.Tensor  # (T, P, CH) float32, background not added
    final_t: torch.Tensor  # (T, P) float32
    n_contrib: torch.Tensor  # (T, P) int32
    entry_p: torch.Tensor  # (T, round8(max_chunks + 1), P) float32
    nch: torch.Tensor  # (T,) int32


def _tile_ranges(tile_start, tile_count, max_chunks):
    """(start, end, first chunk, chunk count) per tile, int64. Counts are
    clipped to max_chunks * C_CHUNK; a range from an unaligned start can
    span one chunk more than its count needs."""
    start = tile_start.to(torch.int64)
    count = torch.clamp(tile_count.to(torch.int64), max=max_chunks * C_CHUNK)
    end = start + count
    c0 = torch.div(start, C_CHUNK, rounding_mode="floor")
    ceil_end = torch.div(end + C_CHUNK - 1, C_CHUNK, rounding_mode="floor")
    n_chunks = torch.where(count > 0, ceil_end - c0, 0)
    return start, end, c0, n_chunks


def pair_capacity(num_tiles: int, d_pad: int, max_chunks: int) -> int:
    """Pairs the kernels' work lists and scratch are sized for, from
    shapes alone (no device read). Tile ranges that are disjoint and lie
    inside [0, d_pad), as binning lays them out, cover at most cdiv(d_pad,
    256) chunks, and each tile shares at most one chunk with the ranges
    before it: so sum(n_chunks) <= cdiv(d_pad, 256) + T. No tile walks
    more than max_chunks + 1 chunks."""
    by_slots = -(-d_pad // C_CHUNK) + num_tiles
    return max(1, min(num_tiles * (max_chunks + 1), by_slots))


def work_items(n: torch.Tensor):
    """The kernels' work list (``build_items`` in composite_common.cuh)
    for per-tile pair counts ``n`` (T,): ``first`` (T+1,) int64, tile t's
    pairs being first[t] .. first[t+1]-1 (its chunks 0, 1, ... in order),
    and ``item_tile`` (first[T],) int64. (The kernels also clip the
    offsets to their capacity, which ``pair_capacity`` sizes so that
    binned ranges always fit.)"""
    n = n.to(torch.int64)
    first = torch.zeros(n.shape[0] + 1, dtype=torch.int64, device=n.device)
    first[1:] = torch.cumsum(n, 0)
    tiles = torch.arange(n.shape[0], device=n.device)
    return first, torch.repeat_interleave(tiles, n)


def _chunk_alpha(data, px, py, slots, start, end):
    """(gated alpha, exp(gated power), dx, dy), each (L, P, C), of one
    chunk per pair (``_chunk_alpha`` of the Pallas kernel). data (6+CH, L,
    C); px, py (L, P); slots (L, C) global slot indices; start, end (L,)."""
    dx = data[R_MX][:, None, :] - px[:, :, None]
    dy = data[R_MY][:, None, :] - py[:, :, None]
    a = data[R_CA][:, None, :]
    b = data[R_CB][:, None, :]
    cc = data[R_CC][:, None, :]
    power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
    # where(), not min(): a NaN power on a gated slot must not reach exp.
    e = torch.exp(torch.where(power <= 0.0, power, 0.0))
    raw = data[R_OP][:, None, :] * e
    alpha = torch.clamp(raw, max=rc.ALPHA_CLAMP)
    in_range = (slots >= start[:, None]) & (slots < end[:, None])
    keep = (power <= 0.0) & (alpha >= rc.ALPHA_CUTOFF) & in_range[:, None, :]
    return torch.where(keep, alpha, 0.0), e, dx, dy


def _chunk_data(data_rows, tiles, chunks, c0, tiles_x):
    """Chunk ``chunks`` (L,) of each tile in ``tiles`` (L,): global slot
    indices (L, C), the packed rows (R, L, C) (zero past the array's end)
    and the pixel coordinates px, py (L, P) as float32."""
    dev = data_rows.device
    d_pad = data_rows.shape[1]
    slots = ((c0[tiles] + chunks) * C_CHUNK)[:, None] + torch.arange(C_CHUNK, device=dev)
    data = data_rows[:, torch.clamp(slots, max=d_pad - 1)]
    data = torch.where(slots < d_pad, data, 0.0)
    pix = torch.arange(P_TILE, device=dev)
    px = ((tiles % tiles_x) * rc.TILE_X)[:, None] + pix % rc.TILE_X
    py = (torch.div(tiles, tiles_x, rounding_mode="floor") * rc.TILE_Y)[:, None] + pix // rc.TILE_X
    return slots, data, px.to(torch.float32), py.to(torch.float32)


def _pair_batches(first, item_tile):
    """(pair indices, tiles, chunks) of the listed pairs, _TILE_BATCH at a
    time."""
    num = item_tile.numel()
    for b0 in range(0, num, _TILE_BATCH):
        it = torch.arange(b0, min(num, b0 + _TILE_BATCH), device=item_tile.device)
        tiles = item_tile[it]
        yield it, tiles, it - first[tiles]


def _chunk_products(data, px, py, slots, start, end):
    """alpha (L, P, C), the inclusive local products U (L, P, C) and the
    exclusive ones (U before each slot)."""
    alpha, e, dx, dy = _chunk_alpha(data, px, py, slots, start, end)
    uprod = torch.cumprod(1.0 - alpha, dim=2)
    excl = torch.cat([torch.ones_like(uprod[:, :, :1]), uprod[:, :, :-1]], dim=2)
    return alpha, uprod, excl, (e, dx, dy)


def tile_composite_plain(
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    dup_data: torch.Tensor,
    tiles_x: int,
    ch: int,
    max_chunks: int,
) -> CompositeOut:
    """The compositing kernel's plain PyTorch version, on any device.

    Follows the kernel's split (csrc/tile_composite.cu), vectorized over
    pairs ``_TILE_BATCH`` at a time: (a) per pair, the local products U
    (a ``cumprod`` of 1 - alpha), the unscaled color sum L = sum alpha_j
    U_{j-1} c_j and the count of alpha > 0; (b) per tile in chunk order,
    the entry products, the exit rule and the fully included chunks (entry
    * U_last >= T_EPS) added as entry * L; (c) the one chunk per pixel in
    which its product crosses T_EPS, composited with the Pallas kernel's
    include prefix (entry * U_j >= T_EPS) and gated minimum.
    """
    dev = dup_data.device
    num_tiles = tile_start.shape[0]
    data_rows = dup_data[: R_COL + ch]
    start, end, c0, n_chunks = _tile_ranges(tile_start, tile_count, max_chunks)
    first, item_tile = work_items(n_chunks)

    # (a) Each listed pair alone.
    n_pairs = item_tile.numel()
    u_last = torch.empty((n_pairs, P_TILE), dtype=torch.float32, device=dev)
    lsum = torch.empty((n_pairs, P_TILE, ch), dtype=torch.float32, device=dev)
    cnt = torch.empty((n_pairs, P_TILE), dtype=torch.int32, device=dev)
    for it, tiles, chunks in _pair_batches(first, item_tile):
        slots, data, px, py = _chunk_data(data_rows, tiles, chunks, c0, tiles_x)
        alpha, uprod, excl, _ = _chunk_products(data, px, py, slots, start[tiles], end[tiles])
        u_last[it] = uprod[:, :, -1]
        lsum[it] = torch.bmm(alpha * excl, data[R_COL : R_COL + ch].permute(1, 2, 0))
        cnt[it] = (alpha > 0).sum(dim=2, dtype=torch.int32)

    # (b) The entry scan, tile by tile in chunk order.
    img = torch.zeros((num_tiles, P_TILE, ch), dtype=torch.float32, device=dev)
    final_t = torch.ones((num_tiles, P_TILE), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((num_tiles, P_TILE), dtype=torch.int32, device=dev)
    entry_p = torch.zeros(
        (num_tiles, round8(max_chunks + 1), P_TILE), dtype=torch.float32, device=dev
    )
    nch = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
    cross = torch.full((num_tiles, P_TILE), -1, dtype=torch.int64, device=dev)
    p_carry = torch.ones((num_tiles, P_TILE), dtype=torch.float32, device=dev)
    max_n = int(n_chunks.max()) if num_tiles else 0
    for c in range(max_n):
        # A tile leaves the walk for good at its first chunk entry where no
        # pixel's running product is >= T_EPS (products never grow).
        live = (n_chunks > c) & (nch == c) & (p_carry.amax(dim=1) >= rc.T_EPS)
        idx = torch.nonzero(live).flatten()
        if idx.numel() == 0:
            break
        i = first[idx] + c
        pc = p_carry[idx]
        entry_p[idx, c] = pc
        pn = pc * u_last[i]
        full = pn >= rc.T_EPS  # every slot of the chunk is included
        img[idx] += torch.where(full[:, :, None], pc[:, :, None] * lsum[i], 0.0)
        final_t[idx] = torch.where(full, final_t[idx] * u_last[i], final_t[idx])
        n_contrib[idx] += torch.where(full, cnt[i], 0)
        cross[idx] = torch.where(~full & (pc >= rc.T_EPS), c, cross[idx])
        p_carry[idx] = pn
        nch[idx] += 1

    # (c) The crossing chunks: the included prefix of each.
    crossed = torch.nonzero(cross >= 0)[:, 0]
    pairs = torch.unique(crossed * (max_n + 1) + cross[cross >= 0])
    for b0 in range(0, pairs.numel(), _TILE_BATCH):
        pb = pairs[b0 : b0 + _TILE_BATCH]
        tiles = torch.div(pb, max_n + 1, rounding_mode="floor")
        chunks = pb % (max_n + 1)
        slots, data, px, py = _chunk_data(data_rows, tiles, chunks, c0, tiles_x)
        alpha, uprod, excl, _ = _chunk_products(data, px, py, slots, start[tiles], end[tiles])
        base = entry_p[tiles, chunks][:, :, None]
        include = base * uprod >= rc.T_EPS  # a prefix per pixel
        a_eff = torch.where(include, alpha, 0.0)
        w = a_eff * (base * excl)  # weight = alpha * T before the slot
        part = torch.bmm(w, data[R_COL : R_COL + ch].permute(1, 2, 0))
        # Gated chunk product = U at the last included slot = the min over
        # the included prefix (U is nonincreasing).
        t_chunk = torch.where(include, uprod, 1.0).amin(dim=2)
        # Each pixel crosses in one chunk: the (tile, pixel) targets differ.
        k, pix = torch.nonzero(cross[tiles] == chunks[:, None], as_tuple=True)
        t = tiles[k]
        img[t, pix] += part[k, pix]
        final_t[t, pix] *= t_chunk[k, pix]
        n_contrib[t, pix] += (a_eff[k, pix] > 0).sum(dim=1, dtype=torch.int32)
    return CompositeOut(img, final_t, n_contrib, entry_p, nch)


def tile_composite_bwd_plain(
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    nch: torch.Tensor,
    dup_data: torch.Tensor,
    g_img: torch.Tensor,
    gt_total: torch.Tensor,
    t_fin: torch.Tensor,
    entry_p: torch.Tensor,
    tiles_x: int,
    ch: int,
    max_chunks: int,
) -> torch.Tensor:
    """The compositing backward's plain PyTorch version, on any device:
    d_packed (ROWS, D_pad), the gradient of each dup slot's packed rows.

    Follows the kernel's split (csrc/tile_composite_bwd.cu) over the pairs
    (tile, chunk < nch): (a) each pair's per-pixel total of w (c . g),
    with the include prefix and t_in from the chunk's ``entry_p`` row;
    (b) each pair's carry T_fin * gt_total + sum of the later chunks'
    totals, added in reverse chunk order; (c) the Pallas backward's
    gradients (``pallas_composite.py:307-399``): the suffix ``total -
    inclusive cumsum`` plus the carry, dL/dalpha = t_in (c . g) - suffix /
    max(1 - alpha, 0.01) on included slots. Gated terms are
    where()-selected, so NaN on a dropped slot gives 0. Slots outside
    every processed tile range stay 0.
    """
    dev = dup_data.device
    d_pad = dup_data.shape[1]
    data_rows = dup_data[: R_COL + ch]
    start, end, c0, _ = _tile_ranges(tile_start, tile_count, max_chunks)
    first, item_tile = work_items(nch)
    n_pairs = item_tile.numel()

    def chunk_terms(tiles, chunks):
        slots, data, px, py = _chunk_data(data_rows, tiles, chunks, c0, tiles_x)
        alpha, uprod, excl, ex = _chunk_products(data, px, py, slots, start[tiles], end[tiles])
        base = entry_p[tiles, chunks][:, :, None]  # (L, P, 1)
        a_eff = torch.where(base * uprod >= rc.T_EPS, alpha, 0.0)
        t_in = base * excl
        g = g_img[tiles]  # (L, P, CH)
        cdotg = torch.bmm(g, data[R_COL : R_COL + ch].permute(1, 0, 2))  # (L, P, C)
        return slots, data, a_eff, t_in, g, cdotg, ex

    # (a) Per-pair totals.
    tot = torch.empty((n_pairs, P_TILE), dtype=torch.float32, device=dev)
    for it, tiles, chunks in _pair_batches(first, item_tile):
        _, _, a_eff, t_in, _, cdotg, _ = chunk_terms(tiles, chunks)
        tot[it] = (a_eff * t_in * cdotg).sum(dim=2)

    # (b) Carries, from the last processed chunk back.
    carry = torch.empty_like(tot)
    run = t_fin * gt_total  # (T, P)
    nch = nch.to(torch.int64)
    for c in range(int(nch.max()) - 1 if nch.numel() else -1, -1, -1):
        idx = torch.nonzero(nch > c).flatten()
        i = first[idx] + c
        carry[i] = run[idx]
        run[idx] += tot[i]

    # (c) Gradients, pair by pair; each slot has one owning pair.
    d_packed = torch.zeros_like(dup_data)
    d_live = d_packed[: R_COL + ch]
    for it, tiles, chunks in _pair_batches(first, item_tile):
        slots, data, a_eff, t_in, g, cdotg, (e, dx, dy) = chunk_terms(tiles, chunks)
        w = a_eff * t_in
        wc = w * cdotg
        suffix = (tot[it][:, :, None] - torch.cumsum(wc, dim=2)) + carry[it][:, :, None]
        act = a_eff > 0.0
        one_m_a = torch.clamp(1.0 - a_eff, min=1.0 - rc.ALPHA_CLAMP)
        dalpha = torch.where(act, t_in * cdotg - suffix / one_m_a, 0.0)
        dpower = dalpha * data[R_OP][:, None, :] * e
        ca, cb, cc = (data[r][:, None, :] for r in (R_CA, R_CB, R_CC))
        terms = [
            dpower * -(ca * dx + cb * dy),
            dpower * -(cc * dy + cb * dx),
            dpower * (-0.5 * dx * dx),
            dpower * -(dx * dy),
            dpower * (-0.5 * dy * dy),
            dalpha * e,
        ]
        rows = [torch.where(act, x, 0.0).sum(dim=1) for x in terms]  # (L, C) each
        d_col = torch.bmm(g.transpose(1, 2), w)  # (L, CH, C)
        contrib = torch.cat([torch.stack(rows), d_col.permute(1, 0, 2)], dim=0)
        owned = (slots >= start[tiles][:, None]) & (slots < end[tiles][:, None]) & (slots < d_pad)
        contrib = torch.where(owned, contrib, 0.0)
        d_live.index_add_(
            1, torch.clamp(slots, max=d_pad - 1).reshape(-1), contrib.reshape(R_COL + ch, -1)
        )
    return d_packed


def fwd_scratch(num_tiles: int, capacity: int, ch: int, device) -> dict[str, torch.Tensor]:
    """The forward kernels' scratch, by name in the C interface's order:
    the work list (``first`` (T+1,), ``item_tile`` (capacity,)), each
    pixel's crossing chunk (T*256,), and per pair the count plane
    (capacity*256,) int32 and the CH color planes plus the U plane
    (capacity*(CH+1)*256,) float32. The wrapper drops them when it returns,
    before the kernels have run: PyTorch's caching allocator hands their
    blocks only to later work on the same stream, which runs after them."""
    def empty(n, dtype=torch.int32):
        return torch.empty((n,), dtype=dtype, device=device)

    return dict(first=empty(num_tiles + 1), item_tile=empty(capacity),
                cross=empty(num_tiles * P_TILE), npart=empty(capacity * P_TILE),
                part=empty(capacity * (ch + 1) * P_TILE, torch.float32))


def bwd_scratch(num_tiles: int, capacity: int, device) -> dict[str, torch.Tensor]:
    """The backward kernels' scratch, in the C interface's order: the work
    list (``first``, ``item_tile``) and each pair's totals (capacity*256,)
    float32."""
    return dict(first=torch.empty((num_tiles + 1,), dtype=torch.int32, device=device),
                item_tile=torch.empty((capacity,), dtype=torch.int32, device=device),
                tot=torch.empty((capacity * P_TILE,), dtype=torch.float32, device=device))


def _kernel_lib():
    lib = native.load("tile_composite")
    fn = lib.sugar_tile_composite_fwd
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [
            vp, vp, vp, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ]
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(tile_start, tile_count, dup_data, tiles_x, ch, max_chunks):
    if not dup_data.is_cuda:
        raise ValueError("tile_composite_cuda needs CUDA tensors")
    for name, x in (("tile_start", tile_start), ("tile_count", tile_count)):
        if x.device != dup_data.device:
            raise ValueError(f"{name} is on {x.device}, dup_data on {dup_data.device}")
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    if tile_count.shape != tile_start.shape:
        raise ValueError("tile_start and tile_count differ in shape")
    if dup_data.dtype != torch.float32 or dup_data.dim() != 2 or not dup_data.is_contiguous():
        raise ValueError("dup_data must be a contiguous 2-D float32 tensor")
    if ch < 1:
        raise ValueError(f"the kernel takes 1 or more color channels, got {ch}")
    if dup_data.shape[0] < R_COL + ch:
        raise ValueError(f"dup_data has {dup_data.shape[0]} rows, needs {R_COL + ch}")
    if tiles_x < 1 or tile_start.shape[0] % tiles_x:
        raise ValueError(f"{tile_start.shape[0]} tiles do not form rows of {tiles_x}")
    if max_chunks < 1:
        raise ValueError("max_chunks must be >= 1")


def channel_groups(ch: int) -> list[tuple[int, int]]:
    """The colour channels [c0, c1) of each kernel launch for ``ch``
    channels: MAX_CH at a time, the last group the remainder."""
    return [(c0, min(ch, c0 + MAX_CH)) for c0 in range(0, ch, MAX_CH)]


def group_rows(dup_data: torch.Tensor, c0: int, c1: int) -> torch.Tensor:
    """One channel group's kernel input: rows 0:6 and colour rows c0:c1 of
    the packed ``dup_data``, as a contiguous (6 + c1 - c0, D_pad) copy."""
    return torch.cat([dup_data[:R_COL], dup_data[R_COL + c0 : R_COL + c1]])


def composite_groups(tile_start, tile_count, dup_data, tiles_x, ch, max_chunks) -> CompositeOut:
    """K1 over ``ch`` channels through ``_launch_fwd``: one launch of the
    whole input when ch <= MAX_CH, else one per channel group, whose
    images are concatenated; final_T, n_contrib, entry_p and nch are the
    first group's (every group computes the same ones)."""
    groups = channel_groups(ch)
    if len(groups) == 1:
        return _launch_fwd(tile_start, tile_count, dup_data, tiles_x, ch, max_chunks)
    first, imgs = None, []
    for c0, c1 in groups:
        out = _launch_fwd(tile_start, tile_count, group_rows(dup_data, c0, c1), tiles_x, c1 - c0,
                          max_chunks)
        first = out if first is None else first
        imgs.append(out.img)
    return first._replace(img=torch.cat(imgs, dim=2))


def composite_bwd_groups(tile_start, tile_count, nch, dup_data, g_img, gt_total, t_fin, entry_p,
                         tiles_x, ch, max_chunks) -> torch.Tensor:
    """K2 over ``ch`` channels through ``_launch_bwd``: one launch when ch
    <= MAX_CH, else one per channel group with that group's image
    cotangent and the final_T cotangent in the first group only; the
    groups' rows 0:6 are summed, each group's colour rows placed at its
    channels. Each group writes an output of its own: K2 overwrites the
    rows of every slot a tile owns."""
    groups = channel_groups(ch)
    if len(groups) == 1:
        return _launch_bwd(tile_start, tile_count, nch, dup_data, g_img, gt_total, t_fin,
                           entry_p, tiles_x, ch, max_chunks)
    d_packed = torch.zeros_like(dup_data)
    no_gt = torch.zeros_like(gt_total)
    for i, (c0, c1) in enumerate(groups):
        d = _launch_bwd(tile_start, tile_count, nch, group_rows(dup_data, c0, c1),
                        g_img[:, :, c0:c1].contiguous(), gt_total if i == 0 else no_gt, t_fin,
                        entry_p, tiles_x, c1 - c0, max_chunks)
        d_packed[:R_COL] += d[:R_COL]
        d_packed[R_COL + c0 : R_COL + c1] = d[R_COL:]
    return d_packed


def _launch_fwd(tile_start, tile_count, dup_data, tiles_x, ch, max_chunks) -> CompositeOut:
    """One launch of csrc/tile_composite.cu (its four sub-kernels) on
    checked inputs with ch <= MAX_CH; counts it."""
    fn = _kernel_lib()
    dev = dup_data.device
    num_tiles = tile_start.shape[0]
    rec = round8(max_chunks + 1)
    cap = pair_capacity(num_tiles, dup_data.shape[1], max_chunks)
    img = torch.empty((num_tiles, P_TILE, ch), dtype=torch.float32, device=dev)
    final_t = torch.empty((num_tiles, P_TILE), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((num_tiles, P_TILE), dtype=torch.int32, device=dev)
    entry_p = torch.empty((num_tiles, rec, P_TILE), dtype=torch.float32, device=dev)
    nch = torch.empty((num_tiles,), dtype=torch.int32, device=dev)
    scratch = fwd_scratch(num_tiles, cap, ch, dev)
    with torch.cuda.device(dev):
        err = fn(
            tile_start.data_ptr(), tile_count.data_ptr(), dup_data.data_ptr(),
            dup_data.shape[1], num_tiles, tiles_x, ch, max_chunks, rec, cap,
            img.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
            entry_p.data_ptr(), nch.data_ptr(), *(x.data_ptr() for x in scratch.values()),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"tile_composite kernel launch failed: CUDA error {err}")
    tile_composite_cuda.launches += 1
    return CompositeOut(img, final_t, n_contrib, entry_p, nch)


def tile_composite_cuda(
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    dup_data: torch.Tensor,
    tiles_x: int,
    ch: int,
    max_chunks: int,
) -> CompositeOut:
    """Launch the Hopper compositing kernels on the current stream, for any
    ``ch`` >= 1 (``composite_groups``: one launch up to MAX_CH channels,
    one per channel group above).

    Raises on inputs the kernel does not take and when a launch fails.
    ``tile_composite_cuda.launches`` counts successful launches, one per
    channel group (each launches the four sub-kernels of
    csrc/tile_composite.cu).
    """
    _check_inputs(tile_start, tile_count, dup_data, tiles_x, ch, max_chunks)
    return composite_groups(tile_start, tile_count, dup_data, tiles_x, ch, max_chunks)


tile_composite_cuda.launches = 0


def _bwd_fn():
    fn = native.load("tile_composite_bwd").sugar_tile_composite_bwd
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [
            vp, vp, vp, vp, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ]
        fn.restype = ctypes.c_int
    return fn


def tile_composite_bwd_cuda(
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    nch: torch.Tensor,
    dup_data: torch.Tensor,
    g_img: torch.Tensor,
    gt_total: torch.Tensor,
    t_fin: torch.Tensor,
    entry_p: torch.Tensor,
    tiles_x: int,
    ch: int,
    max_chunks: int,
) -> torch.Tensor:
    """Launch the Hopper compositing-backward kernels on the current
    stream, for any ``ch`` >= 1 (``composite_bwd_groups``); returns
    d_packed (ROWS, D_pad). Raises on inputs the kernel does not take and
    when a launch fails. ``tile_composite_bwd_cuda.launches`` counts
    successful launches, one per channel group (each launches the three
    sub-kernels of csrc/tile_composite_bwd.cu)."""
    _check_inputs(tile_start, tile_count, dup_data, tiles_x, ch, max_chunks)
    num_tiles = tile_start.shape[0]
    expect = {
        "nch": (nch, (num_tiles,), torch.int32),
        "g_img": (g_img, (num_tiles, P_TILE, ch), torch.float32),
        "gt_total": (gt_total, (num_tiles, P_TILE), torch.float32),
        "t_fin": (t_fin, (num_tiles, P_TILE), torch.float32),
    }
    for name, (x, shape, dtype) in expect.items():
        if x.device != dup_data.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape} on {dup_data.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rec = entry_p.shape[1] if entry_p.dim() == 3 else 0
    if (entry_p.device != dup_data.device or entry_p.dtype != torch.float32
            or tuple(entry_p.shape) != (num_tiles, rec, P_TILE) or rec < max_chunks + 1
            or not entry_p.is_contiguous()):
        raise ValueError("entry_p must be a contiguous float32 (T, >= max_chunks+1, 256) tensor")
    return composite_bwd_groups(tile_start, tile_count, nch, dup_data, g_img, gt_total, t_fin,
                                entry_p, tiles_x, ch, max_chunks)


def _launch_bwd(tile_start, tile_count, nch, dup_data, g_img, gt_total, t_fin, entry_p, tiles_x,
                ch, max_chunks) -> torch.Tensor:
    """One launch of csrc/tile_composite_bwd.cu (its three sub-kernels) on
    checked inputs with ch <= MAX_CH; counts it."""
    fn = _bwd_fn()
    dev = dup_data.device
    num_tiles = tile_start.shape[0]
    cap = pair_capacity(num_tiles, dup_data.shape[1], max_chunks)
    d_packed = torch.zeros_like(dup_data)
    scratch = bwd_scratch(num_tiles, cap, dev)
    with torch.cuda.device(dev):
        err = fn(
            tile_start.data_ptr(), tile_count.data_ptr(), nch.data_ptr(), dup_data.data_ptr(),
            dup_data.shape[1], num_tiles, tiles_x, ch, max_chunks, entry_p.shape[1], cap,
            g_img.data_ptr(), gt_total.data_ptr(), t_fin.data_ptr(), entry_p.data_ptr(),
            d_packed.data_ptr(), *(x.data_ptr() for x in scratch.values()),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"tile_composite_bwd kernel launch failed: CUDA error {err}")
    tile_composite_bwd_cuda.launches += 1
    return d_packed


tile_composite_bwd_cuda.launches = 0


class TileComposite(torch.autograd.Function):
    """The custom VJP of ``pallas_composite.tile_composite``: forward K1 (or
    its plain version), backward K2 (or its plain version), on the device
    of ``dup_data``. d_bg and the background's share of the final_T
    cotangent are sums outside the kernel, as in the JAX package."""

    @staticmethod
    @profiling.spanned("raster.k1")
    def forward(ctx, tile_start, tile_count, dup_data, bg, tiles_x, ch, max_chunks):
        if dup_data.is_cuda:
            out = tile_composite_cuda(tile_start, tile_count, dup_data, tiles_x, ch, max_chunks)
        elif dup_data.device.type == "cpu":
            out = tile_composite_plain(tile_start, tile_count, dup_data, tiles_x, ch, max_chunks)
        else:
            raise ValueError(f"no compositing path for device {dup_data.device}")
        image = out.img + out.final_t[:, :, None] * bg[None, None, :]
        ctx.save_for_backward(tile_start, tile_count, dup_data, bg, out.final_t, out.entry_p,
                              out.nch)
        ctx.shape = (tiles_x, ch, max_chunks)
        ctx.mark_non_differentiable(out.n_contrib)
        return image, out.final_t, out.n_contrib

    @staticmethod
    @profiling.spanned("raster.k2")
    def backward(ctx, g_img, g_t, _g_n):
        tile_start, tile_count, dup_data, bg, t_fin, entry_p, nch = ctx.saved_tensors
        tiles_x, ch, max_chunks = ctx.shape
        g_img = g_img.contiguous()  # unused outputs' grads arrive as zeros
        gt_total = (g_t + (g_img * bg).sum(dim=-1)).contiguous()
        d_bg = (t_fin[:, :, None] * g_img).sum(dim=(0, 1))
        args = (tile_start, tile_count, nch, dup_data, g_img, gt_total, t_fin, entry_p,
                tiles_x, ch, max_chunks)
        if dup_data.is_cuda:
            d_packed = tile_composite_bwd_cuda(*args)
        else:
            d_packed = tile_composite_bwd_plain(*args)
        return None, None, d_packed, d_bg, None, None, None


def tile_composite(
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    dup_data: torch.Tensor,
    bg: torch.Tensor,
    tiles_x: int,
    ch: int,
    max_chunks: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite every tile: returns (image (T, P, CH) with bg * final_T
    added, final_T (T, P), n_contrib (T, P)), differentiable in
    ``dup_data`` and ``bg``.

    ``tile_start``/``tile_count`` (T,) int32 are the unaligned ranges into
    the packed ``dup_data`` (ROWS, D_pad), disjoint and inside [0, D_pad)
    as binning lays them out; counts above max_chunks * 256 are clipped.
    CUDA tensors go through the kernels (K1 forward, K2 backward), CPU
    tensors through their plain versions.
    """
    return TileComposite.apply(tile_start, tile_count, dup_data, bg, tiles_x, ch, max_chunks)
