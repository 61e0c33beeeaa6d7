"""Triangle rasterizer (z-buffer, face ids), not differentiated.

Port of ``sugar_tpu/refine/mesh_raster.py``, which replaces PyTorch3D's
MeshRasterizer where the pipeline rasterizes triangles: UV texture baking
(per-pixel face id + barycentrics, sugar_model.py:2648-2675) and the
textured-mesh evaluation. The same static-capacity tile binning as the
Gaussian path (faces expanded into per-tile slots, a stable sort by tile),
then a z-buffer over each tile's first ``k_max`` faces, tiles in chunks of
``tile_chunk``. A tile's result does not depend on the chunking.

Plain torch ops on the vertices' device (the JAX function is plain XLA,
no Pallas kernel). Outputs per pixel: nearest face index (-1 = none),
perspective-correct barycentrics and view-space depth; plus the
duplication ``overflow`` and, beyond the JAX function's outputs, the
deepest tile's face count ``tile_count_max`` (faces past ``k_max`` in a
tile are dropped, and the JAX function counts nothing there).
"""

from __future__ import annotations

import torch

from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.binning import bucketize_by_offsets

_EDGE_EPS = 1e-5  # keeps shared edges watertight (strict tests drop crack pixels)


def _tile_bound(x: torch.Tensor, size: int, n: int, plus: int) -> torch.Tensor:
    """clip(floor(x / size) + plus, 0, n) as an index; clipped in float
    first, as XLA's saturating float->int32 cast then clip gives."""
    t = torch.nan_to_num(torch.floor(x / size) + plus, nan=0.0)
    return torch.clamp(t, 0, n).to(torch.int64)


@torch.no_grad()
def rasterize_mesh(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    camera: Camera,
    dup_capacity: int = 2**20,
    k_max: int = 256,
    tile_chunk: int = 64,
) -> dict:
    """Rasterize a triangle mesh on the vertices' device. Returns
    dict(face_idx (H,W) int64 [-1 = background], zbuf (H,W) view-z [-1 =
    background], bary (H,W,3), overflow, tile_count_max)."""
    dev = vertices.device
    faces = faces.to(device=dev, dtype=torch.int64)
    world_view, full_proj = camera.world_view.to(dev), camera.full_proj.to(dev)
    h, w = camera.height, camera.width
    tiles_x = (w + rc.TILE_X - 1) // rc.TILE_X
    tiles_y = (h + rc.TILE_Y - 1) // rc.TILE_Y
    num_tiles = tiles_x * tiles_y
    f = faces.shape[0]

    # Project vertices.
    v_h = vertices @ full_proj[:, :3].T + full_proj[:, 3]
    v_z = vertices @ world_view[2, :3] + world_view[2, 3]
    w_safe = torch.where(torch.abs(v_h[:, 3]) > 1e-7, v_h[:, 3], 1e-7)
    ndc = v_h[:, :2] / w_safe[:, None]
    pix = torch.stack([((ndc[:, 0] + 1) * w - 1) * 0.5, ((ndc[:, 1] + 1) * h - 1) * 0.5], dim=-1)

    fv_pix = pix[faces]  # (F, 3, 2)
    fv_z = v_z[faces]  # (F, 3)
    valid = torch.all(fv_z > 0.01, dim=-1)  # near-cull the whole triangle

    # Tile rects from pixel bboxes.
    lo = torch.amin(fv_pix, dim=1)
    hi = torch.amax(fv_pix, dim=1)
    rmin_x = _tile_bound(lo[:, 0], rc.TILE_X, tiles_x, 0)
    rmin_y = _tile_bound(lo[:, 1], rc.TILE_Y, tiles_y, 0)
    rmax_x = _tile_bound(hi[:, 0], rc.TILE_X, tiles_x, 1)
    rmax_y = _tile_bound(hi[:, 1], rc.TILE_Y, tiles_y, 1)
    counts = torch.where(valid, (rmax_x - rmin_x) * (rmax_y - rmin_y), 0)

    # Static-capacity duplication, then a stable sort by tile (face order
    # within a tile).
    offsets = torch.cumsum(counts, 0) - counts
    total = offsets[-1] + counts[-1]
    d = torch.arange(dup_capacity, dtype=torch.int64, device=dev)
    g = torch.clamp(bucketize_by_offsets(offsets, dup_capacity), 0, f - 1)
    local = d - offsets[g]
    in_range = (d < total) & (local < counts[g])
    rw = torch.clamp(rmax_x[g] - rmin_x[g], min=1)
    tx = rmin_x[g] + local % rw
    ty = rmin_y[g] + local // rw
    tile_id = torch.where(in_range, ty * tiles_x + tx, num_tiles)
    sorted_tile, perm = torch.sort(tile_id, stable=True)
    sorted_face = g[perm]
    t_ids = torch.arange(num_tiles, dtype=torch.int64, device=dev)
    tile_start = torch.searchsorted(sorted_tile, t_ids)
    tile_count = torch.searchsorted(sorted_tile, t_ids, right=True) - tile_start

    # Per-tile z-buffer over each tile's first k_max faces.
    p_tile = rc.TILE_X * rc.TILE_Y
    py_g, px_g = torch.meshgrid(torch.arange(rc.TILE_Y, device=dev),
                                torch.arange(rc.TILE_X, device=dev), indexing="ij")
    px_g = px_g.reshape(-1).to(torch.float32)
    py_g = py_g.reshape(-1).to(torch.float32)
    k_ar = torch.arange(k_max, dtype=torch.int64, device=dev)
    face_t = torch.empty((num_tiles, p_tile), dtype=torch.int64, device=dev)
    z_t = torch.empty((num_tiles, p_tile), dtype=torch.float32, device=dev)
    bary_t = torch.empty((num_tiles, p_tile, 3), dtype=torch.float32, device=dev)
    for c0 in range(0, num_tiles, tile_chunk):
        t = t_ids[c0:c0 + tile_chunk]
        start, count = tile_start[t], tile_count[t]
        in_list = k_ar[None, :] < count[:, None]  # (C, K)
        fid = sorted_face[torch.clamp(start[:, None] + k_ar[None, :], 0, dup_capacity - 1)]
        tri = fv_pix[fid]  # (C, K, 3, 2)
        tz = fv_z[fid]  # (C, K, 3)
        # Edge functions (signed areas) for barycentrics; (C, K, 1) against
        # the tile's pixel centres (C, 1, P).
        x0, y0 = tri[:, :, 0, 0:1], tri[:, :, 0, 1:2]
        x1, y1 = tri[:, :, 1, 0:1], tri[:, :, 1, 1:2]
        x2, y2 = tri[:, :, 2, 0:1], tri[:, :, 2, 1:2]
        px_ = ((t % tiles_x) * rc.TILE_X)[:, None, None] + px_g[None, None, :]
        py_ = ((t // tiles_x) * rc.TILE_Y)[:, None, None] + py_g[None, None, :]
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        area_ok = torch.abs(area) > 1e-12
        area_safe = torch.where(area_ok, area, 1.0)
        w0 = ((x1 - px_) * (y2 - py_) - (x2 - px_) * (y1 - py_)) / area_safe
        w1 = ((x2 - px_) * (y0 - py_) - (x0 - px_) * (y2 - py_)) / area_safe
        w2 = 1.0 - w0 - w1
        inside = ((w0 >= -_EDGE_EPS) & (w1 >= -_EDGE_EPS) & (w2 >= -_EDGE_EPS)
                  & in_list[:, :, None] & area_ok)
        # Perspective-correct interpolation of z and barycentrics.
        tz0, tz1, tz2 = tz[:, :, 0:1], tz[:, :, 1:2], tz[:, :, 2:3]
        inv_z = w0 / tz0 + w1 / tz1 + w2 / tz2
        z = torch.where(inside, 1.0 / torch.clamp(inv_z, min=1e-12), torch.inf)
        best = torch.argmin(z, dim=1, keepdim=True)  # (C, 1, P): the first minimum
        zbuf = torch.take_along_dim(z, best, dim=1)[:, 0]
        hit = torch.isfinite(zbuf)

        def sel(a, tzk):  # (w / tz * z) of the winning face, per pixel
            a = torch.take_along_dim(a, best, dim=1)[:, 0]
            return a / torch.take_along_dim(tzk.expand(-1, -1, p_tile), best, dim=1)[:, 0] * zbuf

        bary = torch.stack([sel(w0, tz0), sel(w1, tz1), sel(w2, tz2)], dim=-1)
        face_t[c0:c0 + tile_chunk] = torch.where(hit, torch.gather(fid, 1, best[:, 0]), -1)
        z_t[c0:c0 + tile_chunk] = torch.where(hit, zbuf, -1.0)
        bary_t[c0:c0 + tile_chunk] = torch.where(hit[..., None], bary, 0.0)

    def assemble(x):
        x = x.reshape(tiles_y, tiles_x, rc.TILE_Y, rc.TILE_X, *x.shape[2:]).transpose(1, 2)
        return x.reshape(tiles_y * rc.TILE_Y, tiles_x * rc.TILE_X, *x.shape[4:])[:h, :w]

    return dict(
        face_idx=assemble(face_t),
        zbuf=assemble(z_t),
        bary=assemble(bary_t),
        overflow=torch.clamp(total - dup_capacity, min=0),
        tile_count_max=torch.amax(tile_count),
    )
