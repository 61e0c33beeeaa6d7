"""Plain PyTorch reference of the 3DGS rasterizer, written for the benchmark.

It follows the published algorithm of the 3DGS CUDA rasterizer (Kerbl et
al. 2023, ``diff-gaussian-rasterization`` forward.cu / backward.cu): EWA
projection with the 0.3 px low-pass, a bounding radius of 3 sigma over
16x16 tiles, one depth order per tile (equal depths keep index order),
alpha = min(0.99, opacity * exp(power)) skipped below 1/255, a pixel that
stops at the first Gaussian that would take its transmittance below 1e-4,
and a gradient that ignores the 0.99 clamp. It imports nothing of the
program; its gradients come from autograd.

The image is composited tile by tile in groups of tiles, ``CHUNK`` list
slots at a time, so that a frame of 2M Gaussians at 1920x1244 fits. The
gradient takes two passes: the whole image first (the loss is not local),
then each group again under autograd with its share of the image
cotangent, accumulated into the screen-space leaves, and last one backward
through the projection.

While it composites, it counts the least work the frame needs (for
``benchmark/counts.py``): for each pixel the Gaussians of its tile, in
depth order, whose alpha >= 1/255 support reaches a pixel of the tile, up
to and including the one at which the pixel stops.
"""

from __future__ import annotations

import dataclasses
import math

import torch

TILE = 16
P_TILE = TILE * TILE
ALPHA_CLAMP = 0.99
ALPHA_CUTOFF = 1.0 / 255.0
T_EPS = 1e-4
LOWPASS = 0.3
Z_CULL = 0.2
FOV_CLAMP = 1.3
W_EPS = 1e-7
CHUNK = 64  # list slots per compositing step
# Tiles x padded list slots per group: the autograd pass keeps about ten
# (tiles, 256, slots) float tensors of a group alive.
GROUP_SLOTS = 2**20

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@dataclasses.dataclass(frozen=True)
class View:
    """One pinhole view in the 3DGS row convention (p_cam = W2C @ p)."""

    viewmatrix: torch.Tensor  # (4, 4)
    projmatrix: torch.Tensor  # (4, 4) projection @ viewmatrix
    campos: torch.Tensor  # (3,)
    height: int
    width: int
    tanfovx: float
    tanfovy: float

    @property
    def tiles_x(self) -> int:
        return (self.width + TILE - 1) // TILE

    @property
    def tiles_y(self) -> int:
        return (self.height + TILE - 1) // TILE

    def to(self, device, dtype=torch.float32) -> "View":
        return dataclasses.replace(
            self, viewmatrix=self.viewmatrix.to(device, dtype),
            projmatrix=self.projmatrix.to(device, dtype), campos=self.campos.to(device, dtype))


def look_at_view(center, target, up, fov_x: float, height: int, width: int,
                 znear: float = 0.01, zfar: float = 100.0) -> View:
    """A view at ``center`` looking at ``target`` (float64 host math, float32
    matrices), with the 3DGS projection of ``fov_x`` and the fov_y the
    aspect gives."""
    c = torch.as_tensor(center, dtype=torch.float64)
    fwd = torch.as_tensor(target, dtype=torch.float64) - c
    fwd = fwd / torch.linalg.norm(fwd)
    up = torch.as_tensor(up, dtype=torch.float64)
    right = torch.linalg.cross(up, fwd)
    right = right / torch.linalg.norm(right)
    up2 = torch.linalg.cross(fwd, right)
    rot = torch.stack([right, up2, fwd])  # world -> camera rows
    w2c = torch.eye(4, dtype=torch.float64)
    w2c[:3, :3] = rot
    w2c[:3, 3] = -rot @ c
    tanx = math.tan(fov_x / 2.0)
    tany = tanx * height / width
    proj = torch.zeros((4, 4), dtype=torch.float64)
    proj[0, 0] = 1.0 / tanx
    proj[1, 1] = 1.0 / tany
    proj[3, 2] = 1.0
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    return View(
        viewmatrix=w2c.to(torch.float32), projmatrix=(proj @ w2c).to(torch.float32),
        campos=c.to(torch.float32), height=int(height), width=int(width),
        tanfovx=tanx, tanfovy=tany)


def cov_from_quaternions(scales: torch.Tensor, quats: torch.Tensor) -> tuple:
    """Sigma = R diag(s^2) R^T for unit wxyz quaternions: 6 (N,) channels
    (xx, xy, xz, yy, yz, zz)."""
    w, x, y, z = quats.unbind(-1)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    return cov_from_rotation(rot, scales)


def cov_from_rotation(rot: torch.Tensor, scales: torch.Tensor) -> tuple:
    """Sigma = R diag(s^2) R^T for (N, 3, 3) rotations whose columns are the
    axes of ``scales``: 6 (N,) channels."""
    s2 = scales * scales

    def sig(i, k):
        return (rot[:, i, 0] * s2[:, 0] * rot[:, k, 0] + rot[:, i, 1] * s2[:, 1] * rot[:, k, 1]
                + rot[:, i, 2] * s2[:, 2] * rot[:, k, 2])

    return sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)


def eval_sh(deg: int, sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """max(SH(deg) at unit directions d + 0.5, 0): (N, C) from (N, C, K)."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    r = SH_C0 * sh[..., 0]
    if deg > 0:
        r = r - SH_C1 * y * sh[..., 1] + SH_C1 * z * sh[..., 2] - SH_C1 * x * sh[..., 3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        r = (r + SH_C2[0] * xy * sh[..., 4] + SH_C2[1] * yz * sh[..., 5]
             + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6] + SH_C2[3] * xz * sh[..., 7]
             + SH_C2[4] * (xx - yy) * sh[..., 8])
    if deg > 2:
        r = (r + SH_C3[0] * y * (3 * xx - yy) * sh[..., 9] + SH_C3[1] * xy * z * sh[..., 10]
             + SH_C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
             + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
             + SH_C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
             + SH_C3[5] * z * (xx - yy) * sh[..., 14] + SH_C3[6] * x * (xx - 3 * yy) * sh[..., 15])
    v = r + 0.5
    return torch.maximum(v, torch.zeros((), dtype=v.dtype, device=v.device))


@dataclasses.dataclass
class Screen:
    """Per-Gaussian screen-space quantities of one view."""

    mean2d: torch.Tensor  # (N, 2)
    conic: torch.Tensor  # (N, 3)
    opacity: torch.Tensor  # (N,)
    color: torch.Tensor  # (N, C)
    depth: torch.Tensor  # (N,)
    rect_min: torch.Tensor  # (N, 2) int64 tiles, inclusive
    rect_max: torch.Tensor  # (N, 2) int64 tiles, exclusive
    visible: torch.Tensor  # (N,) bool


def _tile_index(x: torch.Tensor, hi: int) -> torch.Tensor:
    x = torch.clamp(torch.nan_to_num(x.detach().to(torch.float32), nan=0.0), -1.0, hi + 1.0)
    return torch.clamp(x.to(torch.int64), 0, hi)


def project(means, cov6, opacity, view: View, sh=None, sh_degree=0, colors=None,
            alive=None) -> Screen:
    """EWA projection of every Gaussian (forward.cu preprocessCUDA)."""
    dt = means.dtype
    vm = view.viewmatrix.to(dt)
    pm = view.projmatrix.to(dt)
    t = means @ vm[:3, :3].T + vm[:3, 3]
    depth = means @ vm[2, :3] + vm[2, 3]
    in_front = depth > Z_CULL
    tz = torch.where(t[:, 2] > Z_CULL, t[:, 2], torch.ones((), dtype=dt, device=means.device))
    limx, limy = FOV_CLAMP * view.tanfovx, FOV_CLAMP * view.tanfovy
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
    fx = view.width / (2.0 * view.tanfovx)
    fy = view.height / (2.0 * view.tanfovy)
    j00, j02 = fx / tz, -fx * tx / (tz * tz)
    j11, j12 = fy / tz, -fy * ty / (tz * tz)
    m0 = [j00 * vm[0, k] + j02 * vm[2, k] for k in range(3)]
    m1 = [j11 * vm[1, k] + j12 * vm[2, k] for k in range(3)]
    s00, s01, s02, s11, s12, s22 = cov6

    def quad(a, b):
        return (a[0] * (s00 * b[0] + s01 * b[1] + s02 * b[2])
                + a[1] * (s01 * b[0] + s11 * b[1] + s12 * b[2])
                + a[2] * (s02 * b[0] + s12 * b[1] + s22 * b[2]))

    cxx = quad(m0, m0) + LOWPASS
    cyy = quad(m1, m1) + LOWPASS
    cxy = quad(m0, m1)
    det = cxx * cyy - cxy * cxy
    det_ok = det != 0
    inv = 1.0 / torch.where(det_ok, det, torch.ones((), dtype=dt, device=means.device))
    conic = torch.stack([cyy * inv, -cxy * inv, cxx * inv], -1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0))).detach()

    p_hom = means @ pm[:, :3].T + pm[:, 3]
    p_w = 1.0 / torch.where(in_front, p_hom[:, 3] + W_EPS,
                            torch.ones((), dtype=dt, device=means.device))
    ndc = p_hom[:, :2] * p_w[:, None]
    mean2d = torch.stack([((ndc[:, 0] + 1.0) * view.width - 1.0) * 0.5,
                          ((ndc[:, 1] + 1.0) * view.height - 1.0) * 0.5], -1)
    md = mean2d.detach()
    gx, gy = view.tiles_x, view.tiles_y
    rmin = torch.stack([_tile_index((md[:, 0] - radius) / TILE, gx),
                        _tile_index((md[:, 1] - radius) / TILE, gy)], -1)
    rmax = torch.stack([_tile_index((md[:, 0] + radius + TILE - 1) / TILE, gx),
                        _tile_index((md[:, 1] + radius + TILE - 1) / TILE, gy)], -1)
    visible = in_front & det_ok & ((rmax - rmin).prod(-1) > 0)
    if alive is not None:
        visible = visible & alive
    if colors is None:
        d = means - view.campos.to(dt)
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
        colors = eval_sh(sh_degree, sh[..., :(sh_degree + 1) ** 2], d)
    return Screen(mean2d=mean2d, conic=conic, opacity=opacity, color=colors, depth=depth,
                  rect_min=rmin, rect_max=rmax, visible=visible)


@dataclasses.dataclass
class TileLists:
    gid: torch.Tensor  # (E,) Gaussian ids in (tile, depth, index) order
    start: torch.Tensor  # (T,) int64
    count: torch.Tensor  # (T,) int64


def tile_lists(sc: Screen, view: View) -> TileLists:
    """Every (tile, Gaussian) pair of the tile rects, sorted by tile, then
    depth, equal depths in index order."""
    dev = sc.depth.device
    n = sc.depth.shape[0]
    ids = torch.nonzero(sc.visible).squeeze(1)
    w = (sc.rect_max[ids, 0] - sc.rect_min[ids, 0])
    cnt = w * (sc.rect_max[ids, 1] - sc.rect_min[ids, 1])
    gid = torch.repeat_interleave(ids, cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    off = torch.arange(gid.shape[0], device=dev) - first
    wg = torch.repeat_interleave(w, cnt)
    tile = ((sc.rect_min[gid, 1] + off // wg) * view.tiles_x + sc.rect_min[gid, 0] + off % wg)
    depth = torch.where(sc.visible, sc.depth.detach().to(torch.float32), torch.inf)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.sort(depth, stable=True).indices] = torch.arange(n, device=dev)
    order = torch.sort(tile * n + rank[gid]).indices
    gid, tile = gid[order], tile[order]
    t = view.tiles_x * view.tiles_y
    count = torch.bincount(tile, minlength=t)
    return TileLists(gid=gid, start=torch.cumsum(count, 0) - count, count=count)


@dataclasses.dataclass
class Group:
    tiles: torch.Tensor  # (G,) tile ids
    gid: torch.Tensor  # (G, L) Gaussian ids, n past each list's end
    lens: torch.Tensor  # (G,) list lengths
    chunks: int  # list chunks composited (set by the first pass)


def _groups(tl: TileLists, n: int) -> list[Group]:
    """Tiles with lists, longest first, in groups of at most GROUP_SLOTS
    padded slots."""
    count = tl.count
    nz = torch.nonzero(count).squeeze(1)
    order = nz[torch.sort(count[nz], descending=True, stable=True).indices]
    counts = count[order].tolist()
    groups, i = [], 0
    while i < len(counts):
        lmax = counts[i]
        g = max(1, min(len(counts) - i, GROUP_SLOTS // max(lmax, 1)))
        tiles = order[i:i + g]
        lpad = ((lmax + CHUNK - 1) // CHUNK) * CHUNK
        pos = torch.arange(lpad, device=count.device)
        valid = pos[None, :] < count[tiles][:, None]
        idx = torch.clamp(tl.start[tiles][:, None] + pos[None, :], max=max(tl.gid.shape[0] - 1, 0))
        gid = torch.where(valid, tl.gid[idx], n)
        groups.append(Group(tiles=tiles, gid=gid, lens=count[tiles], chunks=lpad // CHUNK))
        i += g
    return groups


def _pixels(tiles: torch.Tensor, tiles_x: int, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, 256) pixel x and y of each tile, row-major inside the tile."""
    k = torch.arange(P_TILE, device=tiles.device)
    px = (tiles % tiles_x)[:, None] * TILE + k[None, :] % TILE
    py = (tiles // tiles_x)[:, None] * TILE + k[None, :] // TILE
    return px.to(dtype), py.to(dtype)


def _ext(x: torch.Tensor) -> torch.Tensor:
    """x with one zero row appended: the row the padding id n reads."""
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


def _composite_group(grp: Group, sc_ext: tuple, view: View, count: dict | None,
                     first_pass: bool):
    """Composite one group: (image (G, 256, C) without background, final T
    (G, 256)). In the first pass it stops when every pixel is done and sets
    ``grp.chunks``; ``count`` (a dict) gathers the least-work counts."""
    mean2d, conic, opacity, color = sc_ext
    dt = mean2d.dtype
    g = grp.gid.shape[0]
    px, py = _pixels(grp.tiles, view.tiles_x, dt)
    in_image = (px < view.width) & (py < view.height)
    p_raw = torch.ones((g, P_TILE), dtype=dt, device=mean2d.device)
    t_eff = torch.ones_like(p_raw)
    img = torch.zeros((g, P_TILE, color.shape[-1]), dtype=dt, device=mean2d.device)
    nchunks = grp.chunks
    for c in range(nchunks):
        ids = grp.gid[:, c * CHUNK:(c + 1) * CHUNK]
        m = mean2d[ids]
        con = conic[ids]
        dx = m[:, None, :, 0] - px[:, :, None]
        dy = m[:, None, :, 1] - py[:, :, None]
        power = (-0.5 * (con[:, None, :, 0] * dx * dx + con[:, None, :, 2] * dy * dy)
                 - con[:, None, :, 1] * dx * dy)
        pw_ok = power <= 0.0
        e = torch.exp(torch.where(pw_ok, power, torch.zeros((), dtype=dt, device=dx.device)))
        raw = opacity[ids][:, None, :] * e
        alpha = raw + (torch.clamp(raw, max=ALPHA_CLAMP) - raw).detach()
        keep = pw_ok & (alpha.detach() >= ALPHA_CUTOFF)
        a = torch.where(keep, alpha, torch.zeros((), dtype=dt, device=dx.device))
        om = 1.0 - a
        cp = torch.cumprod(om, dim=-1)
        excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], -1)
        p_before = p_raw[..., None] * excl
        inc = ((p_raw[..., None] * cp).detach() >= T_EPS)
        a_inc = a * inc
        w = a_inc * p_before
        img = img + torch.einsum("gpk,gkc->gpc", w, color[ids])
        t_eff = t_eff * torch.prod(1.0 - a_inc, dim=-1)
        if count is not None:
            active = (p_before.detach() >= T_EPS)
            fp = keep.any(dim=1)  # (G, K): support reaches a pixel of the tile
            ev = active & fp[:, None, :] & in_image[..., None]
            count["k1_pairs"] += int(ev.sum())
            slot = fp & active.any(dim=1)
            count["k3_slots"] += int(slot.sum())
            count["touched"][ids[slot]] = True
        p_raw = p_raw * cp[..., -1]
        ended = grp.lens <= (c + 1) * CHUNK
        if first_pass and bool(((p_raw.detach() < T_EPS) | ended[:, None]).all()):
            nchunks = c + 1
            break
    if first_pass:
        grp.chunks = nchunks
    if count is not None:
        count["covered"] += int(((t_eff.detach() < 1.0) & in_image).sum())
    return img, t_eff


def _assemble(tile_vals: torch.Tensor, view: View) -> torch.Tensor:
    """(T, 256, C) tile-major -> (H, W, C)."""
    tx, ty, c = view.tiles_x, view.tiles_y, tile_vals.shape[-1]
    x = tile_vals.reshape(ty, tx, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return x.reshape(ty * TILE, tx * TILE, c)[:view.height, :view.width]


def _disassemble(img: torch.Tensor, view: View) -> torch.Tensor:
    """(H, W, C) -> (T, 256, C), zeros past the image's edge."""
    tx, ty, c = view.tiles_x, view.tiles_y, img.shape[-1]
    pad = torch.zeros((ty * TILE, tx * TILE, c), dtype=img.dtype, device=img.device)
    pad[:view.height, :view.width] = img
    return pad.reshape(ty, TILE, tx, TILE, c).permute(0, 2, 1, 3, 4).reshape(tx * ty, P_TILE, c)


def render(sc: Screen, view: View, bg: torch.Tensor, count: dict | None = None):
    """Image (H, W, C) of a projected view, no gradient. Returns (image,
    groups, tile lists) so that ``backward`` can follow."""
    n = sc.depth.shape[0]
    if count is not None:
        count.update(k1_pairs=0, k3_slots=0, covered=0,
                     touched=torch.zeros(n + 1, dtype=torch.bool, device=sc.depth.device))
    with torch.no_grad():
        tl = tile_lists(sc, view)
        groups = _groups(tl, n)
        ext = tuple(_ext(x.detach()) for x in (sc.mean2d, sc.conic, sc.opacity, sc.color))
        c = sc.color.shape[-1]
        t = view.tiles_x * view.tiles_y
        img_t = torch.zeros((t, P_TILE, c), dtype=sc.mean2d.dtype, device=sc.mean2d.device)
        t_t = torch.ones((t, P_TILE), dtype=sc.mean2d.dtype, device=sc.mean2d.device)
        for grp in groups:
            im, tf = _composite_group(grp, ext, view, count, True)
            img_t[grp.tiles] = im
            t_t[grp.tiles] = tf
        img_t = img_t + t_t[..., None] * bg.to(img_t.dtype)
    return _assemble(img_t, view), groups


def backward(sc: Screen, view: View, bg: torch.Tensor, groups: list, img_grad: torch.Tensor):
    """Backpropagate the image cotangent (H, W, C) through the compositing
    of ``render`` and then through the projection that made ``sc``."""
    leaves = [x.detach().requires_grad_(True) for x in (sc.mean2d, sc.conic, sc.opacity, sc.color)]
    ext = tuple(_ext(x) for x in leaves)
    gt = _disassemble(img_grad.to(sc.mean2d.dtype), view)
    bgv = bg.to(sc.mean2d.dtype)
    for grp in groups:
        im, tf = _composite_group(grp, ext, view, None, False)
        out = im + tf[..., None] * bgv
        torch.autograd.backward(out, gt[grp.tiles])
    outs = [sc.mean2d, sc.conic, sc.opacity, sc.color]
    pairs = [(o, leaf.grad) for o, leaf in zip(outs, leaves)
             if o.requires_grad and leaf.grad is not None]
    if pairs:
        torch.autograd.backward([p[0] for p in pairs], [p[1] for p in pairs])
