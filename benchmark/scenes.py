"""Inputs the benchmark makes from a configuration and a seed: cameras,
target images, the lat-long mesh and its adjacency. The same numbers go to
the program and to the reference."""

from __future__ import annotations

import math

import torch

from benchmark import frozen
from benchmark.reference.raster import View, look_at_view


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63 - 1))
    return g


def spiral_views(cfg: dict) -> list[View]:
    """``cfg['views']`` cameras on a golden-angle spiral over the upper
    hemisphere (elevation 3-72 degrees) at ``camera_radius`` around
    ``center``, each looking at it."""
    n = cfg["views"]
    c = torch.tensor(cfg["center"], dtype=torch.float64)
    views = []
    for i in range(n):
        el = math.asin(0.05 + 0.9 * (i + 0.5) / n)
        az = i * math.pi * (3.0 - math.sqrt(5.0))
        d = torch.tensor([math.cos(el) * math.cos(az), math.sin(el), math.cos(el) * math.sin(az)],
                         dtype=torch.float64)
        views.append(look_at_view(c + cfg["camera_radius"] * d, c, (0.0, 1.0, 0.0),
                                  cfg["fov_x"], cfg["height"], cfg["width"]))
    return views


def orbit_views(cfg: dict, traffic: dict) -> list[View]:
    """``traffic['views']`` cameras on a circle of ``radius`` around the
    configuration's centre at ``elevation_deg``, evenly spaced."""
    n = traffic["views"]
    c = torch.tensor(cfg["center"], dtype=torch.float64)
    el = math.radians(traffic["elevation_deg"])
    views = []
    for i in range(n):
        az = 2 * math.pi * i / n
        d = torch.tensor([math.cos(el) * math.cos(az), math.sin(el), math.cos(el) * math.sin(az)],
                         dtype=torch.float64)
        views.append(look_at_view(c + traffic["radius"] * d, c, (0.0, 1.0, 0.0),
                                  cfg["fov_x"], cfg["height"], cfg["width"]))
    return views


def extent(views: list[View]) -> float:
    """1.1 x the largest distance of the camera centres from their mean."""
    cs = torch.stack([v.campos.to(torch.float64) for v in views])
    return float(1.1 * torch.linalg.norm(cs - cs.mean(0), dim=-1).max())


def targets(cfg: dict, views: list[View], device) -> torch.Tensor:
    """(n, H, W, 3) float32 photographs of the scene: each view's pixel
    rays cast against the blob surface around ``center`` (64 marching steps
    inside its bounding sphere, then 24 bisections), coloured by the blob's
    colour field, black where a ray misses. The Gaussians of both
    configurations lie on this surface with these colours, so the model
    starts near its targets, as a trained model does, and its geometry
    holds still through a window of steps."""
    h, w = cfg["height"], cfg["width"]
    c = torch.tensor(cfg["center"], dtype=torch.float32, device=device)
    ys = (2 * torch.arange(h, dtype=torch.float32, device=device) + 1) / h - 1
    xs = (2 * torch.arange(w, dtype=torch.float32, device=device) + 1) / w - 1
    out = torch.empty((len(views), h, w, 3), dtype=torch.float32, device=device)
    for i, v in enumerate(views):
        rot = v.viewmatrix[:3, :3].to(device)
        d = torch.stack([xs[None, :].expand(h, w) * v.tanfovx,
                         ys[:, None].expand(h, w) * v.tanfovy, torch.ones((h, w), device=device)], -1)
        d = d @ rot
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = v.campos.to(device) - c
        b = (d * o).sum(-1)
        disc = b * b - (o * o).sum() + 1.0
        inside = disc > 0
        t0 = torch.clamp(-b - torch.sqrt(torch.clamp(disc, min=0)), min=0)
        t1 = -b + torch.sqrt(torch.clamp(disc, min=0))

        def f(t):
            p = o + t[..., None] * d
            r = torch.linalg.norm(p, dim=-1)
            return r - frozen.blob_surface((p / r[..., None]).reshape(-1, 3)).reshape(r.shape)

        lo, hi = t0.clone(), t0.clone()
        hit = torch.zeros_like(inside)
        step = (t1 - t0) / 64
        for k in range(1, 65):
            t = t0 + k * step
            now = (f(t) < 0) & ~hit
            hi = torch.where(now, t, hi)
            lo = torch.where(now, t - step, lo)
            hit = hit | now
        for _ in range(24):
            mid = 0.5 * (lo + hi)
            out_ = f(mid) > 0
            lo = torch.where(out_, mid, lo)
            hi = torch.where(out_, hi, mid)
        p = o + hi[..., None] * d + c
        col = frozen.blob_colors(p.reshape(-1, 3)).reshape(h, w, 3)
        out[i] = torch.where((hit & inside)[..., None], col, torch.zeros((), device=device))
    return out


def latlong_mesh(cfg: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The blob surface as a lat-long mesh: ``rings`` x ``segments``
    vertices plus the two poles, (vertices (V, 3) float32, faces (F, 3)
    int64)."""
    nr, ns = cfg["rings"], cfg["segments"]
    phi = (torch.arange(nr, dtype=torch.float64, device=device) + 1) * math.pi / (nr + 1)
    th = torch.arange(ns, dtype=torch.float64, device=device) * 2 * math.pi / ns
    d = torch.stack([torch.sin(phi)[:, None] * torch.cos(th)[None, :],
                     torch.cos(phi)[:, None].expand(nr, ns),
                     torch.sin(phi)[:, None] * torch.sin(th)[None, :]], -1).reshape(-1, 3)
    poles = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]], dtype=torch.float64, device=device)
    d = torch.cat([d, poles])
    center = torch.tensor(cfg["center"], dtype=torch.float64, device=device)
    verts = (d * frozen.blob_surface(d)[:, None] + center).to(torch.float32)
    idx = torch.arange(nr * ns, device=device).reshape(nr, ns)
    a, b = idx[:-1], torch.roll(idx[:-1], -1, 1)
    c, e = idx[1:], torch.roll(idx[1:], -1, 1)
    top, bot = nr * ns, nr * ns + 1
    faces = torch.cat([
        torch.stack([a, c, b], -1).reshape(-1, 3),
        torch.stack([b, c, e], -1).reshape(-1, 3),
        torch.stack([torch.full_like(idx[0], top), idx[0], torch.roll(idx[0], -1)], -1),
        torch.stack([torch.full_like(idx[-1], bot), torch.roll(idx[-1], -1), idx[-1]], -1),
    ])
    return verts, faces


def face_pairs(faces: torch.Tensor) -> torch.Tensor:
    """(P, 2) int64 pairs of faces that share an edge, lower face first."""
    f = faces.shape[0]
    e = torch.stack([faces, torch.roll(faces, -1, 1)], -1).reshape(-1, 2)
    e = torch.sort(e, dim=1).values
    n = int(faces.max()) + 1
    key = e[:, 0] * n + e[:, 1]
    order = torch.sort(key, stable=True).indices
    key_s = key[order]
    fid = (torch.arange(3 * f, device=faces.device) // 3)[order]
    same = key_s[1:] == key_s[:-1]
    return torch.stack([fid[:-1][same], fid[1:][same]], -1)
