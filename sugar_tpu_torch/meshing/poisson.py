"""Surface reconstruction from oriented point clouds, dependency-free.

Copy of ``sugar_tpu/meshing/poisson.py`` (numpy only; the port keeps its
own copy so it imports nothing of the JAX package, and its output is the
JAX package's bit for bit).

Replaces Open3D's ``create_from_point_cloud_poisson`` + vertex-density
trimming (sugar_extractors/coarse_mesh.py:389-395) without depending on
Open3D: the classic FFT formulation of Poisson surface
reconstruction (Kazhdan 2005, "Reconstruction of Solid Models from Oriented
Point Sets") is implemented directly:

1. splat oriented normals into a regular grid vector field V (trilinear);
2. solve the Poisson equation  laplacian(chi) = div V  spectrally: in
   Fourier space  chi_hat = i k . V_hat / (-|k|^2)  (with a small screening
   term for stability);
3. choose the iso value as the mean of chi at the sample points;
4. extract the iso surface with Surface Nets (naive surface nets produce a
   watertight quad mesh; quads are split into triangles) — a deliberate,
   simpler stand-in for marching cubes with equivalent output quality at
   these resolutions;
5. trim vertices whose local sample support is in the lowest density
   quantile (mirrors o3d's remove_vertices_by_density, coarse_mesh.py:43).

Runs host-side in numpy (the reference's Poisson is CPU C++ too); grids to
256^3 by default.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PoissonResult:
    vertices: np.ndarray  # (V, 3)
    faces: np.ndarray  # (F, 3) int
    densities: np.ndarray  # (V,) sample support per vertex


def _splat_trilinear(grid: np.ndarray, idx_f: np.ndarray, values: np.ndarray) -> None:
    """Accumulate values (N, C) into grid (X, Y, Z, C) at float coords."""
    res = grid.shape[0]
    i0 = np.floor(idx_f).astype(np.int64)
    frac = idx_f - i0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (frac[:, 0] if dx else 1 - frac[:, 0])
                    * (frac[:, 1] if dy else 1 - frac[:, 1])
                    * (frac[:, 2] if dz else 1 - frac[:, 2])
                )
                ii = np.clip(i0 + np.array([dx, dy, dz]), 0, res - 1)
                np.add.at(
                    grid,
                    (ii[:, 0], ii[:, 1], ii[:, 2]),
                    values * w[:, None] if values.ndim == 2 else values * w,
                )


def _sample_trilinear(grid: np.ndarray, idx_f: np.ndarray) -> np.ndarray:
    res = grid.shape[0]
    i0 = np.clip(np.floor(idx_f).astype(np.int64), 0, res - 2)
    f = np.clip(idx_f - i0, 0.0, 1.0)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                out = out + grid[i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz] * w
    return out


def poisson_reconstruct(
    points: np.ndarray,
    normals: np.ndarray,
    resolution: int = 256,
    padding: float = 0.1,
    screen: float = 1e-4,
    smooth_sigma_cells: float = 1.5,
) -> PoissonResult:
    """Reconstruct a watertight surface from an oriented point cloud."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = (hi - lo).max()
    center = (hi + lo) / 2
    half = span * (0.5 + padding)
    origin = center - half
    scale = (2 * half) / (resolution - 1)

    idx_f = (points - origin) / scale
    vec = np.zeros((resolution, resolution, resolution, 3), np.float32)
    _splat_trilinear(vec, idx_f, normals.astype(np.float32))
    support = np.zeros((resolution,) * 3, np.float32)
    _splat_trilinear(support, idx_f, np.ones(len(points), np.float32))

    # Spectral solve: chi_hat = (i k . V_hat) / (-(|k|^2 + screen)); a
    # Gaussian low-pass stands in for the octree's B-spline smoothing.
    k = np.fft.fftfreq(resolution) * 2 * np.pi
    kx, ky, kz = np.meshgrid(k, k, k, indexing="ij")
    k2 = kx**2 + ky**2 + kz**2
    gauss = np.exp(-0.5 * smooth_sigma_cells**2 * k2)
    div_hat = (
        1j * kx * np.fft.fftn(vec[..., 0])
        + 1j * ky * np.fft.fftn(vec[..., 1])
        + 1j * kz * np.fft.fftn(vec[..., 2])
    ) * gauss
    chi_hat = div_hat / -(k2 + screen)
    chi_hat[0, 0, 0] = 0.0
    chi = np.real(np.fft.ifftn(chi_hat)).astype(np.float32)

    iso = float(np.mean(_sample_trilinear(chi, idx_f)))

    verts_g, faces = surface_nets(chi, iso)
    if len(verts_g) == 0:
        return PoissonResult(
            vertices=np.zeros((0, 3), np.float32),
            faces=np.zeros((0, 3), np.int64),
            densities=np.zeros((0,), np.float32),
        )
    verts = verts_g * scale + origin
    dens = _sample_trilinear(support, verts_g)
    return PoissonResult(vertices=verts.astype(np.float32), faces=faces, densities=dens)


def surface_nets(field: np.ndarray, iso: float) -> tuple[np.ndarray, np.ndarray]:
    """Naive Surface Nets iso-extraction.

    Returns (vertices in grid coords (V, 3), triangle faces (F, 3)). One
    vertex per sign-change cell (centroid of edge crossings); one quad per
    grid edge with a sign change, connecting the 4 adjacent cells, oriented
    by the field gradient; quads split into two triangles.
    """
    f = field - iso
    inside = f < 0

    # Cells: (res-1)^3; a cell has a crossing iff its 8 corners mix signs.
    rx, ry, rz = (s - 1 for s in f.shape)
    corners = np.zeros((rx, ry, rz), np.uint8)
    for ci, (dx, dy, dz) in enumerate(
        [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    ):
        corners |= inside[dx : dx + rx, dy : dy + ry, dz : dz + rz].astype(np.uint8) << ci
    active = (corners != 0) & (corners != 255)
    cell_idx = np.full(active.shape, -1, np.int64)
    ids = np.nonzero(active)
    n_cells = len(ids[0])
    if n_cells == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    cell_idx[ids] = np.arange(n_cells)

    # Vertex = centroid of edge crossings within the cell.
    cx, cy, cz = (a.astype(np.float32) for a in ids)
    base = np.stack([cx, cy, cz], axis=-1)  # (C, 3) lower corner

    edge_table = []
    cdirs = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    for a in range(8):
        for b in range(a + 1, 8):
            da = np.array(cdirs[a])
            db = np.array(cdirs[b])
            if np.abs(da - db).sum() == 1:
                edge_table.append((a, b, da, db))

    acc = np.zeros((n_cells, 3), np.float32)
    cnt = np.zeros((n_cells,), np.float32)
    ix, iy, iz = (a.astype(np.int64) for a in ids)
    for a, b, da, db in edge_table:
        fa = f[ix + da[0], iy + da[1], iz + da[2]]
        fb = f[ix + db[0], iy + db[1], iz + db[2]]
        cross = (fa < 0) != (fb < 0)
        t = np.where(cross, fa / np.where(np.abs(fa - fb) > 1e-30, fa - fb, 1.0), 0.0)
        p = base + da[None, :] + t[:, None] * (db - da)[None, :]
        acc += np.where(cross[:, None], p, 0.0)
        cnt += cross
    verts = acc / np.maximum(cnt[:, None], 1.0)

    # Faces: for each axis, grid edges along that axis with a sign change
    # connect 4 neighboring cells in the perpendicular plane.
    faces = []
    for axis in range(3):
        d = np.zeros(3, np.int64)
        d[axis] = 1
        # Edge from node n to n+d; valid where the 4 adjacent cells exist:
        # cells at n - e1, n - e2, n - e1 - e2, n (in the perpendicular axes).
        e1 = np.zeros(3, np.int64)
        e2 = np.zeros(3, np.int64)
        # Right-handed perpendicular pair (e1 x e2 == +axis) so the winding
        # rule below is consistent across all three axes.
        a1, a2 = [(1, 2), (2, 0), (0, 1)][axis]
        e1[a1] = 1
        e2[a2] = 1
        # Node ranges where all 4 cells in-bounds.
        nx = [f.shape[0] - 1, f.shape[1] - 1, f.shape[2] - 1]
        lo_n = [1, 1, 1]
        lo_n[axis] = 0
        xs = np.arange(lo_n[0], nx[0] if axis != 0 else nx[0])
        ys = np.arange(lo_n[1], nx[1] if axis != 1 else nx[1])
        zs = np.arange(lo_n[2], nx[2] if axis != 2 else nx[2])
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        n0 = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)
        fa = f[n0[:, 0], n0[:, 1], n0[:, 2]]
        nb = n0 + d
        fb = f[nb[:, 0], nb[:, 1], nb[:, 2]]
        cross = (fa < 0) != (fb < 0)
        n0 = n0[cross]
        if len(n0) == 0:
            continue
        flip = (fa < 0)[cross]  # orientation by sign of entering corner
        c00 = cell_idx[n0[:, 0] - e1[0] - e2[0], n0[:, 1] - e1[1] - e2[1], n0[:, 2] - e1[2] - e2[2]]
        c10 = cell_idx[n0[:, 0] - e2[0], n0[:, 1] - e2[1], n0[:, 2] - e2[2]]
        c11 = cell_idx[n0[:, 0], n0[:, 1], n0[:, 2]]
        c01 = cell_idx[n0[:, 0] - e1[0], n0[:, 1] - e1[1], n0[:, 2] - e1[2]]
        quad = np.stack([c00, c10, c11, c01], axis=-1)
        ok = (quad >= 0).all(axis=-1)
        quad = quad[ok]
        flip = flip[ok]
        quad[flip] = quad[flip][:, ::-1]
        faces.append(np.stack([quad[:, 0], quad[:, 1], quad[:, 2]], axis=-1))
        faces.append(np.stack([quad[:, 0], quad[:, 2], quad[:, 3]], axis=-1))
    if not faces:
        return verts, np.zeros((0, 3), np.int64)
    return verts, np.concatenate(faces, axis=0)


def remove_low_density_vertices(
    res: PoissonResult, quantile: float = 0.1
) -> tuple[np.ndarray, np.ndarray]:
    """Drop the lowest-support vertices and their faces
    (coarse_mesh.py:392-395 remove_vertices_by_density)."""
    if len(res.vertices) == 0:
        return res.vertices, res.faces
    thresh = np.quantile(res.densities, quantile)
    keep = res.densities > thresh
    return filter_vertices(res.vertices, res.faces, keep)


def filter_vertices(vertices, faces, keep_mask):
    remap = np.full(len(vertices), -1, np.int64)
    remap[keep_mask] = np.arange(int(keep_mask.sum()))
    fkeep = keep_mask[faces].all(axis=1)
    return vertices[keep_mask], remap[faces[fkeep]]
