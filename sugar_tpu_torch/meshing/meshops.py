"""Mesh/point-cloud post-processing: outlier removal, decimation, cleanup.

Copy of ``sugar_tpu/meshing/meshops.py`` (numpy + a lazy scipy
``cKDTree``), with one deliberate difference: :func:`decimate` runs the
QEM library (``sugar_tpu_torch.native.qem_decimate``) and lets a failed
build or run raise, where the JAX package falls back silently to vertex
clustering. :func:`decimate_vertex_clustering` stays public.

Replaces the Open3D calls of sugar_extractors/coarse_mesh.py:376-489:
``remove_statistical_outlier`` (20 NN, 20 sigma), quadric decimation to a
target vertex budget, and degenerate/duplicate cleanup. Host-side numpy +
scipy (the reference runs these on CPU too).

Decimation: quadric error metrics (Garland-Heckbert) with a uniform-grid
vertex-clustering pre-pass for speed at million-vertex scale; pure QEM is
O(E log E) with a python heap, so clustering does the bulk reduction and a
final cleanup removes the degenerates it introduces.
"""

from __future__ import annotations

import numpy as np

from sugar_tpu_torch import native


def remove_statistical_outliers(
    points: np.ndarray,
    extra: list[np.ndarray] | None = None,
    nb_neighbors: int = 20,
    std_ratio: float = 20.0,
):
    """o3d remove_statistical_outlier semantics: drop points whose mean
    distance to their nb_neighbors NN exceeds mean + std_ratio * std."""
    from scipy.spatial import cKDTree

    if len(points) == 0:
        return points, extra or []
    tree = cKDTree(points)
    d, _ = tree.query(points, k=nb_neighbors + 1)
    mean_d = d[:, 1:].mean(axis=1)
    mu, sd = mean_d.mean(), mean_d.std()
    keep = mean_d <= mu + std_ratio * sd
    return points[keep], [e[keep] for e in (extra or [])]


def clean_mesh(vertices: np.ndarray, faces: np.ndarray):
    """Remove duplicate vertices, degenerate/duplicate faces, unreferenced
    vertices (o3d cleanup calls, coarse_mesh.py:451-463)."""
    if len(vertices) == 0:
        return vertices, faces
    # Merge exactly-duplicated vertices.
    _, first, inv = np.unique(
        vertices.round(decimals=7), axis=0, return_index=True, return_inverse=True
    )
    new_vertices = vertices[first]
    faces = inv[faces]
    # Drop degenerate faces.
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]
    # Drop duplicated faces (any vertex order).
    key = np.sort(faces, axis=1)
    _, fidx = np.unique(key, axis=0, return_index=True)
    faces = faces[np.sort(fidx)]
    # Drop unreferenced vertices.
    used = np.zeros(len(new_vertices), bool)
    used[faces.ravel()] = True
    remap = np.full(len(new_vertices), -1, np.int64)
    remap[used] = np.arange(int(used.sum()))
    return new_vertices[used], remap[faces]


def decimate(vertices: np.ndarray, faces: np.ndarray, target_vertices: int):
    """Decimate to ~target_vertices: quadric error metrics via the native
    C++ library (``native.qem_decimate``, Garland-Heckbert — the o3d
    simplify_quadric_decimation equivalent). A failed build or run raises;
    there is no fallback to vertex clustering."""
    if len(vertices) <= target_vertices or len(faces) == 0:
        return vertices.copy(), faces.copy()
    v, f = native.qem_decimate(vertices, faces, target_vertices)
    return clean_mesh(v, f)


def decimate_vertex_clustering(
    vertices: np.ndarray, faces: np.ndarray, target_vertices: int
):
    """Decimate to ~target_vertices by uniform-grid vertex clustering.

    Serves the role of o3d simplify_quadric_decimation
    (coarse_mesh.py:434-449). Iteratively adjusts the grid pitch to land
    near the vertex budget.
    """
    if len(vertices) <= target_vertices or len(faces) == 0:
        return vertices.copy(), faces.copy()
    lo, hi = vertices.min(0), vertices.max(0)
    span = (hi - lo).max() + 1e-12

    # Binary search the grid resolution for the target vertex count.
    lo_res, hi_res = 8, 4096
    best = None
    for _ in range(14):
        res = int(np.sqrt(lo_res * hi_res))
        cell = np.floor((vertices - lo) / span * res).astype(np.int64)
        key = (cell[:, 0] * (res + 1) + cell[:, 1]) * (res + 1) + cell[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        n = len(uniq)
        if best is None or abs(n - target_vertices) < abs(best[0] - target_vertices):
            best = (n, inv)
        if n > target_vertices:
            hi_res = res
        else:
            lo_res = res
        if hi_res - lo_res <= 1:
            break
    n, inv = best
    # Cluster centroid positions.
    acc = np.zeros((n, 3), np.float64)
    cnt = np.zeros(n, np.float64)
    np.add.at(acc, inv, vertices)
    np.add.at(cnt, inv, 1.0)
    new_vertices = (acc / cnt[:, None]).astype(np.float32)
    new_faces = inv[faces]
    return clean_mesh(new_vertices, new_faces)


def face_normals(vertices: np.ndarray, faces: np.ndarray, normalized=True):
    v0 = vertices[faces[:, 0]]
    n = np.cross(vertices[faces[:, 1]] - v0, vertices[faces[:, 2]] - v0)
    if normalized:
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return n


def vertex_normals(vertices: np.ndarray, faces: np.ndarray):
    fn = face_normals(vertices, faces, normalized=False)  # area-weighted
    vn = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)


def merge_meshes(meshes: list[tuple[np.ndarray, np.ndarray]]):
    """Concatenate (vertices, faces) lists into one mesh."""
    vs, fs, off = [], [], 0
    for v, f in meshes:
        vs.append(v)
        fs.append(f + off)
        off += len(v)
    if not vs:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    return np.concatenate(vs), np.concatenate(fs)
