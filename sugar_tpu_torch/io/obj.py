"""Wavefront OBJ + MTL + texture export/import.

Port of ``sugar_tpu/io/obj.py`` (the reference's PyTorch3D save_obj /
load_objs_as_meshes contract, sugar_extractors/refined_mesh.py:211-219,
run_viewer.py:26-36): an .obj with per-face UV indices and an .mtl naming
the texture .png. The .obj and .mtl text is byte-equal to the JAX
package's for the same arrays; the texture is written by ``io/png.py``
(no Pillow) and decodes to the same uint8 array as the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np

from sugar_tpu_torch.io.png import write_png


def save_obj(
    path: str,
    vertices: np.ndarray,  # (V, 3)
    faces: np.ndarray,  # (F, 3) int
    verts_uv: np.ndarray | None = None,  # (F, 3, 2) per-face-corner UVs
    texture: np.ndarray | None = None,  # (S, S, 3) float [0,1]
) -> None:
    base = os.path.splitext(path)[0]
    name = os.path.basename(base)
    mtl_path = base + ".mtl"
    png_path = base + ".png"

    lines = []
    if texture is not None:
        lines.append(f"mtllib {os.path.basename(mtl_path)}")
    for v in vertices:
        lines.append(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}")
    if verts_uv is not None:
        # OBJ v-coordinate is flipped relative to image rows.
        for fuv in verts_uv.reshape(-1, 2):
            lines.append(f"vt {fuv[1]:.8f} {1.0 - fuv[0]:.8f}")
    if texture is not None:
        lines.append(f"usemtl {name}")
    for i, f in enumerate(faces):
        if verts_uv is not None:
            t = 3 * i
            lines.append(
                f"f {f[0] + 1}/{t + 1} {f[1] + 1}/{t + 2} {f[2] + 1}/{t + 3}"
            )
        else:
            lines.append(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")

    if texture is not None:
        write_png(png_path, (np.clip(texture, 0, 1) * 255).astype(np.uint8))
        with open(mtl_path, "w") as fh:
            fh.write(
                f"newmtl {name}\nKa 1.0 1.0 1.0\nKd 1.0 1.0 1.0\n"
                f"Ks 0.0 0.0 0.0\nmap_Kd {os.path.basename(png_path)}\n"
            )


def load_obj(path: str):
    """Returns (vertices (V,3), faces (F,3), uvs (T,2) or None,
    face_uv_idx (F,3) or None)."""
    verts, uvs, faces, fuv = [], [], [], []
    with open(path) as fh:
        for line in fh:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
            elif t[0] == "vt":
                uvs.append([float(x) for x in t[1:3]])
            elif t[0] == "f":
                vi, ti = [], []
                for tok in t[1:4]:
                    parts = tok.split("/")
                    vi.append(int(parts[0]) - 1)
                    if len(parts) > 1 and parts[1]:
                        ti.append(int(parts[1]) - 1)
                faces.append(vi)
                if len(ti) == 3:
                    fuv.append(ti)
    return (
        np.array(verts, np.float32),
        np.array(faces, np.int64),
        np.array(uvs, np.float32) if uvs else None,
        np.array(fuv, np.int64) if fuv else None,
    )
