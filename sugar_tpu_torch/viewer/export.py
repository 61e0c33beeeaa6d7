"""Web-viewer export contract.

Port of ``sugar_tpu/viewer/export.py`` (no change: it touches no array).
The reference ships a Three.js viewer (sugar_viewer/, README.md:304-343)
that consumes a triplet: refined-Gaussian .ply (3DGS format), textured .obj
and its .png, plus a ``scene_to_load.json`` descriptor written by
run_viewer.py (:26-47). The PLY/OBJ writers in sugar_tpu_torch.io emit the
byte-compatible formats; this module validates a triplet and writes the
descriptor so the reference viewer (or any @mkkellogg/gaussian-splats-3d
based viewer) can load scenes built by this package unchanged.
"""

from __future__ import annotations

import json
import os


def write_scene_descriptor(
    viewer_dir: str,
    ply_path: str,
    obj_path: str | None = None,
) -> str:
    """Validate artifacts + write sugar_viewer-style scene_to_load.json
    (run_viewer.py:26-47)."""
    if not os.path.exists(ply_path):
        raise FileNotFoundError(f"refined PLY not found: {ply_path}")
    png_path = None
    if obj_path is not None:
        if not os.path.exists(obj_path):
            raise FileNotFoundError(f"textured OBJ not found: {obj_path}")
        png_path = os.path.splitext(obj_path)[0] + ".png"
        if not os.path.exists(png_path):
            raise FileNotFoundError(f"texture PNG not found: {png_path}")
    os.makedirs(os.path.join(viewer_dir, "src"), exist_ok=True)
    desc = dict(
        ply=os.path.abspath(ply_path),
        obj=os.path.abspath(obj_path) if obj_path else None,
        png=os.path.abspath(png_path) if png_path else None,
    )
    out = os.path.join(viewer_dir, "src", "scene_to_load.json")
    with open(out, "w") as f:
        json.dump(desc, f, indent=2)
    return out
