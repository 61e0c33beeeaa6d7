"""Blender interop: import camera trajectories / animation data.

Port of ``sugar_tpu/io/blender_interop.py``. The reference ships Blender
export scripts (blender/*.py) that write JSON: camera trajectories
(export_camera_trajectory.py:25-41, per-frame matrix_world + lens) and
posed bone/vertex data for the compositor's animation path. This module
reads those files into the port's Camera objects (on ``device``) and
per-frame rigid transforms.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import Camera, make_camera
from sugar_tpu_torch.core.transforms import focal2fov


def load_camera_trajectory(
    path: str,
    height: int,
    width: int,
    sensor_width_mm: float = 36.0,
    device: str | torch.device = "cuda",
) -> list[Camera]:
    """Read a Blender-exported trajectory JSON: list of frames with
    ``matrix_world`` (camera-to-world, Blender axes) and ``lens`` (focal in
    mm). Returns render cameras in COLMAP convention."""
    with open(path) as f:
        data = json.load(f)
    frames = data["frames"] if isinstance(data, dict) and "frames" in data else data
    cams = []
    for fr in frames:
        c2w = np.array(fr["matrix_world"], np.float64).reshape(4, 4)
        # Blender camera looks down -Z with +Y up -> COLMAP (+Z fwd, -Y up).
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        lens = float(fr.get("lens", 50.0))
        fov_x = 2.0 * np.arctan(sensor_width_mm / (2.0 * lens))
        focal_px = width / (2.0 * np.tan(fov_x / 2.0))
        fov_y = focal2fov(focal_px, height)
        cams.append(
            make_camera(
                R=w2c[:3, :3].T,
                T=w2c[:3, 3],
                fov_x=fov_x,
                fov_y=fov_y,
                height=height,
                width=width,
                device=device,
            )
        )
    return cams


def load_animation_transforms(path: str) -> list[list[dict]]:
    """Read per-frame rigid transforms for compositor animation: list of
    frames, each a list of {'R': 3x3, 't': 3} dicts (one per composited
    model)."""
    with open(path) as f:
        data = json.load(f)
    out = []
    for frame in data:
        entries = []
        for e in frame:
            entries.append(
                dict(
                    R=np.array(e["R"], np.float32).reshape(3, 3),
                    t=np.array(e.get("t", [0, 0, 0]), np.float32),
                )
            )
        out.append(entries)
    return out
