"""COLMAP reconstruction parsers (binary + text), no external deps.

A copy of ``sugar_tpu/io/colmap.py`` (numpy only), so the port needs
nothing of the JAX package; only :func:`read_images_text` differs, reading
an image whose 2D-point line is empty as the reference does. Replaces the
reference's ``gaussian_splatting/scene/colmap_loader.py`` (:1-294): reads
cameras/images/points3D in both ``.bin`` and ``.txt`` forms.
Only the data needed by the pipeline is retained.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME_TO_ID = {v[0]: k for k, v in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{np_}d"))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "<Q")
            f.seek(24 * n2d, os.SEEK_CUR)  # skip (x, y, point3D_id) per 2D point
            out[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name.decode("utf-8"))
    return out


def read_points3d_binary(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz (N,3) f64, rgb (N,3) u8, error (N,))."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            vals = _read(f, "<QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (tlen,) = _read(f, "<Q")
            f.seek(8 * tlen, os.SEEK_CUR)
    return xyz, rgb, err


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cam_id = int(tok[0])
            out[cam_id] = ColmapCamera(
                cam_id, tok[1], int(tok[2]), int(tok[3]), np.array([float(x) for x in tok[4:]])
            )
    return out


def read_images_text(path: str) -> dict[int, ColmapImage]:
    """Each image is two lines: its pose, then its 2D points. The points
    line may be empty (COLMAP and :func:`write_images_text` leave it empty
    for an image without observations), so it is skipped whatever it holds,
    as the reference's ``read_extrinsics_text`` does. The JAX package drops
    every blank line first, so there an empty points line takes the next
    image's pose line with it."""
    out = {}
    with open(path) as f:
        lines = iter(f.readlines())
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        image_id = int(tok[0])
        qvec = np.array([float(x) for x in tok[1:5]])
        tvec = np.array([float(x) for x in tok[5:8]])
        out[image_id] = ColmapImage(image_id, qvec, tvec, int(tok[8]), tok[9])
        next(lines, None)  # the 2D points
    return out


def read_points3d_text(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            xyz.append([float(x) for x in tok[1:4]])
            rgb.append([int(x) for x in tok[4:7]])
            err.append(float(tok[7]))
    return (
        np.array(xyz, np.float64).reshape(-1, 3),
        np.array(rgb, np.uint8).reshape(-1, 3),
        np.array(err),
    )


def read_model(sparse_dir: str):
    """Auto-detect binary vs text model in a COLMAP sparse dir."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
        pts = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, pts


def write_cameras_text(path: str, cams: dict[int, ColmapCamera]) -> None:
    with open(path, "w") as f:
        for c in cams.values():
            p = " ".join(str(x) for x in c.params)
            f.write(f"{c.camera_id} {c.model} {c.width} {c.height} {p}\n")


def write_images_text(path: str, imgs: dict[int, ColmapImage]) -> None:
    with open(path, "w") as f:
        for im in imgs.values():
            q = " ".join(str(x) for x in im.qvec)
            t = " ".join(str(x) for x in im.tvec)
            f.write(f"{im.image_id} {q} {t} {im.camera_id} {im.name}\n\n")


def write_points3d_text(path: str, xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray | None = None) -> None:
    err = err if err is not None else np.zeros(len(xyz))
    with open(path, "w") as f:
        for i in range(len(xyz)):
            f.write(
                f"{i + 1} {xyz[i, 0]} {xyz[i, 1]} {xyz[i, 2]} "
                f"{int(rgb[i, 0])} {int(rgb[i, 1])} {int(rgb[i, 2])} {err[i]}\n"
            )
