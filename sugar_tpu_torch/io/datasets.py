"""Scene/dataset loading: COLMAP scenes, NeRF-synthetic (Blender), and 3DGS
``cameras.json`` checkpoints.

Covers the reference's dataset_readers.py (:45-259), scene/__init__.py
(:21-93) and sugar_scene/cameras.py:15-139 behavior: camera construction,
train/eval split (every 8th image, gs_model.py:133-143), nerf++ spatial
extent, white-background compositing for synthetic scenes, and the
max-1920px downscale cap (sugar_scene/cameras.py:25, 113-116).

Port of ``sugar_tpu/io/datasets.py``: the same numpy parsing, with the
cameras built by the port's ``make_camera`` on ``device``. Images stay
(H, W, 3) float32 numpy arrays, as the trainers take them. Pillow is
imported only inside the image helpers.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

import torch

from sugar_tpu_torch.core.cameras import Camera, make_camera
from sugar_tpu_torch.core.transforms import focal2fov, fov2focal
from sugar_tpu_torch.io import colmap as colmap_io


@dataclasses.dataclass
class SceneData:
    cameras: list[Camera]
    images: list[np.ndarray] | None  # (H, W, 3) float32 in [0,1] per camera
    image_names: list[str]
    points: np.ndarray | None  # (N, 3)
    colors: np.ndarray | None  # (N, 3) float in [0,1]
    extent: float  # nerf++ camera extent

    def split(self, eval_split: bool = True, llffhold: int = 8):
        """(train_idx, test_idx) — every llffhold-th camera held out."""
        n = len(self.cameras)
        if not eval_split:
            return list(range(n)), []
        test = list(range(0, n, llffhold))
        train = [i for i in range(n) if i % llffhold != 0]
        return train, test


def _load_image(path: str, white_background: bool = False) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        bg = 1.0 if white_background else 0.0
        arr = arr[..., :3] * arr[..., 3:4] + bg * (1 - arr[..., 3:4])
    return arr[..., :3]


def _resize_image(arr: np.ndarray, wh: tuple[int, int]) -> np.ndarray:
    from PIL import Image

    img = Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))
    img = img.resize(wh, Image.LANCZOS)
    return np.asarray(img).astype(np.float32) / 255.0


def _downscale_factor(w: int, h: int, resolution_factor: int, max_img_size: int) -> float:
    f = float(resolution_factor) if resolution_factor in (1, 2, 4, 8) else 1.0
    if max(h / f, w / f) > max_img_size:
        f *= max(h / f, w / f) / max_img_size
    return f


def nerfpp_extent(cam_centers: np.ndarray) -> float:
    """nerf++ normalization radius (dataset_readers.py:45-66)."""
    center = cam_centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(cam_centers - center, axis=-1)
    return float(1.1 * dist.max())


def load_colmap_scene(
    source_path: str,
    resolution_factor: int = 1,
    max_img_size: int = 1920,
    load_images: bool = True,
    images_dir: str = "images",
    device: str | torch.device = "cuda",
) -> SceneData:
    """Load a COLMAP scene (sparse/0 + images), cameras on ``device``."""
    sparse = os.path.join(source_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    cams, imgs, (xyz, rgb, _err) = colmap_io.read_model(sparse)

    entries = sorted(imgs.values(), key=lambda im: im.name)
    cameras, images, names, centers = [], [], [], []
    for im in entries:
        cam = cams[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
            cx, cy = cam.params[1], cam.params[2]
        elif cam.model == "PINHOLE":
            fx, fy, cx, cy = cam.params[:4]
        else:
            raise ValueError(
                f"Camera model {cam.model} not supported (undistort with "
                "COLMAP first, as the reference's convert.py does)"
            )
        w, h = cam.width, cam.height
        f = _downscale_factor(w, h, resolution_factor, max_img_size)
        tw, th = round(w / f), round(h / f)
        sx, sy = tw / w, th / h

        Rwc = colmap_io.qvec2rotmat(im.qvec)  # world-to-cam
        cameras.append(
            make_camera(
                R=Rwc.T,
                T=im.tvec,
                fov_x=focal2fov(fx, w),
                fov_y=focal2fov(fy, h),
                height=th,
                width=tw,
                cx=cx * sx,
                cy=cy * sy,
                device=device,
            )
        )
        centers.append(-Rwc.T @ im.tvec)
        names.append(im.name)
        if load_images:
            arr = _load_image(os.path.join(source_path, images_dir, im.name))
            if (tw, th) != (w, h):
                arr = _resize_image(arr, (tw, th))
            images.append(arr)

    return SceneData(
        cameras=cameras,
        images=images if load_images else None,
        image_names=names,
        points=xyz.astype(np.float32),
        colors=rgb.astype(np.float32) / 255.0,
        extent=nerfpp_extent(np.stack(centers)),
    )


def load_blender_scene(
    source_path: str,
    split: str = "train",
    white_background: bool = True,
    resolution_factor: int = 1,
    max_img_size: int = 1920,
    load_images: bool = True,
    device: str | torch.device = "cuda",
) -> SceneData:
    """Load a NeRF-synthetic scene (transforms_{split}.json,
    dataset_readers.py readNerfSyntheticInfo semantics), cameras on
    ``device``."""
    with open(os.path.join(source_path, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]

    cameras, images, names, centers = [], [], [], []
    for frame in meta["frames"]:
        c2w = np.array(frame["transform_matrix"], np.float64)
        # Blender (Y up, Z back) -> COLMAP (Y down, Z forward).
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        Rwc, t = w2c[:3, :3], w2c[:3, 3]

        name = frame["file_path"]
        img_path = os.path.join(source_path, name + (".png" if not name.endswith(".png") else ""))
        arr = _load_image(img_path, white_background=white_background)
        h, w = arr.shape[:2]
        f = _downscale_factor(w, h, resolution_factor, max_img_size)
        tw, th = round(w / f), round(h / f)
        if (tw, th) != (w, h):
            arr = _resize_image(arr, (tw, th))
        fovy = focal2fov(fov2focal(fovx, w), h)
        cameras.append(
            make_camera(R=Rwc.T, T=t, fov_x=fovx, fov_y=fovy, height=th, width=tw,
                        device=device)
        )
        centers.append(c2w[:3, 3])
        names.append(os.path.basename(name))
        if load_images:
            images.append(arr)

    # Random init points in [-1.3, 1.3]^3 like the reference (3DGS
    # dataset_readers readNerfSyntheticInfo) — caller may replace.
    g = np.random.default_rng(0)
    n_pts = 100_000
    pts = (g.random((n_pts, 3), np.float32) * 2.6 - 1.3).astype(np.float32)
    cols = g.random((n_pts, 3)).astype(np.float32)

    return SceneData(
        cameras=cameras,
        images=images if load_images else None,
        image_names=names,
        points=pts,
        colors=cols,
        extent=nerfpp_extent(np.stack(centers)),
    )


def load_gs_checkpoint_cameras(
    source_path: str,
    gs_output_path: str,
    resolution_factor: int = 1,
    max_img_size: int = 1920,
    load_images: bool = True,
    white_background: bool = False,
    device: str | torch.device = "cuda",
) -> SceneData:
    """Load cameras from a trained-3DGS checkpoint's cameras.json
    (sugar_scene/cameras.py:15-139), on ``device``: entries sorted by
    img_name; rotation and position are C2W."""
    with open(os.path.join(gs_output_path, "cameras.json")) as f:
        cam_json = json.load(f)
    # De-dup by name keeping the last, then sort (cameras.py:47-63).
    by_name = {c["img_name"]: c for c in cam_json}
    entries = sorted(by_name.values(), key=lambda c: c["img_name"])

    image_dir = os.path.join(source_path, "images")
    ext = ""
    if os.path.isdir(image_dir):
        listing = os.listdir(image_dir)
        if listing:
            ext = "." + listing[0].split(".")[-1]

    cameras, images, names, centers = [], [], [], []
    for c in entries:
        rot = np.array(c["rotation"], np.float64)  # C2W rotation
        pos = np.array(c["position"], np.float64)
        C2W = np.eye(4)
        C2W[:3, :3] = rot
        C2W[:3, 3] = pos
        Rt = np.linalg.inv(C2W)
        T = Rt[:3, 3]
        Rwc = Rt[:3, :3]

        w, h = c["width"], c["height"]
        fov_x = focal2fov(c["fx"], w)
        fov_y = focal2fov(c["fy"], h)
        f = _downscale_factor(w, h, resolution_factor, max_img_size)
        tw, th = round(w / f), round(h / f)
        cameras.append(
            make_camera(R=Rwc.T, T=T, fov_x=fov_x, fov_y=fov_y, height=th, width=tw,
                        device=device)
        )
        centers.append(pos)
        names.append(c["img_name"])
        if load_images:
            arr = _load_image(
                os.path.join(image_dir, c["img_name"] + ext), white_background
            )
            if arr.shape[:2] != (th, tw):
                arr = _resize_image(arr, (tw, th))
            images.append(arr)

    return SceneData(
        cameras=cameras,
        images=images if load_images else None,
        image_names=names,
        points=None,
        colors=None,
        extent=nerfpp_extent(np.stack(centers)),
    )


def camera_to_json(idx: int, cam: Camera, name: str) -> dict:
    """Inverse of load_gs_checkpoint_cameras entry (3DGS camera_to_JSON)."""
    w2c = cam.world_view.cpu().numpy()
    c2w = np.linalg.inv(w2c)
    return dict(
        id=idx,
        img_name=name,
        width=cam.width,
        height=cam.height,
        position=c2w[:3, 3].tolist(),
        rotation=c2w[:3, :3].tolist(),
        fx=fov2focal(2 * np.arctan(cam.tan_half_fov_x), cam.width),
        fy=fov2focal(2 * np.arctan(cam.tan_half_fov_y), cam.height),
    )


def save_cameras_json(path: str, cameras: list[Camera], names: list[str]) -> None:
    with open(path, "w") as f:
        json.dump([camera_to_json(i, c, n) for i, (c, n) in enumerate(zip(cameras, names))], f)
