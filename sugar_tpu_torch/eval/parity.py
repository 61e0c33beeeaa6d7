"""Quality-parity gate on a procedurally generated multi-view scene.

Port of ``sugar_tpu/eval/parity.py``. No real dataset ships with the repo,
so the quality gates are exercised on a synthetic scene whose ground truth
is rendered by the same forward model: a star-shaped blob of surface
Gaussians viewed from a sphere of cameras. The pipeline trains from a
degraded point-cloud init (noisy subsample, gray colors) through vanilla
-> coarse-SDF -> mesh -> refine, and PSNR/SSIM are recorded per stage on
the every-8th held-out split (the reference's split, gs_model.py:133-143).

The numpy draws are the JAX package's, call for call, so both packages
build the same scene. The scene lives on ``device``, and
:func:`eval_gaussian_ply` renders on the scene's cameras' device.
``render_mode`` defaults to ``"auto"`` (the fused path), where the JAX
package defaults to its ``"tiled"`` oracle mode; the port renders that
mode too when asked.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import Camera, make_camera
from sugar_tpu_torch.eval.metrics import evaluate_renders
from sugar_tpu_torch.io.datasets import SceneData
from sugar_tpu_torch.models import gaussians as gm
from sugar_tpu_torch.models.render import render_model
from sugar_tpu_torch.raster import adaptive


def _fibonacci_sphere(n: int) -> np.ndarray:
    """(n, 3) unit directions, near-uniform (spiral) coverage."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)], -1
    )


def blob_surface(d: np.ndarray) -> np.ndarray:
    """Star-shaped radius field r(direction): smooth bumpy blob."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    return (
        0.72
        + 0.11 * np.sin(3.0 * x + 1.0) * np.sin(2.0 * y)
        + 0.07 * np.cos(4.0 * z)
        + 0.05 * np.sin(5.0 * y + 2.0)
    )


def blob_colors(p: np.ndarray) -> np.ndarray:
    c = 0.5 + 0.45 * np.stack(
        [
            np.sin(3.1 * p[:, 0] + 0.3),
            np.sin(2.7 * p[:, 1] + 1.7),
            np.sin(3.7 * p[:, 2] + 3.1),
        ],
        -1,
    )
    return np.clip(c, 0.02, 1.0).astype(np.float32)


def make_gt_model(n_points: int, seed: int = 0, device: str | torch.device = "cuda") -> gm.GaussianModel:
    g = np.random.default_rng(seed)
    d = g.normal(size=(n_points, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = (d * blob_surface(d)[:, None]).astype(np.float32)
    return gm.create_from_pcd(
        pts, blob_colors(pts), capacity=n_points, sh_degree=0, initial_opacity=0.95,
        device=device,
    )


def make_cameras(
    n_cams: int, resolution: int = 256, radius: float = 2.6, fov: float = 0.9,
    device: str | torch.device = "cuda",
) -> list[Camera]:
    cams = []
    for pos_dir in _fibonacci_sphere(n_cams):
        center = pos_dir * radius
        fwd = -pos_dir  # look at origin
        up = np.array([0.0, 1.0, 0.0])
        if abs(np.dot(up, fwd)) > 0.95:
            up = np.array([1.0, 0.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        Rwc = np.stack([right, up2, fwd], 0)
        T = -Rwc @ center
        cams.append(
            make_camera(
                R=Rwc.T, T=T, fov_x=fov, fov_y=fov,
                height=resolution, width=resolution, device=device,
            )
        )
    return cams


def make_parity_scene(
    n_gt: int = 60_000,
    n_init: int = 15_000,
    n_cams: int = 80,
    resolution: int = 256,
    seed: int = 0,
    render_mode: str = "auto",
    dup_capacity: int | None = None,
    k_max: int = 1024,
    device: str | torch.device = "cuda",
) -> tuple[SceneData, gm.GaussianModel]:
    """GT model + SceneData with rendered GT images (numpy) and a degraded
    init, the cameras and the model on ``device``."""
    target = make_gt_model(n_gt, seed=seed, device=device)
    cams = make_cameras(n_cams, resolution=resolution, device=device)
    caps = adaptive.RasterCaps(
        tile_cap=16,
        dup_capacity=dup_capacity if dup_capacity is not None else 8 * n_gt,
        k_max=k_max,
    )
    # Exact (overflow-free) GT renders through the auto-grow protocol.
    render = _adaptive_renderer(target, render_mode, caps)
    images = [torch.clamp(render(cam)["image"], 0.0, 1.0).cpu().numpy() for cam in cams]

    # Degraded init: noisy subsample with flat gray colors — what a sparse
    # SfM point cloud gives the reference pipeline.
    g = np.random.default_rng(seed + 1)
    sel = g.choice(n_gt, size=min(n_init, n_gt), replace=False)
    pts = target.params.xyz.cpu().numpy()[sel]
    pts = (pts + 0.06 * g.normal(size=pts.shape)).astype(np.float32)

    centers = np.stack([c.cam_center.cpu().numpy() for c in cams])
    extent = 1.1 * float(
        np.max(np.linalg.norm(centers - centers.mean(0, keepdims=True), axis=-1))
    )
    scene = SceneData(
        cameras=cams,
        images=images,
        image_names=[f"r_{i}" for i in range(n_cams)],
        points=pts,
        colors=np.full((len(pts), 3), 0.5, np.float32),
        extent=extent,
    )
    return scene, target


def _adaptive_renderer(model: gm.GaussianModel, mode: str, caps: adaptive.RasterCaps):
    """render(camera) -> output dict with every overflow counter zero: the
    caps grow (and the view renders again) until nothing is dropped, and
    the grown caps carry over to the next camera."""
    state = {"caps": caps}
    render_fn = functools.partial(render_model, mode=mode)

    @torch.no_grad()
    def render(camera):
        out, state["caps"] = adaptive.render_adaptive(render_fn, state["caps"], model, camera)
        return out

    return render


def eval_gaussian_ply(
    ply_path: str,
    scene: SceneData,
    indices: list[int],
    render_mode: str = "auto",
    dup_capacity: int | None = None,
    k_max: int = 1024,
) -> dict:
    """PSNR/SSIM of a gaussian PLY on the given camera indices, rendered on
    the scene's cameras' device.

    Renders through the capacity auto-grow protocol (raster.adaptive) and
    asserts zero overflow, so scores measure model quality, never silent
    per-tile clipping (a refined surface model at 3 Gaussians/triangle can
    exceed a fixed k_max and lose PSNR to clipping). ``dup_capacity`` /
    ``k_max`` are starting capacities only."""
    model = gm.load_ply(ply_path, device=scene.cameras[0].world_view.device)
    if dup_capacity is None:
        dup_capacity = 8 * model.capacity
    render = _adaptive_renderer(
        model, render_mode,
        adaptive.RasterCaps(tile_cap=16, dup_capacity=dup_capacity, k_max=k_max),
    )

    def render_fn(i):
        return render(scene.cameras[i])["image"]

    return evaluate_renders(render_fn, scene.images, indices)
