"""Hybrid-representation walkthrough (the reference's
``view_sugar_results.ipynb``); the port of ``scripts/demo_hybrid.py``.

Given a refined state (``<refined>.ply`` beside ``<refined>_state.pkl``,
as the refine stage writes them), it

1. loads the mesh-bound Gaussians (``refine.trainer.load_refined_state``);
2. renders the hybrid representation from an orbit of cameras -> PNGs;
3. runs the compositor demo: the scene plus a rigidly moved copy of
   itself, rendered in ONE rasterizer call per frame while the copy spins
   (the SuGaRCompositor analog, sugar_scene/sugar_compositor.py:12-245);
4. writes everything under ``--out``.

    python -m sugar_tpu_torch.scripts.demo_hybrid --refined-ply out/refined.ply \
        --out ./output/hybrid_demo [--frames 8]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.core.sh import sh0_to_rgb
from sugar_tpu_torch.models.compositor import GaussianSet, composite_render
from sugar_tpu_torch.refine import bound as B
from sugar_tpu_torch.refine.trainer import load_refined_state
from sugar_tpu_torch.scripts.render import save_png


def orbit_cameras(center, radius, n, height=0.25, fov=0.9, res=256, device="cuda"):
    cams = []
    for i in range(n):
        th = 2 * np.pi * i / n
        fwd = -np.array([np.cos(th), height * np.sin(2 * th), np.sin(th)])
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        Rwc = np.stack([right, up2, fwd], 0)
        cam_center = np.asarray(center) - fwd * radius
        cams.append(make_camera(R=Rwc.T, T=-Rwc @ cam_center, fov_x=fov, fov_y=fov,
                                height=res, width=res, device=device))
    return cams


@torch.no_grad()
def run_demo(refined_ply: str, out_dir: str, n_frames: int = 8, resolution: int = 256,
             dup_capacity: int | None = None, k_max: int = 1024,
             device: str | torch.device = "cuda") -> dict:
    """Run the walkthrough on ``device``; returns the paths written, by
    kind (``hybrid``, ``composite``)."""
    os.makedirs(out_dir, exist_ok=True)
    params, bm = load_refined_state(refined_ply.replace(".ply", "_state.pkl"), device=device)
    ga = B.to_gaussian_arrays(params, bm)
    centers, scales, quats, opac = (ga["centers"], ga["scales"], ga["quaternions"],
                                    ga["opacities"])
    # Viewer-style precomputed colours: the SH DC term only.
    colors = torch.clamp(sh0_to_rgb(ga["sh"][:, :, 0]), 0.0, 1.0)
    if dup_capacity is None:
        dup_capacity = max(16 * centers.shape[0], 2**15)

    c = centers.mean(dim=0).cpu().numpy()
    r = 2.8 * float(torch.linalg.norm(centers - torch.as_tensor(c, device=centers.device),
                                      dim=-1).max())
    cams = orbit_cameras(c, r, n_frames, res=resolution, device=device)
    base = GaussianSet(centers=centers, scales=scales, quaternions=quats, opacities=opac,
                       colors=colors)

    written = dict(hybrid=[], composite=[])
    # 1. The hybrid render orbit.
    for i, cam in enumerate(cams):
        out = composite_render([base], cam, dup_capacity=dup_capacity, k_max=k_max)
        p = os.path.join(out_dir, f"hybrid_{i:03d}.png")
        save_png(p, out["image"])
        written["hybrid"].append(p)

    # 2. The compositor demo: the scene + a spinning, shifted copy of itself.
    offset = np.array([1.2 * r / 2.8, 0.0, 0.0], np.float32)
    for i, cam in enumerate(cams):
        th = 2 * np.pi * i / max(n_frames, 1)
        R = np.array(
            [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]], np.float32
        )
        copy = GaussianSet(
            centers=centers, scales=scales, quaternions=quats, opacities=opac, colors=colors,
            transform_R=torch.as_tensor(R, device=centers.device),
            transform_t=torch.as_tensor(c + offset - R @ c, device=centers.device),
        )
        out = composite_render([base, copy], cam, dup_capacity=2 * dup_capacity, k_max=k_max)
        p = os.path.join(out_dir, f"composite_{i:03d}.png")
        save_png(p, out["image"])
        written["composite"].append(p)
    return written


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--refined-ply", required=True,
                    help="refined .ply (with sibling _state.pkl)")
    ap.add_argument("--out", default="./output/hybrid_demo")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--k-max", type=int, default=1024)
    args = ap.parse_args(argv)
    written = run_demo(args.refined_ply, args.out, n_frames=args.frames,
                       resolution=args.resolution, k_max=args.k_max, device=device)
    print(f"wrote {sum(len(v) for v in written.values())} frames under {args.out}")
    return written


if __name__ == "__main__":
    main()
