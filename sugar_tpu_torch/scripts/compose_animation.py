"""Animated scene composition: a Blender-exported camera trajectory and
per-frame rigid transforms -> composited frames; the port of
``scripts/compose_animation.py`` (the reference's sugar_compositor flow,
sugar_scene/sugar_compositor.py:12-245 + blender/*.py exports).

Each Gaussian PLY is one component; frame f applies transforms[f][k] to
component k and renders every component through ONE rasterizer call
(occlusion between models resolved per pixel), then writes a PNG.

    python -m sugar_tpu_torch.scripts.compose_animation --ply scene.ply \
        --ply character.ply --trajectory camera_traj.json \
        [--animation anims.json] --height 512 --width 512 -o ./frames
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from sugar_tpu_torch.core import sh as sh_lib
from sugar_tpu_torch.io.blender_interop import load_animation_transforms, load_camera_trajectory
from sugar_tpu_torch.models import gaussians as gm
from sugar_tpu_torch.models.compositor import GaussianSet, composite_render
from sugar_tpu_torch.scripts.render import save_png


def set_from_ply(path: str, device: str | torch.device = "cuda") -> GaussianSet:
    model = gm.load_ply(path, device=device)
    return GaussianSet(
        centers=model.params.xyz,
        scales=model.scales,
        quaternions=model.quaternions,
        opacities=model.opacities,
        colors=torch.clamp(sh_lib.sh0_to_rgb(model.params.sh_dc), 0.0, 1.0),
        mask=model.alive,
    )


@torch.no_grad()
def main(argv=None, device="cuda") -> list[str]:
    p = argparse.ArgumentParser()
    p.add_argument("--ply", action="append", required=True,
                   help="gaussian PLY; repeat for multiple components")
    p.add_argument("--trajectory", required=True, help="Blender camera-trajectory JSON")
    p.add_argument("--animation", default=None,
                   help="per-frame rigid-transform JSON (frames x components)")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("-o", "--output_dir", default="./frames")
    p.add_argument("--k_max", type=int, default=1024)
    args = p.parse_args(argv)

    base_sets = [set_from_ply(path, device) for path in args.ply]
    cams = load_camera_trajectory(args.trajectory, args.height, args.width, device=device)
    anims = load_animation_transforms(args.animation) if args.animation else None
    if anims is not None:
        # Validate up front: a short frame entry would otherwise fail
        # mid-render, after frames were written.
        for f, tr in enumerate(anims):
            if len(tr) != len(base_sets):
                raise SystemExit(
                    f"animation frame {f} has {len(tr)} transforms but "
                    f"{len(base_sets)} --ply components were given"
                )
    os.makedirs(args.output_dir, exist_ok=True)

    paths = []
    for f, cam in enumerate(cams):
        sets = base_sets
        if anims is not None:
            tr = anims[min(f, len(anims) - 1)]
            sets = [
                dataclasses.replace(
                    s,
                    transform_R=torch.as_tensor(tr[k]["R"], device=device),
                    transform_t=torch.as_tensor(tr[k]["t"], device=device),
                )
                for k, s in enumerate(base_sets)
            ]
        out = composite_render(sets, cam, k_max=args.k_max)
        path = os.path.join(args.output_dir, f"frame_{f:05d}.png")
        save_png(path, out["image"])
        paths.append(path)
        print(path, flush=True)
    return paths


if __name__ == "__main__":
    main()
