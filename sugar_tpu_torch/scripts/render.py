"""Offline render of the train/test splits, the serving entry point (the
reference gaussian_splatting/render.py); the port of ``scripts/render.py``.
Writes ``<output_dir>/<split>/renders/*.png`` and ``.../gt/*.png``.

    python -m sugar_tpu_torch.scripts.render -s <scene> -c <point_cloud.ply>
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sugar_tpu_torch.io.png import write_png
from sugar_tpu_torch.models import gaussians as gm
from sugar_tpu_torch.models.render import render_model
from sugar_tpu_torch.pipeline import PipelineConfig, load_scene


def save_png(path: str, image) -> None:
    """An (H, W, 3) float image in [0, 1] (tensor or array) as an 8-bit PNG."""
    arr = image.detach().cpu().numpy() if hasattr(image, "detach") else np.asarray(image)
    write_png(path, (np.clip(arr, 0, 1) * 255).astype(np.uint8))


def main(argv=None, device="cuda") -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-s", "--scene_path", required=True)
    p.add_argument("-c", "--checkpoint", required=True)
    p.add_argument("-o", "--output_dir", default="./output/renders")
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    args = p.parse_args(argv)

    scene = load_scene(PipelineConfig(scene_path=args.scene_path), device=device)
    model = gm.load_ply(args.checkpoint, device=device)
    train_idx, test_idx = scene.split(True)
    jobs = []
    if not args.skip_train:
        jobs.append(("train", train_idx))
    if not args.skip_test:
        jobs.append(("test", test_idx))
    written = {}
    for split, indices in jobs:
        rdir = os.path.join(args.output_dir, split, "renders")
        gdir = os.path.join(args.output_dir, split, "gt")
        os.makedirs(rdir, exist_ok=True)
        os.makedirs(gdir, exist_ok=True)
        for k, i in enumerate(indices):
            save_png(os.path.join(rdir, f"{k:05d}.png"),
                     render_model(model, scene.cameras[i])["image"])
            save_png(os.path.join(gdir, f"{k:05d}.png"), scene.images[i])
        written[split] = rdir
        print(f"{split}: {len(indices)} images -> {rdir}")
    return written


if __name__ == "__main__":
    main()
