"""Evaluation entry point — the reference's metrics.py protocol
(PSNR/SSIM[/LPIPS] on the every-8th-image test split) over all three
evaluated objects; the port of ``scripts/metrics.py``:

- ``--checkpoint``     gaussian PLY (vanilla / coarse / refined-exported)
- ``--refined_state``  refined hybrid ``_state.pkl`` (bound Gaussians
                       rendered through ``render_bound``; reference
                       metrics.py:283-292)
- ``--textured_obj``   UV-textured OBJ render (mesh rasterizer + texel
                       lookup, the texture PNG read by ``io/png.py``;
                       reference metrics.py:292-300 via MeshRasterizer +
                       TexturesUV)

Each given object adds one row to the output JSON.

    python -m sugar_tpu_torch.scripts.metrics --scene_path <scene> --checkpoint <ply>
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np
import torch

from sugar_tpu_torch.eval.metrics import evaluate_renders, write_metrics_json
from sugar_tpu_torch.eval.parity import _adaptive_renderer
from sugar_tpu_torch.io.obj import load_obj
from sugar_tpu_torch.io.png import read_png
from sugar_tpu_torch.models import gaussians as gm
from sugar_tpu_torch.pipeline import PipelineConfig, load_scene
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.refine.texture import render_textured_mesh
from sugar_tpu_torch.refine.trainer import load_refined_state, render_bound


def main(argv=None, device="cuda") -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--scene_path", required=True)
    p.add_argument("--checkpoint", default=None, help="gaussian PLY to evaluate")
    p.add_argument("--refined_state", default=None, help="refined _state.pkl")
    p.add_argument("--textured_obj", default=None, help="textured mesh OBJ")
    p.add_argument("--output", default="./output/metrics/results.json")
    p.add_argument("--lpips_weights", default=None)
    p.add_argument(
        "--white_background", action="store_true",
        help="render refined state over a white background (match scenes "
        "trained with white_background, e.g. NeRF-synthetic)",
    )
    args = p.parse_args(argv)
    if not (args.checkpoint or args.refined_state or args.textured_obj):
        p.error("give at least one of --checkpoint / --refined_state / --textured_obj")

    scene = load_scene(PipelineConfig(scene_path=args.scene_path), device=device)
    _, test_idx = scene.split(True)
    results = {}

    if args.checkpoint:
        model = gm.load_ply(args.checkpoint, device=device)
        render = _adaptive_renderer(
            model, "auto",
            adaptive.RasterCaps(tile_cap=16, dup_capacity=8 * model.capacity, k_max=1024),
        )
        results["gaussians"] = evaluate_renders(
            lambda i: render(scene.cameras[i])["image"], scene.images, test_idx,
            args.lpips_weights,
        )

    if args.refined_state:
        params, bm = load_refined_state(args.refined_state, device=device)
        sh_degree = int(round(np.sqrt(params.sh_rest.shape[-1] + 1))) - 1
        bg = torch.full((3,), 1.0 if args.white_background else 0.0, device=device)
        # Adaptive no-clipping protocol (eval/parity): start from
        # model-sized caps and grow until every overflow counter is zero,
        # so metrics can never understate quality to silent clipping.
        n_bound = int(params.opacity_logit.shape[0])
        caps_box = {"caps": adaptive.RasterCaps(tile_cap=16, dup_capacity=max(2**21, 8 * n_bound),
                                                k_max=1024)}
        render_fn = functools.partial(render_bound, active_sh_degree=sh_degree, bg=bg)

        @torch.no_grad()
        def render_refined(i):
            out, caps_box["caps"] = adaptive.render_adaptive(
                render_fn, caps_box["caps"], params, bm, scene.cameras[i])
            return out["image"]

        results["refined"] = evaluate_renders(
            render_refined, scene.images, test_idx, args.lpips_weights
        )

    if args.textured_obj:
        verts, faces, uvs, fuv = load_obj(args.textured_obj)
        if uvs is None or fuv is None:
            raise SystemExit(f"{args.textured_obj} has no UVs")
        # save_obj writes vt = (v, 1 - u) for atlas coords (u=row, v=col);
        # invert to recover the atlas layout render_textured_mesh expects.
        vt = uvs[fuv]  # (F, 3, 2) OBJ-convention
        verts_uv = np.stack([1.0 - vt[..., 1], vt[..., 0]], axis=-1)
        png = os.path.splitext(args.textured_obj)[0] + ".png"
        texture = read_png(png).astype(np.float32)[..., :3] / 255.0

        def render_textured(i):
            return render_textured_mesh(verts, faces, verts_uv, texture, scene.cameras[i])

        results["textured"] = evaluate_renders(
            render_textured, scene.images, test_idx, args.lpips_weights
        )

    scene_name = os.path.basename(os.path.normpath(args.scene_path))
    write_metrics_json(args.output, scene_name, results)
    print(
        json.dumps(
            {
                scene_name: {
                    obj: {k: v for k, v in r.items() if not k.startswith("per_")}
                    for obj, r in results.items()
                }
            },
            indent=2,
        )
    )
    return results


if __name__ == "__main__":
    main()
