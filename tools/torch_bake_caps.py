"""What the texture bake's fixed caps drop, on the parity scene.

``extract_textured_mesh`` renders each camera at the JAX package's fixed
caps (dup 2^21, k_max 1024) and ``bake_texture`` rasterizes the mesh at
``rasterize_mesh``'s default k_max 256, as the reference does; neither
grows a cap, so deep tiles drop splats and faces. This script runs
tests/test_parity.py's pipeline (``chip_smoke.parity_config``, the
scene of ``make_parity_scene``) up to the refined state, then bakes the
texture over the training cameras twice:

- ``fixed``: what ``run_texture`` bakes (the fixed caps), scored through
  ``render_textured_mesh`` at its default k_max;
- ``covering``: the renders through ``render_adaptive`` (the caps grow
  until nothing is dropped) and the rasterizer, in the bake and in the
  scoring, at a k_max that covers every camera's deepest tile.

Each texture is quantized as the PNG holds it and scored on the held-out
cameras. Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_bake_caps.py [--out DIR]

It prints the card line and one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the parity configuration, numpy + torch only)
from sugar_tpu_torch.eval.metrics import evaluate_renders  # noqa: E402
from sugar_tpu_torch.eval.parity import make_parity_scene  # noqa: E402
from sugar_tpu_torch.pipeline import run_coarse, run_extract_mesh, run_refine, run_vanilla  # noqa: E402
from sugar_tpu_torch.raster import adaptive  # noqa: E402
from sugar_tpu_torch.raster.tile_composite import C_CHUNK  # noqa: E402
from sugar_tpu_torch.refine import texture as texture_mod  # noqa: E402
from sugar_tpu_torch.refine.mesh_raster import rasterize_mesh  # noqa: E402
from sugar_tpu_torch.refine.trainer import load_refined_state, render_bound  # noqa: E402

FIXED = adaptive.RasterCaps(tile_cap=16, dup_capacity=chip_smoke.BAKE_DUP_CAPACITY,
                            k_max=chip_smoke.BAKE_K_MAX)


@contextlib.contextmanager
def bake_raster_k_max(k_max: int):
    """bake_texture's rasterize_mesh at another k_max inside the block."""
    orig = texture_mod.rasterize_mesh
    texture_mod.rasterize_mesh = functools.partial(orig, k_max=k_max)
    try:
        yield
    finally:
        texture_mod.rasterize_mesh = orig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "sugar_tpu_torch", "_build", "bake_caps"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bake_caps: this needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    scene, _ = make_parity_scene(n_gt=2_000, n_init=800, n_cams=16, resolution=96, k_max=512,
                                 device=dev)
    train_idx, test_idx = scene.split(True)
    shutil.rmtree(args.out, ignore_errors=True)
    cfg = chip_smoke.parity_config(args.out)

    def quiet(*_):
        return None

    art = run_vanilla(cfg, scene, log_fn=quiet)
    for stage in (run_coarse, run_extract_mesh, run_refine):
        art = stage(cfg, scene, art, log_fn=quiet)
    params, bm = load_refined_state(art.replace(".ply", "_state.pkl"), device=dev)
    sh = int(round(np.sqrt(params.sh_rest.shape[-1] + 1))) - 1
    train = [scene.cameras[i] for i in train_idx]
    bg = torch.zeros(3, device=dev)
    deepest = max(int(rasterize_mesh(params.vertices, bm.faces, cam)["tile_count_max"])
                  for cam in scene.cameras)
    k_cover = -(-deepest // C_CHUNK) * C_CHUNK
    verts, faces = params.vertices.cpu().numpy(), bm.faces.cpu().numpy()

    def mapped(k_max: int) -> int:
        return sum(int((rasterize_mesh(params.vertices, bm.faces, cam, k_max=k_max)["face_idx"]
                        >= 0).sum()) for cam in train)

    def score(tex, verts_uv, k_max: int) -> dict:
        tex = (np.clip(tex, 0, 1) * 255).astype(np.uint8).astype(np.float32) / 255.0
        r = evaluate_renders(lambda i: texture_mod.render_textured_mesh(
            verts, faces, verts_uv, tex, scene.cameras[i], k_max=k_max), scene.images, test_idx)
        return dict(psnr=r["psnr"], ssim=r["ssim"])

    dropped = []

    @torch.no_grad()
    def fixed_render(cam):
        out = render_bound(params, bm, cam, sh, bg, FIXED.dup_capacity, FIXED.k_max)
        dropped.append(adaptive.overflowed(adaptive.read_overflow(out)))
        return out["image"]

    state = {"caps": FIXED}

    @torch.no_grad()
    def covering_render(cam):
        out, state["caps"] = adaptive.render_adaptive(render_bound, state["caps"], params, bm, cam,
                                                      sh, bg)
        return out["image"]

    tex, verts_uv, _ = texture_mod.bake_texture(params, bm, train, fixed_render)
    fixed = score(tex, verts_uv, 256)
    with bake_raster_k_max(k_cover):
        tex, verts_uv, _ = texture_mod.bake_texture(params, bm, train, covering_render)
    covering = score(tex, verts_uv, k_cover)
    print(chip_smoke.card_line())
    print(json.dumps(dict(
        faces=len(faces), train_cameras=len(train), held_out=len(test_idx),
        deepest_raster_tile=deepest, fixed_render_dropped_cameras=sum(dropped),
        fixed=dict(raster_k_max=256, render_caps=[FIXED.dup_capacity, FIXED.k_max],
                   mapped_pixels=mapped(256), **fixed),
        covering=dict(raster_k_max=k_cover, render_caps=[state["caps"].dup_capacity,
                                                         state["caps"].k_max],
                      mapped_pixels=mapped(k_cover), **covering))))
    shutil.rmtree(args.out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
