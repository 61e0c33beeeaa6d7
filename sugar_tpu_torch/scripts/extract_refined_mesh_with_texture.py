"""Texture extraction entry point (the reference
extract_refined_mesh_with_texture.py); the port of
``scripts/extract_refined_mesh_with_texture.py``.

    python -m sugar_tpu_torch.scripts.extract_refined_mesh_with_texture \
        -s <scene> -m <refined_state.pkl> -o <textured.obj>
"""

from __future__ import annotations

import argparse

import numpy as np

from sugar_tpu_torch.pipeline import PipelineConfig, load_scene
from sugar_tpu_torch.refine.extract_textured import TextureConfig, extract_textured_mesh
from sugar_tpu_torch.refine.trainer import load_refined_state


def main(argv=None, device="cuda") -> str:
    p = argparse.ArgumentParser()
    p.add_argument("-s", "--scene_path", required=True)
    p.add_argument("-m", "--refined_state", required=True, help="*_state.pkl from refinement")
    p.add_argument("-o", "--output_obj", required=True)
    p.add_argument("--square_size", type=int, default=10)
    p.add_argument("--postprocess_mesh", action="store_true")
    args = p.parse_args(argv)

    params, bm = load_refined_state(args.refined_state, device=device)
    scene = load_scene(PipelineConfig(scene_path=args.scene_path), device=device)
    train_idx, _ = scene.split(True)
    sh_degree = int(round(np.sqrt(params.sh_rest.shape[-1] + 1))) - 1
    out = extract_textured_mesh(
        params, bm, [scene.cameras[i] for i in train_idx], args.output_obj,
        TextureConfig(square_size=args.square_size, postprocess_mesh=args.postprocess_mesh),
        sh_degree=sh_degree,
    )
    print("textured mesh:", out)
    return out


if __name__ == "__main__":
    main()
