"""Coarse mesh extraction entry point (the reference extract_mesh.py
surface); the port of ``scripts/extract_mesh.py``.

    python -m sugar_tpu_torch.scripts.extract_mesh -s <scene> -c <coarse.ply>
"""

from __future__ import annotations

import argparse

from sugar_tpu_torch.pipeline import PipelineConfig, load_scene, run_extract_mesh


def main(argv=None, device="cuda") -> str:
    p = argparse.ArgumentParser()
    p.add_argument("-s", "--scene_path", required=True)
    p.add_argument("-c", "--coarse_model_path", required=True)
    p.add_argument("-o", "--output_dir", default="./output")
    p.add_argument("-l", "--surface_level", type=float, default=0.3)
    p.add_argument("-d", "--decimation_target", type=int, default=1_000_000)
    args = p.parse_args(argv)
    cfg = PipelineConfig(
        scene_path=args.scene_path,
        output_dir=args.output_dir,
        surface_level=args.surface_level,
    )
    scene = load_scene(cfg, device=device)
    out = run_extract_mesh(cfg, scene, args.coarse_model_path)
    print("mesh:", out)
    return out


if __name__ == "__main__":
    main()
