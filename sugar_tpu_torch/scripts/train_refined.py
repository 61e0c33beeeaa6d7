"""Refinement entry point (the reference train_refined.py surface); the
port of ``scripts/train_refined.py``.

    python -m sugar_tpu_torch.scripts.train_refined -s <scene> -m <mesh.ply>
"""

from __future__ import annotations

import argparse

from sugar_tpu_torch.pipeline import PipelineConfig, load_scene, run_refine


def main(argv=None, device="cuda") -> str:
    p = argparse.ArgumentParser()
    p.add_argument("-s", "--scene_path", required=True)
    p.add_argument("-m", "--mesh_path", required=True)
    p.add_argument("-o", "--output_dir", default="./output")
    p.add_argument("-g", "--gaussians_per_triangle", type=int, default=1, choices=[1, 3, 4, 6])
    p.add_argument("-f", "--refinement_iterations", type=int, default=15_000)
    p.add_argument("--white_background", action="store_true")
    args = p.parse_args(argv)
    time_name = {2000: "short", 7000: "medium", 15000: "long"}.get(
        args.refinement_iterations, "long"
    )
    cfg = PipelineConfig(
        scene_path=args.scene_path,
        output_dir=args.output_dir,
        poly="low_poly" if args.gaussians_per_triangle == 6 else "high_poly",
        refinement_time=time_name,
        white_background=args.white_background,
        refine_overrides=dict(num_iterations=args.refinement_iterations,
                              n_gaussians_per_triangle=args.gaussians_per_triangle),
    )
    out = run_refine(cfg, load_scene(cfg, device=device), args.mesh_path)
    print("refined:", out)
    return out


if __name__ == "__main__":
    main()
