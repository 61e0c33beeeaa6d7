"""Full pipeline entry point, the reference's train.py (:17-108) argument
surface; the port of ``scripts/train_full_pipeline.py``.

    python -m sugar_tpu_torch.scripts.train_full_pipeline -s <scene> -o <output>
"""

from __future__ import annotations

import argparse

from sugar_tpu_torch.pipeline import PipelineConfig, run_full_pipeline


def main(argv=None, device="cuda") -> dict:
    p = argparse.ArgumentParser(description="Train SuGaR end to end on CUDA cards.")
    p.add_argument("-s", "--scene_path", required=True)
    p.add_argument("-o", "--output_dir", default="./output")
    p.add_argument("-r", "--regularization_type", default="sdf",
                   choices=["sdf", "density"])
    p.add_argument("--low_poly", action="store_true",
                   help="200k mesh vertices, 6 gaussians/triangle")
    p.add_argument("--high_poly", action="store_true",
                   help="1M mesh vertices, 1 gaussian/triangle (default)")
    p.add_argument("--refinement_time", default="long",
                   choices=["short", "medium", "long"])
    p.add_argument("-l", "--surface_level", type=float, default=0.3)
    p.add_argument("--eval", action="store_true", default=True)
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--resolution", type=int, default=1)
    p.add_argument("--devices", type=int, default=1,
                   help="ranks of the sharded stages: N > 1 runs them over a "
                        "('data','gauss') mesh of N processes (NCCL with a card "
                        "each; ranks sharing a card use gloo); 1 = single device")
    p.add_argument("--mesh_gauss", type=int, default=None,
                   help="'gauss' axis size of the mesh (default: 2 if --devices "
                        "is even else 1)")
    args = p.parse_args(argv)

    cfg = PipelineConfig(
        scene_path=args.scene_path,
        output_dir=args.output_dir,
        regularization=args.regularization_type,
        poly="low_poly" if args.low_poly else "high_poly",
        refinement_time=args.refinement_time,
        surface_level=args.surface_level,
        eval_split=args.eval,
        white_background=args.white_background,
        resolution_factor=args.resolution,
        devices=args.devices,
        mesh_gauss=args.mesh_gauss,
    )
    artifacts = run_full_pipeline(cfg, device=device)
    print("Artifacts:", artifacts)
    return artifacts


if __name__ == "__main__":
    main()
