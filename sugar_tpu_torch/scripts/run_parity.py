"""Full-pipeline quality-parity run (the PARITY protocol); the port of
``scripts/run_parity.py``.

Protocol (``eval.parity``): a procedural GT scene (60k surface Gaussians,
80 cameras at 256x256; ``--small``: 4k Gaussians, 16 cameras at 128x128),
a degraded init, the every-8th held-out split, then vanilla -> coarse-SDF
-> mesh -> refine with per-stage PSNR/SSIM on the held-out cameras
(reference protocol: metrics.py:154-417 with the gs_model.py:133-143
split). On a CUDA card it renders with the fused kernel path
(``"pallas"``); on the CPU with the ``"tiled"`` mode, as the JAX script
chooses by backend. Completed stages are skipped when run again.

    python -m sugar_tpu_torch.scripts.run_parity [--small] [--out parity.json]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from sugar_tpu_torch.eval.parity import eval_gaussian_ply, make_parity_scene
from sugar_tpu_torch.io import ply as ply_io
from sugar_tpu_torch.pipeline import (
    PipelineConfig,
    run_coarse,
    run_extract_mesh,
    run_refine,
    run_vanilla,
)
from sugar_tpu_torch.utils.profiling import card_line

# (scene, (vanilla, coarse, refine) iterations, capacity, extraction overrides)
CONFIGS = {
    "small": (
        dict(n_gt=4_000, n_init=1_500, n_cams=16, resolution=128), (300, 300, 200), 2**13,
        dict(total_points=400_000, poisson_resolution=96, decimation_target=8_000,
             dup_capacity=2**17),
    ),
    "full": (
        dict(n_gt=60_000, n_init=15_000, n_cams=80, resolution=256), (3_000, 1_200, 7_000),
        2**17,
        dict(total_points=2_000_000, poisson_resolution=160, decimation_target=50_000,
             dup_capacity=2**20),
    ),
}


def parity_config(workdir: str, iters: tuple[int, int, int], capacity: int,
                  extract_over: dict) -> PipelineConfig:
    """The JAX script's PipelineConfig for these iterations."""
    vanilla_iters, coarse_iters, refine_iters = iters
    c_end = vanilla_iters + coarse_iters
    return PipelineConfig(
        scene_path="<procedural>",
        output_dir=workdir,
        resume=True,  # completed stages skip on relaunch (artifacts on disk)
        regularization="sdf",
        poly="low_poly",
        eval_split=True,
        capacity=capacity,
        vanilla_iterations=vanilla_iters,
        vanilla_overrides=dict(
            sh_degree=1,
            sh_warmup_every=max(1, vanilla_iters // 3),
            densify_from=500,
            densify_until=int(vanilla_iters * 0.85),
            densify_every=100,
            opacity_reset_every=10 * vanilla_iters,  # off: short schedule
            k_max=1024,
            log_every=max(1, vanilla_iters // 10),
            checkpoint_iterations=(),
        ),
        coarse_overrides=dict(
            start_iteration=vanilla_iters,
            num_iterations=c_end,
            entropy_start=vanilla_iters,
            entropy_end=vanilla_iters + int(coarse_iters * 0.3),
            prune_at=(vanilla_iters + int(coarse_iters * 0.3),),
            regularize_from=vanilla_iters,
            start_sdf_estimation_from=vanilla_iters + int(coarse_iters * 0.3),
            n_samples_for_sdf_regularization=150_000,
            reset_neighbors_every=150,
            sh_degree=1,
            k_max=1024,
            log_every=max(1, coarse_iters // 10),
            checkpoint_iterations=(),
        ),
        extract_overrides=dict(
            dict(surface_level=0.3, prune_opacity_threshold=0.5, k_max=1024), **extract_over
        ),
        refine_overrides=dict(
            num_iterations=refine_iters,
            # 3 per triangle: a decimated 50k-vertex mesh at 1 per triangle
            # has ~1/3 the coarse model's appearance capacity (the
            # reference's low_poly preset binds 6, train.py:92-99).
            n_gaussians_per_triangle=3,
            sh_degree=1,
            sh_warmup_every=max(1, refine_iters // 2),
            k_max=1024,
            log_every=max(1, refine_iters // 10),
            checkpoint_iterations=(),
        ),
    )


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="./output/parity/parity.json")
    ap.add_argument("--workdir", default="./output/parity/work")
    ap.add_argument("--small", action="store_true", help="tiny smoke config")
    args = ap.parse_args(argv)

    scfg, iters, capacity, extract_over = CONFIGS["small" if args.small else "full"]
    on_card = torch.device(device).type == "cuda"
    mode = "pallas" if on_card else "tiled"

    t0 = time.time()
    print(f"device={device} mode={mode}", flush=True)
    scene, _target = make_parity_scene(**scfg, render_mode=mode, dup_capacity=None, k_max=1024,
                                       device=device)
    _, test_idx = scene.split(True)
    print(f"scene ready ({time.time() - t0:.0f}s): {len(scene.cameras) - len(test_idx)} train / "
          f"{len(test_idx)} test", flush=True)

    cfg = parity_config(args.workdir, iters, capacity, extract_over)
    # The trainers render in the scene's mode too: the JAX trainers' "auto"
    # is "tiled" on a CPU, the port's is "pallas" everywhere.
    for stage in (cfg.vanilla_overrides, cfg.coarse_overrides, cfg.refine_overrides):
        stage["render_mode"] = mode
    os.makedirs(args.workdir, exist_ok=True)
    results: dict = dict(
        protocol="sugar_tpu_torch.eval.parity procedural blob; every-8th split "
        "(reference metrics.py:154-417, gs_model.py:133-143)",
        # The card's name and power limit (nvidia-smi): a card set below
        # its maximum power runs slower under load.
        device=card_line() if on_card else "cpu",
        scene=scfg,
        iterations=dict(zip(("vanilla", "coarse", "refine"), iters)),
        stages={},
    )

    def log(d):
        print(d if isinstance(d, str) else json.dumps(d), flush=True)

    def stage_eval(name, ply):
        r = eval_gaussian_ply(ply, scene, test_idx, render_mode=mode, k_max=1024)
        r.pop("per_image_psnr", None)
        r.pop("per_image_ssim", None)
        results["stages"][name] = r
        print(f"[{name}] PSNR={r['psnr']:.2f} SSIM={r['ssim']:.4f} ({time.time() - t0:.0f}s)",
              flush=True)

    gs_ply = run_vanilla(cfg, scene, log_fn=log)
    stage_eval("vanilla", gs_ply)
    coarse_ply = run_coarse(cfg, scene, gs_ply, log_fn=log)
    stage_eval("coarse_sdf", coarse_ply)
    mesh_ply = run_extract_mesh(cfg, scene, coarse_ply, log_fn=log)
    verts, faces, _cols = ply_io.load_mesh_ply(mesh_ply)
    results["stages"]["mesh"] = dict(vertices=int(len(verts)), faces=int(len(faces)))
    print(f"[mesh] {len(verts)} verts / {len(faces)} faces ({time.time() - t0:.0f}s)", flush=True)
    refined_ply = run_refine(cfg, scene, mesh_ply, log_fn=log)
    stage_eval("refined", refined_ply)

    results["wall_s"] = round(time.time() - t0, 1)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results["stages"], indent=2))
    print(f"wrote {args.out} in {results['wall_s']}s")
    return results


if __name__ == "__main__":
    main()
