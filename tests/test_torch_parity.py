"""tests/test_parity.py on the port: the reduced quality-parity gate.

The procedural blob scene, degraded init, vanilla -> coarse-SDF -> mesh ->
refine through the port's pipeline API on the CPU, PSNR on the every-8th
held-out split, held to the JAX test's floors and stage-ordering
invariants (tests/test_parity.py:87-102). The port renders with
``render_mode="auto"`` (the fused path's plain version on the CPU), where
the JAX test renders with its ``"tiled"`` oracle mode (which the port has
too, ``raster/tiled.py``). ``chip_smoke.py`` ``[13]`` runs the same
configuration on the card.
"""

import numpy as np
import pytest

from sugar_tpu_torch.eval.parity import eval_gaussian_ply, make_parity_scene
from sugar_tpu_torch.io.ply import load_mesh_ply
from sugar_tpu_torch.pipeline import (
    PipelineConfig,
    run_coarse,
    run_extract_mesh,
    run_refine,
    run_vanilla,
)


@pytest.mark.slow
def test_stage_ordering_invariants(tmp_path):
    v_it, c_it, r_it = 200, 150, 400
    scene, _ = make_parity_scene(
        n_gt=2_000, n_init=800, n_cams=16, resolution=96, render_mode="auto", k_max=512,
        device="cpu",
    )
    train_idx, test_idx = scene.split(True)
    assert len(test_idx) == 2  # every-8th split of 16 cams

    cfg = PipelineConfig(
        scene_path="<procedural>",
        output_dir=str(tmp_path),
        regularization="sdf",
        poly="low_poly",
        eval_split=True,
        capacity=2**12,
        vanilla_iterations=v_it,
        resume=False,
        vanilla_overrides=dict(
            sh_degree=1, sh_warmup_every=max(1, v_it // 2),
            densify_from=50, densify_until=int(v_it * 0.8), densify_every=50,
            opacity_reset_every=10 * v_it, k_max=512, log_every=10**6,
            checkpoint_iterations=(),
        ),
        coarse_overrides=dict(
            start_iteration=v_it, num_iterations=v_it + c_it,
            entropy_start=v_it, entropy_end=v_it + c_it // 3,
            prune_at=(v_it + c_it // 3,), regularize_from=v_it,
            start_sdf_estimation_from=v_it + c_it // 3,
            n_samples_for_sdf_regularization=20_000,
            reset_neighbors_every=50, sh_degree=1, k_max=512,
            log_every=10**6, checkpoint_iterations=(),
        ),
        extract_overrides=dict(
            surface_level=0.3, prune_opacity_threshold=0.5,
            total_points=150_000, poisson_resolution=96,
            decimation_target=6_000, dup_capacity=2**16, k_max=512,
        ),
        refine_overrides=dict(
            num_iterations=r_it, n_gaussians_per_triangle=3, sh_degree=1,
            sh_warmup_every=max(1, r_it // 4), k_max=512, log_every=10**6,
            checkpoint_iterations=(),
        ),
    )

    def psnr(ply):
        return eval_gaussian_ply(ply, scene, test_idx, render_mode="auto", k_max=512)["psnr"]

    gs_ply = run_vanilla(cfg, scene, log_fn=lambda *_: None)
    p_vanilla = psnr(gs_ply)
    coarse_ply = run_coarse(cfg, scene, gs_ply, log_fn=lambda *_: None)
    p_coarse = psnr(coarse_ply)
    mesh_ply = run_extract_mesh(cfg, scene, coarse_ply, log_fn=lambda *_: None)
    verts, faces, _ = load_mesh_ply(mesh_ply)
    refined_ply = run_refine(cfg, scene, mesh_ply, log_fn=lambda *_: None)
    p_refined = psnr(refined_ply)

    # The JAX test's floors (~1.5 dB under its CPU run: 17.00 / 19.10 /
    # 16.94 dB) and ordering invariants.
    assert p_vanilla > 15.5, p_vanilla
    assert p_coarse > 17.6, (p_vanilla, p_coarse)
    assert len(verts) > 500 and len(faces) > 500
    assert p_refined > 15.4, (p_coarse, p_refined)
    assert p_coarse > p_vanilla - 1.0, (p_vanilla, p_coarse)
    assert p_refined > p_coarse - 3.0, (p_coarse, p_refined)
    r = np.linalg.norm(verts, axis=1)
    assert 0.3 < float(np.median(r)) < 1.6, float(np.median(r))
