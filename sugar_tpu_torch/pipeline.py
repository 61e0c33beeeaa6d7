"""The full SuGaR pipeline: vanilla 3DGS -> coarse -> mesh -> refine ->
textured export.

Port of ``sugar_tpu/pipeline.py``, the equivalent of the reference's
train.py (:114-192): runs the stages in-process, passing artifacts through
the filesystem exactly like the reference (coarse checkpoint PLY, mesh
PLY, refined PLY, textured OBJ), with the same presets:

- ``low_poly``:  200k mesh vertices, 6 gaussians/triangle (train.py:92-99)
- ``high_poly``: 1M mesh vertices, 1 gaussian/triangle
- ``refinement_time``: 'short' 2k / 'medium' 7k / 'long' 15k iterations
  (train.py:100-108)

The artifact paths, ``stage_skip`` events and resume are the JAX
package's, and the artifacts cross between the packages (the refine
stage's ``_state.pkl`` holds the JAX package's keys as plain numpy). Every
stage runs on the device of the scene's cameras (``load_scene`` puts them
on ``cuda`` unless the caller asks for the CPU). With ``devices > 1`` the
vanilla, coarse, level-set and refine stages run sharded over a (data,
gauss) mesh of that many ranks (``parallel/``), as in the JAX package; the
pipeline stays single-controller, each sharded stage starting its ranks
through ``parallel.launch.run_ranks`` (one process per rank, on the
scene's device type) and logging rank 0's records when they end.

A vanilla 3DGS checkpoint (7k iterations) is a prerequisite, as in the
reference (README.md:94-95); :func:`run_vanilla` produces one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle

import numpy as np
import torch

from sugar_tpu_torch.io import datasets as ds
from sugar_tpu_torch.io import ply as ply_io
from sugar_tpu_torch.meshing.extract import ExtractConfig, extract_mesh_from_coarse_model
from sugar_tpu_torch.models import gaussians as gm
from sugar_tpu_torch.parallel.coarse import coarse_rank
from sugar_tpu_torch.parallel.launch import run_ranks, to_device
from sugar_tpu_torch.parallel.refine import refine_rank
from sugar_tpu_torch.parallel.trainer import vanilla_rank
from sugar_tpu_torch.refine.extract_textured import TextureConfig, extract_textured_mesh
from sugar_tpu_torch.refine.trainer import (
    RefineConfig,
    export_refined_ply,
    load_refined_state,
    refined_training,
)
from sugar_tpu_torch.trainers.coarse import CoarseConfig, train_coarse
from sugar_tpu_torch.trainers.vanilla import TrainConfig, train_vanilla_3dgs


@dataclasses.dataclass
class PipelineConfig:
    scene_path: str
    output_dir: str = "./output"
    regularization: str = "sdf"  # 'sdf', 'density' or 'dn_consistency' alias
    poly: str = "high_poly"  # 'high_poly' | 'low_poly'
    refinement_time: str = "long"  # 'short' | 'medium' | 'long'
    surface_level: float = 0.3
    eval_split: bool = True
    white_background: bool = False
    resolution_factor: int = 1
    vanilla_iterations: int = 7_000
    capacity: int = 2**19
    # Failure recovery: completed stages are skipped when their artifact
    # exists, and each stage saves/resumes mid-stage milestones under
    # <output_dir>/checkpoints/<stage>.
    resume: bool = True
    # Multi-device execution: devices > 1 runs the sharded stages over a
    # (data, gauss) mesh of that many ranks (parallel/).
    devices: int = 1
    mesh_gauss: int | None = None  # None = 2 if devices even else 1
    # Optional stage-config overrides (tests / experimentation).
    vanilla_overrides: dict = dataclasses.field(default_factory=dict)
    coarse_overrides: dict = dataclasses.field(default_factory=dict)
    extract_overrides: dict = dataclasses.field(default_factory=dict)
    refine_overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def n_vertices_in_mesh(self) -> int:
        return 200_000 if self.poly == "low_poly" else 1_000_000

    @property
    def gaussians_per_triangle(self) -> int:
        return 6 if self.poly == "low_poly" else 1

    @property
    def refinement_iterations(self) -> int:
        return {"short": 2_000, "medium": 7_000, "long": 15_000}[self.refinement_time]


def pipeline_mesh(cfg: PipelineConfig) -> tuple[int, int] | None:
    """The pipeline's (n_data, n_gauss) mesh, or None for single-device
    execution."""
    if cfg.devices <= 1:
        return None
    n_gauss = cfg.mesh_gauss
    if n_gauss is None:
        n_gauss = 2 if cfg.devices % 2 == 0 else 1
    if cfg.devices % n_gauss:
        raise ValueError(f"mesh_gauss={n_gauss} does not divide devices={cfg.devices}")
    return cfg.devices // n_gauss, n_gauss


def _sharded(mesh: tuple[int, int], scene: ds.SceneData, fn, args: tuple, log_fn):
    """Run a sharded stage's rank function over the (n_data, n_gauss)
    mesh on the scene's device type; log rank 0's records; return its
    result on the scene's device."""
    out, logs = run_ranks(fn, mesh[0] * mesh[1], device=_device(scene).type, args=args + mesh)
    for d in logs:
        log_fn(json.dumps(d))
    return to_device(out, _device(scene))


def _device(scene: ds.SceneData) -> torch.device:
    return scene.cameras[0].world_view.device


def load_scene(cfg: PipelineConfig, device: str | torch.device = "cuda") -> ds.SceneData:
    """The scene at ``cfg.scene_path`` (a NeRF-synthetic scene when it has
    ``transforms_train.json``, else COLMAP), its cameras on ``device``."""
    if os.path.exists(os.path.join(cfg.scene_path, "transforms_train.json")):
        return ds.load_blender_scene(
            cfg.scene_path,
            white_background=cfg.white_background,
            resolution_factor=cfg.resolution_factor,
            device=device,
        )
    return ds.load_colmap_scene(cfg.scene_path, resolution_factor=cfg.resolution_factor,
                                device=device)


def _stage_ckpt_dir(cfg: PipelineConfig, stage: str) -> str:
    return os.path.join(cfg.output_dir, "checkpoints", stage)


def run_vanilla(
    cfg: PipelineConfig, scene: ds.SceneData, log_fn=print, network_gui=None
) -> str:
    """Stage 0: prerequisite vanilla 3DGS (gaussian_splatting/train.py)."""
    mesh = pipeline_mesh(cfg)
    out_dir = os.path.join(
        cfg.output_dir, "vanilla_gs", f"iteration_{cfg.vanilla_iterations}"
    )
    ckpt = os.path.join(out_dir, "point_cloud.ply")
    if cfg.resume and os.path.exists(ckpt):
        log_fn(json.dumps({"event": "stage_skip", "stage": "vanilla", "artifact": ckpt}))
        return ckpt
    train_idx, _ = scene.split(cfg.eval_split)
    tkw = dict(
        iterations=cfg.vanilla_iterations,
        capacity=cfg.capacity,
        white_background=cfg.white_background,
    )
    tkw.update(cfg.vanilla_overrides)
    tcfg = TrainConfig(**tkw)
    if mesh is not None:
        model = _sharded(mesh, scene, vanilla_rank, (
            [scene.cameras[i] for i in train_idx], [scene.images[i] for i in train_idx],
            scene.points, scene.colors, scene.extent, tcfg), log_fn)
    else:
        model = train_vanilla_3dgs(
            [scene.cameras[i] for i in train_idx],
            [scene.images[i] for i in train_idx],
            scene.points,
            scene.colors,
            extent=scene.extent,
            cfg=tcfg,
            log_fn=lambda d: log_fn(json.dumps(d)),
            checkpoint_dir=_stage_ckpt_dir(cfg, "vanilla"),
            resume=cfg.resume,
            network_gui=network_gui,
            source_path=cfg.scene_path,
            device=_device(scene),
        ).model
    os.makedirs(out_dir, exist_ok=True)
    gm.save_ply(model, ckpt)
    ds.save_cameras_json(
        os.path.join(cfg.output_dir, "vanilla_gs", "cameras.json"),
        scene.cameras,
        scene.image_names,
    )
    return ckpt


def run_coarse(cfg: PipelineConfig, scene: ds.SceneData, gs_ckpt: str, log_fn=print) -> str:
    """Stage 1: coarse surface alignment (train_coarse_{sdf,density})."""
    mesh = pipeline_mesh(cfg)
    out = os.path.join(cfg.output_dir, "coarse", "coarse_15000.ply")
    if cfg.resume and os.path.exists(out):
        log_fn(json.dumps({"event": "stage_skip", "stage": "coarse", "artifact": out}))
        return out
    model = gm.load_ply(gs_ckpt, device=_device(scene))
    train_idx, _ = scene.split(cfg.eval_split)
    mode = "density" if cfg.regularization == "density" else "sdf"
    ckw = dict(mode=mode, white_background=cfg.white_background)
    ckw.update(cfg.coarse_overrides)
    ccfg = CoarseConfig(**ckw)
    if mesh is not None:
        model = _sharded(mesh, scene, coarse_rank, (
            model, [scene.cameras[i] for i in train_idx], [scene.images[i] for i in train_idx],
            scene.extent, ccfg), log_fn)
    else:
        model = train_coarse(
            model,
            [scene.cameras[i] for i in train_idx],
            [scene.images[i] for i in train_idx],
            extent=scene.extent,
            cfg=ccfg,
            log_fn=lambda d: log_fn(json.dumps(d)),
            checkpoint_dir=_stage_ckpt_dir(cfg, "coarse"),
            resume=cfg.resume,
        )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    gm.save_ply(model, out)
    return out


def run_extract_mesh(cfg: PipelineConfig, scene: ds.SceneData, coarse_ckpt: str, log_fn=print) -> str:
    """Stage 2: level-set sampling + Poisson + decimation (extract_mesh)."""
    mesh = pipeline_mesh(cfg)
    out = os.path.join(
        cfg.output_dir,
        "coarse_mesh",
        f"mesh_level{cfg.surface_level}_decim{cfg.n_vertices_in_mesh}.ply",
    )
    if cfg.resume and os.path.exists(out):
        log_fn(json.dumps({"event": "stage_skip", "stage": "extract_mesh", "artifact": out}))
        return out
    model = gm.load_ply(coarse_ckpt, device=_device(scene))
    train_idx, _ = scene.split(cfg.eval_split)
    ekw = dict(
        surface_level=cfg.surface_level,
        decimation_target=cfg.n_vertices_in_mesh,
    )
    ekw.update(cfg.extract_overrides)
    ecfg = ExtractConfig(**ekw)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    extract_mesh_from_coarse_model(
        model, [scene.cameras[i] for i in train_idx], ecfg, output_path=out,
        device_mesh=cfg.devices if mesh is not None else None,
    )
    return out


def _state_path(refined_ply: str) -> str:
    return refined_ply.replace(".ply", "_state.pkl")


def run_refine(cfg: PipelineConfig, scene: ds.SceneData, mesh_path: str, log_fn=print) -> str:
    """Stage 3: joint mesh + surface-Gaussian refinement (train_refined).
    Also writes ``<refined>_state.pkl`` (``save_refined_state``) for the
    texture stage."""
    mesh = pipeline_mesh(cfg)
    out = os.path.join(
        cfg.output_dir,
        "refined",
        f"refined_{cfg.gaussians_per_triangle}gpt_{cfg.refinement_iterations}.ply",
    )
    if cfg.resume and os.path.exists(out) and os.path.exists(_state_path(out)):
        log_fn(json.dumps({"event": "stage_skip", "stage": "refine", "artifact": out}))
        return out
    verts, faces, colors = ply_io.load_mesh_ply(mesh_path)
    vc = colors.astype(np.float32) / 255.0 if colors is not None else None
    train_idx, _ = scene.split(cfg.eval_split)
    rkw = dict(
        num_iterations=cfg.refinement_iterations,
        n_gaussians_per_triangle=cfg.gaussians_per_triangle,
        white_background=cfg.white_background,
    )
    rkw.update(cfg.refine_overrides)
    rcfg = RefineConfig(**rkw)
    if mesh is not None:
        params, bm = _sharded(mesh, scene, refine_rank, (
            verts, faces.astype(np.int64), vc, [scene.cameras[i] for i in train_idx],
            [scene.images[i] for i in train_idx], scene.extent, rcfg), log_fn)
    else:
        params, bm = refined_training(
            verts,
            faces.astype(np.int64),
            vc,
            [scene.cameras[i] for i in train_idx],
            [scene.images[i] for i in train_idx],
            extent=scene.extent,
            cfg=rcfg,
            log_fn=lambda d: log_fn(json.dumps(d)),
            checkpoint_dir=_stage_ckpt_dir(cfg, "refine"),
            resume=cfg.resume,
            device=_device(scene),
        )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    export_refined_ply(params, bm, out)
    save_refined_state(params, bm, _state_path(out))
    return out


def save_refined_state(params, bm, path: str) -> None:
    """Write a refined state as ``run_refine`` does: the JAX package's keys,
    numpy values (faces int32, as the JAX package writes them), so either
    package's ``load_refined_state`` reads it."""

    def host(x):
        return x.detach().cpu().numpy()

    with open(path, "wb") as f:
        pickle.dump(
            dict(
                vertices=host(params.vertices),
                faces=host(bm.faces).astype(np.int32),
                log_scales=host(params.log_scales),
                complex_rot=host(params.complex_rot),
                opacity_logit=host(params.opacity_logit),
                sh_dc=host(params.sh_dc),
                sh_rest=host(params.sh_rest),
                n_per_triangle=bm.n_per_triangle,
                thickness=float(bm.thickness),
            ),
            f,
        )


def run_texture(cfg: PipelineConfig, scene: ds.SceneData, refined_ply: str, log_fn=print) -> str:
    """Stage 4: UV texture baking + textured OBJ export
    (extract_refined_mesh_with_texture)."""
    out = os.path.join(cfg.output_dir, "refined_mesh", "textured.obj")
    if cfg.resume and os.path.exists(out):
        log_fn(json.dumps({"event": "stage_skip", "stage": "texture", "artifact": out}))
        return out
    params, bm = load_refined_state(_state_path(refined_ply), device=_device(scene))
    train_idx, _ = scene.split(cfg.eval_split)
    sh_degree = int(round(np.sqrt(params.sh_rest.shape[-1] + 1))) - 1
    os.makedirs(os.path.dirname(out), exist_ok=True)
    extract_textured_mesh(
        params, bm, [scene.cameras[i] for i in train_idx], out,
        TextureConfig(), sh_degree=sh_degree,
    )
    return out


def load_reference_checkpoint(
    gs_output_path: str, iteration: int = 7000, device: str | torch.device = "cuda"
) -> gm.GaussianModel:
    """Load a checkpoint produced by the *reference* 3DGS/SuGaR training
    (output/<scene>/point_cloud/iteration_N/point_cloud.ply) onto
    ``device``, so users can bring their existing models in unchanged."""
    ply = os.path.join(
        gs_output_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply"
    )
    if not os.path.exists(ply):
        raise FileNotFoundError(ply)
    return gm.load_ply(ply, device=device)


def run_full_pipeline(
    cfg: PipelineConfig, log_fn=print, device: str | torch.device = "cuda"
) -> dict:
    """All stages (reference train.py flow) on ``device``. Returns artifact
    paths."""
    pipeline_mesh(cfg)  # refuse a bad mesh before any stage runs
    scene = load_scene(cfg, device=device)
    gs = run_vanilla(cfg, scene, log_fn)
    coarse = run_coarse(cfg, scene, gs, log_fn)
    mesh = run_extract_mesh(cfg, scene, coarse, log_fn)
    refined = run_refine(cfg, scene, mesh, log_fn)
    textured = run_texture(cfg, scene, refined, log_fn)
    return dict(
        vanilla=gs, coarse=coarse, mesh=mesh, refined=refined, textured=textured
    )
