"""Vanilla 3DGS training loop (the prerequisite 7k-iteration stage).

Port of ``sugar_tpu/trainers/vanilla.py``. Reference semantics
(gaussian_splatting/train.py:31-133 + OptimizationParams): random camera
order per epoch, loss = (1-λ)·L1 + λ·(1-SSIM) with λ=0.2, SH degree warmup
+1 per 1000 iters, densify from iter 500 to 15000 every 100 (screen-size
pruning only after the first opacity reset), opacity reset every 3000,
exponential position LR.

The train step (render + loss + backward + Adam + densify stats) runs
eagerly on the params' device; on CUDA tensors the render's forward and
backward go through the hand-written kernels K1, K2 and K3. The step takes
and returns whole states and leaves its inputs unchanged.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.models import densifier as dens
from sugar_tpu_torch.models.gaussians import (
    PARAM_FIELDS,
    GaussianModel,
    GaussianParams,
    create_from_pcd,
)
from sugar_tpu_torch.models.render import render_model, render_params
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.raster.common import clip
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.trainers.schedule import CameraSchedule, iteration_generator
from sugar_tpu_torch.utils import checkpoint as ckpt
from sugar_tpu_torch.utils import losses, profiling
from sugar_tpu_torch.viewer.network_gui import camera_from_message

@dataclasses.dataclass
class TrainConfig:
    iterations: int = 7_000
    lambda_dssim: float = 0.2
    sh_degree: int = 3
    sh_warmup_every: int = 1_000
    densify_from: int = 500
    densify_until: int = 15_000
    densify_every: int = 100
    densify_grad_threshold: float = 0.0002
    opacity_reset_every: int = 3_000
    prune_min_opacity: float = 0.005
    prune_max_screen: float = 20.0
    percent_dense: float = 0.01
    white_background: bool = False
    capacity: int = 2**18
    dup_capacity_mult: int = 12
    k_max: int = 1024
    # "auto" = the fused production path (the kernels on CUDA tensors).
    render_mode: str = "auto"
    optim: opt.OptimConfig = dataclasses.field(default_factory=opt.OptimConfig)
    log_every: int = 200
    # Milestone checkpoint iterations (reference saves at 7000/30000,
    # gaussian_splatting/train.py --save_iterations). Active only when a
    # checkpoint_dir is passed to the trainer.
    checkpoint_iterations: tuple = (7_000,)


def make_train_step(
    cfg: TrainConfig,
    lrs: dict[str, Callable],
    active_sh_degree: int,
    caps: adaptive.RasterCaps,
):
    """Build the train step for one (SH degree, raster caps) pair:
    ``step_fn(params, alive, adam, stats, camera, gt, it)`` returns (new
    params, new adam, new stats, aux) with aux holding the loss, the PSNR,
    the radii and the overflow counters (device tensors, not synced)."""

    @profiling.spanned("train.step")
    def step_fn(
        params: GaussianParams,
        alive: torch.Tensor,
        adam: opt.AdamState,
        stats: dens.DensifyStats,
        camera: Camera,
        gt: torch.Tensor,
        it,
    ):
        dev = params.xyz.device
        bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
        leaves = [getattr(params, f).detach().requires_grad_(True) for f in PARAM_FIELDS]
        probe = torch.zeros((params.xyz.shape[0], 2), device=dev, requires_grad=True)
        out = render_params(
            GaussianParams(**dict(zip(PARAM_FIELDS, leaves))), alive, camera, active_sh_degree, bg,
            ndc_offset=probe, dup_capacity=caps.dup_capacity, k_max=caps.k_max,
            mode=cfg.render_mode, tile_cap=caps.tile_cap, cap_a=caps.cap_a,
            big_cap=caps.big_cap,
        )
        with profiling.span("loss"):
            img = clip(out["image"], 0.0, 1.0)
            loss = losses.rgb_loss_l1_dssim(img, gt, cfg.lambda_dssim)
            with torch.no_grad():
                psnr = losses.psnr(img.detach(), gt)
        with profiling.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves + [probe], allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(leaves + [probe], grads)]
        new_params, new_adam = opt.adam_step(
            params, GaussianParams(**dict(zip(PARAM_FIELDS, grads))), adam, it, lrs, cfg.optim
        )
        new_stats = dens.update_stats(stats, grads[-1], out["radii"])
        aux = dict(loss=loss.detach(), psnr=psnr, radii=out["radii"])
        aux.update(adaptive.overflow_counters(out))
        return new_params, new_adam, new_stats, aux

    return step_fn


@dataclasses.dataclass
class TrainerState:
    model: GaussianModel
    adam: opt.AdamState
    stats: dens.DensifyStats
    iteration: int


def train_vanilla_3dgs(
    scene_cameras: list[Camera],
    scene_images: list,
    points: np.ndarray,
    colors: np.ndarray,
    extent: float,
    cfg: TrainConfig,
    seed: int = 0,
    log_fn: Callable[[dict], None] | None = None,
    start_iteration: int = 0,
    model: GaussianModel | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = True,
    network_gui=None,
    source_path: str = "",
    device: str | torch.device = "cuda",
) -> TrainerState:
    """Run the vanilla 3DGS optimization on ``device`` (the given model's
    device when ``model`` is passed). Cameras may have mixed resolutions.
    ``scene_images`` are (H, W, 3) float arrays or tensors. The caller's
    model is not modified.

    With ``checkpoint_dir``, training state (params, alive, Adam, densify
    stats, iteration) is saved at ``cfg.checkpoint_iterations`` milestones;
    when ``resume`` and a milestone exists, training restarts from the
    latest one and replays the camera order and per-iteration draws of the
    uninterrupted run (bit-exact on the CPU; on CUDA the backward's
    scatter-adds sum in any order).

    With ``network_gui`` (a ``viewer.network_gui.NetworkGUI``), each
    iteration serves one protocol round to a connected viewer: a render of
    the live model from the viewer's camera (reference
    gaussian_splatting/train.py:52-65), with ``source_path`` in the reply.
    The JAX signature's unused ``eval_cameras``/``eval_images`` are left
    out."""
    if model is None:
        model = create_from_pcd(points, colors, cfg.capacity, sh_degree=cfg.sh_degree,
                                device=device)
    dev = model.device
    params, alive = model.params, model.alive
    adam = opt.init_adam(params)
    stats = dens.DensifyStats.zeros(model.capacity, device=dev)
    lrs = opt.group_lrs(cfg.optim, spatial_lr_scale=extent)
    if checkpoint_dir and resume:
        latest = ckpt.latest_milestone(checkpoint_dir, before=cfg.iterations)
        if latest is not None and latest > start_iteration:
            like = dict(params=params, alive=alive, adam=adam, stats=stats, iteration=0)
            st = ckpt.restore_structured(ckpt.milestone_path(checkpoint_dir, latest), like)
            params, alive = st["params"], st["alive"]
            adam, stats = st["adam"], st["stats"]
            start_iteration = st["iteration"]
            if log_fn:
                log_fn({"event": "resume", "iteration": start_iteration})
    # Lag-checked capacity auto-grow (raster.adaptive): an overflowing step
    # renders a degraded frame, a later step runs with grown caps.
    cap_state = adaptive.CapState(
        adaptive.RasterCaps(
            tile_cap=16, dup_capacity=cfg.dup_capacity_mult * cfg.capacity, k_max=cfg.k_max
        ),
        log_fn=log_fn,
    )
    sched = CameraSchedule(seed, len(scene_cameras))

    step_cache: dict[tuple, Callable] = {}
    t0 = time.time()
    gt_cache: dict[int, torch.Tensor] = {}

    @torch.no_grad()
    def _gui_render(msg: dict):
        """Render the live model for an interactive-viewer poll."""
        cam = camera_from_message(msg, device=dev)
        live = dataclasses.replace(model, params=params, alive=alive)
        return render_model(live, cam, dup_capacity=cap_state.caps.dup_capacity,
                            k_max=cap_state.caps.k_max)["image"]

    for it in range(start_iteration, cfg.iterations):
        if network_gui is not None:
            # One protocol round per iteration while a viewer is connected.
            network_gui.poll(_gui_render, training_done=False, source_path=source_path)
        active_deg = min(it // cfg.sh_warmup_every, cfg.sh_degree)
        skey = (active_deg, cap_state.key())
        if skey not in step_cache:
            step_cache[skey] = make_train_step(cfg, lrs, active_deg, cap_state.caps)
        ci = sched.index(it)
        gt = gt_cache.get(ci)
        if gt is None:
            gt = gt_cache[ci] = torch.as_tensor(scene_images[ci], dtype=torch.float32,
                                                device=dev)

        params, adam, stats, aux = step_cache[skey](
            params, alive, adam, stats, scene_cameras[ci], gt, it
        )
        if cap_state.check_lagged(it, aux):
            step_cache.clear()

        it1 = it + 1
        if cfg.densify_from < it1 <= cfg.densify_until and it1 % cfg.densify_every == 0:
            model = dataclasses.replace(model, params=params, alive=alive)
            noise = torch.randn((2, model.capacity, 3),
                                generator=iteration_generator(seed, it1, dev), device=dev)
            mss = cfg.prune_max_screen if it1 > cfg.opacity_reset_every else None
            model, adam, stats, dinfo = dens.densify_and_prune(
                model, adam, stats, noise, extent,
                grad_threshold=cfg.densify_grad_threshold,
                min_opacity=cfg.prune_min_opacity,
                max_screen_size=mss,
                percent_dense=cfg.percent_dense,
            )
            params, alive = model.params, model.alive
            if log_fn:
                log_fn({"iter": it1, **{k: int(v) for k, v in dinfo.items()}})

        if it1 % cfg.opacity_reset_every == 0 and it1 <= cfg.densify_until:
            model = dataclasses.replace(model, params=params, alive=alive)
            model, adam = dens.reset_opacity(model, adam)
            params = model.params
            if log_fn:
                log_fn({"iter": it1, "event": "opacity_reset"})

        if checkpoint_dir and it1 in cfg.checkpoint_iterations:
            ckpt.save_milestone(
                checkpoint_dir, it1,
                dict(params=params, alive=alive, adam=adam, stats=stats, iteration=it1),
            )

        if log_fn and (it1 % cfg.log_every == 0 or it1 == cfg.iterations):
            log_fn(
                {
                    "iter": it1,
                    "loss": float(aux["loss"]),
                    "psnr": float(aux["psnr"]),
                    "n_alive": int(alive.sum()),
                    **adaptive.logged_overflow(aux),
                    "elapsed_s": time.time() - t0,
                }
            )

    model = dataclasses.replace(model, params=params, alive=alive)
    return TrainerState(model=model, adam=adam, stats=stats, iteration=cfg.iterations)
