"""SuGaR coarse training: surface-alignment regularization stages.

Port of ``sugar_tpu/trainers/coarse.py``, itself a recast of
sugar_trainers/coarse_sdf.py:17-825 and coarse_density.py (same skeleton):

- starts from a trained 3DGS model at iteration 7000 and runs to 15000
  (counter semantics coarse_sdf.py:468-469), densification disabled
  (:71-76), SH warmup off (:208-217);
- loss = 0.8*L1 + 0.2*DSSIM (:101-104);
- entropy regularization on visible opacities, iters (7000, 9000), factor
  0.1 (:106-110, 538-551);
- hard prune of opacity < 0.5 at iter 9000 (:195-198);
- from iter 9000: SDF regularization (:112-152): sample 1M points in
  visible surface-near Gaussians (sigma*1.5), depth map rendered through the
  rasterizer *with* gradients (point_colors = view-z trick, :578-604),
  sdf_estimation_loss (factor 0.2) + sdf_better_normal_loss (factor 0.2);
- KNN(16) refreshed every 500 iterations (:178-185, 553-561) and after the
  prune.

Mode 'sdf' uses |sdf(x) - |depth - z|| / (extent/10) with density_factor
1/16; mode 'density' (coarse_density.py:124-141, 653-662) uses
|density(x) - exp(-0.5 d^2 / beta^2)| with d the projection of (x - mu) on
the Gaussian normal, density_factor 1, and no close-to-surface masking.

The step runs eagerly on the params' device: on CUDA tensors both renders
(RGB, and in 'sdf' mode the depth map) and their backward go through the
kernels K1, K2 and K3. 'density' mode never reads the depth map, so it does
not render it (the JAX step computes it and XLA drops it under jit): one
launch of each kernel per step there, two in 'sdf' steps. Every
``stop_gradient`` of the JAX loss is a ``.detach()`` or code under
``torch.no_grad()``. The per-iteration sample draw comes from
``iteration_generator(seed, it)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from sugar_tpu_torch.core import transforms as tf
from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.core.quaternions import normalize as quat_normalize
from sugar_tpu_torch.core.quaternions import quaternion_apply, quaternion_invert
from sugar_tpu_torch.fields import density as df
from sugar_tpu_torch.fields.knn import knn
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel, GaussianParams
from sugar_tpu_torch.models.render import render_params
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.api import rasterize_gaussians
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.trainers.schedule import CameraSchedule, iteration_generator
from sugar_tpu_torch.utils import checkpoint as ckpt
from sugar_tpu_torch.utils import losses


@dataclasses.dataclass
class CoarseConfig:
    mode: str = "sdf"  # 'sdf' or 'density'
    num_iterations: int = 15_000
    start_iteration: int = 7_000
    dssim_factor: float = 0.2
    # entropy regularization
    entropy_start: int = 7_000
    entropy_end: int = 9_000
    entropy_factor: float = 0.1
    # hard prune
    prune_at: tuple = (9_000,)
    prune_hard_opacity_threshold: float = 0.5
    # sdf regularization
    regularize_from: int = 7_000
    start_sdf_estimation_from: int = 9_000
    sdf_estimation_factor: float = 0.2
    sdf_better_normal_factor: float = 0.2
    n_samples_for_sdf_regularization: int = 1_000_000
    sdf_sampling_scale_factor: float = 1.5
    close_gaussian_threshold: float = 2.0
    knn_to_track: int = 16
    reset_neighbors_every: int = 500
    beta_mode: str = "average"
    sh_degree: int = 3
    white_background: bool = False
    k_max: int = 1024
    dup_capacity_mult: int = 10
    # "auto" = the fused production path (the kernels on CUDA tensors).
    render_mode: str = "auto"
    log_every: int = 50
    # Milestone saves (reference: coarse_sdf.py:224, 782-793 saves 15000;
    # 9000 additionally captures the post-prune state).
    checkpoint_iterations: tuple = (9_000, 15_000)
    optim: opt.OptimConfig = dataclasses.field(default_factory=opt.OptimConfig)

    @property
    def density_factor(self) -> float:
        return 1.0 if self.mode == "density" else 1.0 / 16.0

    @property
    def sample_only_close_to_surface(self) -> bool:
        return self.mode == "sdf"


def _entropy(op: torch.Tensor) -> torch.Tensor:
    return -op * torch.log(op + 1e-10) - (1 - op) * torch.log(1 - op + 1e-10)


def coarse_loss(
    cfg: CoarseConfig,
    p: GaussianParams,
    alive: torch.Tensor,
    knn_idx: torch.Tensor,  # (capacity, K) neighbor table
    camera: Camera,
    gt: torch.Tensor,
    draw: tuple[torch.Tensor, torch.Tensor] | torch.Generator,
    spatial_extent: float,
    dup_capacity: int,
    with_entropy: bool,
    with_sdf: bool,
    render_mode: str = "auto",
    k_max: int | None = None,
    tile_cap: int | None = None,
    cap_a: int = 4,
    big_cap: int | None = None,
):
    """One view's coarse-stage loss (RGB + entropy + SDF/density + normal
    terms), differentiable in ``p``. ``draw`` is the SDF samples' draw
    (see ``fields.density.sample_points_in_gaussians``). Returns (loss,
    aux) with aux holding the detached loss, the PSNR, the visible count
    and the RGB render's overflow counters."""
    if k_max is None:
        k_max = cfg.k_max
    dev = p.xyz.device
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    out = render_params(
        p, alive, camera, cfg.sh_degree, bg, dup_capacity=dup_capacity, k_max=k_max,
        mode=render_mode, tile_cap=tile_cap, cap_a=cap_a, big_cap=big_cap,
    )
    img = rc.clip(out["image"], 0.0, 1.0)
    loss = losses.rgb_loss_l1_dssim(img, gt, cfg.dssim_factor)
    visible = out["radii"] > 0

    opacities = torch.sigmoid(p.opacity_logit)
    scales = torch.exp(p.log_scales)
    quats = quat_normalize(p.quaternions)

    if with_entropy:
        # where(), not multiply-by-mask: a non-finite opacity in a culled
        # slot would otherwise poison the sum (NaN * 0 = NaN).
        ent = torch.where(visible, _entropy(opacities), 0.0).sum() / torch.clamp_min(
            visible.sum(dtype=torch.float32), 1.0)
        loss = loss + cfg.entropy_factor * ent

    if with_sdf:
        gp = df.GaussianFieldParams(centers=p.xyz, scales=scales, quaternions=quats,
                                    opacities=opacities)
        if cfg.mode == "sdf":
            # Depth map via the rasterizer (view-z as color, bg = max z;
            # coarse_sdf.py:578-604). Gradients flow through it.
            zs = p.xyz @ camera.world_view[2, :3] + camera.world_view[2, 3]
            max_depth = torch.where(alive, zs, 0.0).amax()  # amax splits ties as jnp.max
            depth_img = _render_depth(
                p, alive, camera, zs, max_depth, dup_capacity, k_max,
                mode=render_mode, tile_cap=tile_cap, cap_a=cap_a, big_cap=big_cap,
            )

        sampling_mask = visible
        if cfg.sample_only_close_to_surface:
            # coarse_sdf.py:608-623, all under stop_gradient.
            with torch.no_grad():
                cam_dir = camera.cam_center[None, :] - p.xyz
                cam_dir = cam_dir / torch.clamp_min(
                    torch.linalg.norm(cam_dir, dim=-1, keepdim=True), 1e-12)
                local_dir = quaternion_apply(quaternion_invert(quats), cam_dir)
                g_std = torch.linalg.norm(scales * local_dir, dim=-1)
                map_z = df.depth_lookup_bilinear(depth_img, _project_to_pixels(p.xyz, camera))
                close = (map_z - zs).abs() < cfg.close_gaussian_threshold * g_std
            sampling_mask = sampling_mask & close

        samples, src_idx = df.sample_points_in_gaussians(
            draw,
            cfg.n_samples_for_sdf_regularization,
            gp,
            alive & sampling_mask,
            sampling_scale_factor=cfg.sdf_sampling_scale_factor,
            prob_proportional_to_volume=False,
        )
        any_sampled = (alive & sampling_mask).any()

        neighbor_idx = knn_idx[src_idx]  # (S, K)
        fields = df.field_values(
            samples,
            neighbor_idx,
            gp,
            density_factor=cfg.density_factor,
            return_sdf=cfg.mode == "sdf",
            return_beta=cfg.mode == "density",
            beta_mode=cfg.beta_mode,
        )

        normals = df.smallest_axes(scales, quats)  # (N, 3)

        if cfg.mode == "sdf":
            # depth-based estimation (coarse_sdf.py:644-679)
            s_z = samples @ camera.world_view[2, :3] + camera.world_view[2, 3]
            proj_ok = s_z > 0.01  # znear
            s_map_z = df.depth_lookup_bilinear(depth_img, _project_to_pixels(samples, camera))
            sdf_est = s_map_z - s_z
            std = spatial_extent / 10.0
            err = (fields["sdf"] - sdf_est.abs()).abs() / std
            err = torch.minimum(err, err.new_tensor(10.0 * spatial_extent))
            w = proj_ok.to(torch.float32)
            sdf_loss = (err * w).sum() / torch.clamp_min(w.sum(), 1.0)
        else:
            # projection-based density estimation
            # (coarse_density.py:653-662)
            d_proj = ((samples - p.xyz[src_idx]) * normals[src_idx]).sum(dim=-1)
            beta_sq = fields["beta"] ** 2
            target = torch.exp(-0.5 * d_proj**2 / torch.maximum(beta_sq, beta_sq.new_tensor(1e-12)))
            sdf_loss = (fields["density"] - target).abs().mean()
        zero = loss.new_zeros(())
        loss = loss + torch.where(any_sampled, cfg.sdf_estimation_factor * sdf_loss, zero)

        bn = _better_normal_loss(samples, src_idx, neighbor_idx, gp, normals, cfg.density_factor)
        loss = loss + torch.where(any_sampled, cfg.sdf_better_normal_factor * bn, zero)
    with torch.no_grad():
        aux = dict(loss=loss.detach(), psnr=losses.psnr(img.detach(), gt),
                   n_visible=visible.sum(dtype=torch.int32))
    aux.update(adaptive.overflow_counters(out))
    return loss, aux


def _better_normal_loss(samples, src_idx, neighbor_idx, gp, normals, density_factor):
    """Mean of |n_s - sum_j w_j n_j|^2 over the samples (coarse_sdf.py:
    688-716): each sample's Gaussian normal against its neighbors' normals,
    sign-aligned, weighted by their opacity at the sample and the
    sample's distance along the normal over the squared smallest scale.
    The signs and the weights are constants; the gradient reaches the
    normals only."""
    cg_normals = normals[neighbor_idx]  # (S, K, 3)
    s_normals = normals[src_idx]  # (S, 3)
    with torch.no_grad():
        cg_min_scale = gp.scales.amin(dim=-1)[neighbor_idx]
        sign = torch.sign((cg_normals * s_normals[:, None]).sum(dim=-1, keepdim=True))
        cg_op = _neighbor_opacities(samples, neighbor_idx, gp, density_factor)
        nw = ((samples[:, None] - gp.centers[neighbor_idx]) * (cg_normals * sign)).sum(dim=-1).abs()
        nw = cg_op * nw / torch.clamp_min(cg_min_scale, 1e-6) ** 2
        nw = nw / torch.clamp_min(nw.sum(dim=-1), 1e-6)[:, None]
    cg_normals = cg_normals * sign
    bn = ((s_normals - (nw[..., None] * cg_normals).sum(dim=-2)) ** 2).sum(dim=-1)
    return bn.mean()


def make_coarse_step(
    cfg: CoarseConfig,
    lrs: dict[str, Callable],
    extent: float,
    capacity: int,
    with_entropy: bool,
    with_sdf: bool,
    caps: adaptive.RasterCaps,
):
    """The coarse step for one (entropy, sdf, raster caps) phase:
    ``step_fn(params, alive, adam, knn_idx, camera, gt, it, draw)`` returns
    (new params, new adam, aux); its inputs are left unchanged."""

    spatial_extent = float(extent)

    def step_fn(params, alive, adam, knn_idx, camera, gt, it, draw):
        leaves = [getattr(params, f).detach().requires_grad_(True) for f in PARAM_FIELDS]
        loss, aux = coarse_loss(
            cfg, GaussianParams(**dict(zip(PARAM_FIELDS, leaves))), alive, knn_idx, camera, gt,
            draw, spatial_extent, caps.dup_capacity, with_entropy, with_sdf,
            render_mode=cfg.render_mode, k_max=caps.k_max, tile_cap=caps.tile_cap,
            cap_a=caps.cap_a, big_cap=caps.big_cap,
        )
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        new_params, new_adam = opt.adam_step(
            params, GaussianParams(**dict(zip(PARAM_FIELDS, grads))), adam, it, lrs, cfg.optim)
        return new_params, new_adam, aux

    return step_fn


def _project_to_pixels(points: torch.Tensor, camera: Camera) -> torch.Tensor:
    """World points -> pixel coordinates via the camera's full projection."""
    h = tf.transform_points_h(camera.full_proj, points)
    ndc = h[:, :2] / torch.maximum(h[:, 3:4], h.new_tensor(1e-7))
    px = ((ndc[:, 0] + 1) * camera.width - 1) * 0.5
    py = ((ndc[:, 1] + 1) * camera.height - 1) * 0.5
    return torch.stack([px, py], dim=-1)


def _render_depth(params, alive, camera, zs, max_depth, dup_capacity, k_max,
                  mode="auto", tile_cap=None, cap_a=4, big_cap=None):
    """Depth map through the rasterizer: color channel = view z, background
    = max depth (coarse_sdf.py:578-604)."""
    out = render_params_with_colors(
        params, alive, camera, zs[:, None].expand(-1, 3),
        bg=torch.ones(3, device=zs.device) * max_depth,
        dup_capacity=dup_capacity, k_max=k_max,
        mode=mode, tile_cap=tile_cap, cap_a=cap_a, big_cap=big_cap,
    )
    return out["image"][..., 0]


def render_params_with_colors(params, alive, camera, colors, bg, dup_capacity,
                              k_max, mode="auto", tile_cap=None, cap_a=4,
                              big_cap=None):
    """Render raw params with per-Gaussian ``colors`` (N, C) in place of
    SH; differentiable in the params, the colors and ``bg``."""
    settings = dataclasses.replace(rc.from_camera(camera, bg=bg, device=params.xyz.device),
                                   sh_degree=0)
    return rasterize_gaussians(
        params.xyz,
        torch.sigmoid(params.opacity_logit),
        settings,
        scales=torch.exp(params.log_scales),
        quaternions=quat_normalize(params.quaternions),
        colors=colors,
        alive_mask=alive,
        mode=mode,
        dup_capacity=dup_capacity,
        k_max=k_max,
        tile_cap=tile_cap,
        cap_a=cap_a,
        big_cap=big_cap,
    )


@torch.no_grad()
def _neighbor_opacities(samples, neighbor_idx, gp, density_factor):
    """Per-sample, per-neighbor gaussian weights (the
    closest_gaussian_opacities field), without gradient."""
    _, w, flat = df.warp_neighbors(samples, neighbor_idx, gp)
    quad = rc.clip(w[0] * w[0] + w[1] * w[1] + w[2] * w[2], 0.0, 1e8)
    return (density_factor * gp.opacities[flat] * torch.exp(-0.5 * quad)).reshape(
        neighbor_idx.shape)


def train_coarse(
    model: GaussianModel,
    scene_cameras: list[Camera],
    scene_images: list,
    extent: float,
    cfg: CoarseConfig,
    seed: int = 0,
    log_fn: Callable[[dict], None] | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = True,
) -> GaussianModel:
    """Run the coarse stage from a trained 3DGS model (iteration 7000 ->
    15000 by default) on the model's device. ``scene_images`` are (H, W, 3)
    float arrays or tensors. The caller's model is not modified.

    With ``checkpoint_dir``, state (params, alive, Adam, KNN table,
    iteration) is saved at ``cfg.checkpoint_iterations``; with ``resume``,
    training restarts from the latest milestone replaying the camera order
    and per-iteration draws of the uninterrupted run (bit-exact on the CPU;
    on CUDA the backward's scatter-adds sum in any order). ``log_fn`` also
    gets an ``{"event": "knn"}`` record at each KNN build."""
    dev = model.device
    capacity = model.capacity
    k = cfg.knn_to_track
    adam = opt.init_adam(model.params)
    lrs = opt.group_lrs(cfg.optim, spatial_lr_scale=extent)
    cap_state = adaptive.CapState(
        adaptive.RasterCaps(
            tile_cap=16, dup_capacity=cfg.dup_capacity_mult * capacity, k_max=cfg.k_max,
        ),
        log_fn=log_fn,
    )

    params, alive = model.params, model.alive
    knn_idx = None
    start_iteration = cfg.start_iteration
    if checkpoint_dir and resume:
        latest = ckpt.latest_milestone(checkpoint_dir, before=cfg.num_iterations)
        if latest is not None and latest > start_iteration:
            like = dict(params=params, alive=alive, adam=adam,
                        knn_idx=torch.zeros((capacity, k), dtype=torch.int64, device=dev),
                        iteration=0)
            st = ckpt.restore_structured(ckpt.milestone_path(checkpoint_dir, latest), like)
            params, alive, adam = st["params"], st["alive"], st["adam"]
            knn_idx = st["knn_idx"]
            start_iteration = st["iteration"]
            if log_fn:
                log_fn({"event": "resume", "iteration": start_iteration})

    def knn_table(iteration):
        if log_fn:
            log_fn({"iter": iteration, "event": "knn"})
        return knn(params.xyz, params.xyz, k=k, ref_mask=alive)[1]

    sched = CameraSchedule(seed, len(scene_cameras))
    step_cache: dict = {}
    t0 = time.time()
    gt_cache: dict[int, torch.Tensor] = {}

    for it in range(start_iteration, cfg.num_iterations):
        iteration = it + 1  # reference counts from 1 (coarse_sdf.py:468)

        with_entropy = cfg.entropy_start < iteration < cfg.entropy_end
        with_sdf = iteration > cfg.start_sdf_estimation_from
        needs_knn = iteration > cfg.regularize_from

        if needs_knn and (knn_idx is None or iteration % cfg.reset_neighbors_every == 0):
            knn_idx = knn_table(iteration)
        if knn_idx is None:
            knn_idx = torch.zeros((capacity, k), dtype=torch.int64, device=dev)

        key = (with_entropy, with_sdf, cap_state.key())
        if key not in step_cache:
            step_cache[key] = make_coarse_step(
                cfg, lrs, extent, capacity, with_entropy, with_sdf, cap_state.caps,
            )

        ci = sched.index(it - cfg.start_iteration)
        gt = gt_cache.get(ci)
        if gt is None:
            gt = gt_cache[ci] = torch.as_tensor(scene_images[ci], dtype=torch.float32,
                                                device=dev)
        params, adam, aux = step_cache[key](
            params, alive, adam, knn_idx, scene_cameras[ci], gt, it,
            iteration_generator(seed, it, dev),
        )
        if cap_state.check_lagged(it, aux):
            step_cache.clear()

        if iteration in cfg.prune_at:
            op = torch.sigmoid(params.opacity_logit)
            alive = alive & (op >= cfg.prune_hard_opacity_threshold)
            knn_idx = knn_table(iteration)

        if checkpoint_dir and iteration in cfg.checkpoint_iterations:
            ckpt.save_milestone(
                checkpoint_dir, iteration,
                dict(params=params, alive=alive, adam=adam, knn_idx=knn_idx,
                     iteration=iteration),
            )

        if log_fn and (iteration % cfg.log_every == 0):
            log_fn(
                dict(
                    iter=iteration,
                    loss=float(aux["loss"]),
                    psnr=float(aux["psnr"]),
                    n_alive=int(alive.sum()),
                    **adaptive.logged_overflow(aux),
                    elapsed_s=time.time() - t0,
                )
            )

    return dataclasses.replace(model, params=params, alive=alive)
