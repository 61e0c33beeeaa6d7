"""Refinement training: joint mesh-vertex + surface-Gaussian optimization.

Port of ``sugar_tpu/refine/trainer.py``. Reference semantics
(sugar_trainers/refine.py:17-894): bind SuGaR to the extracted mesh
(bind_to_surface_mesh, :156-178) and optimize vertex positions, 2D scales,
in-plane rotations, opacities, SH through the rasterizer. Loss = RGB (0.8
L1 + 0.2 DSSIM) + 0.1 * mesh normal consistency (:774-783). No
densification (:173-175). Vertex LR uses the standard exponential schedule
with spatial_lr_scale = 10 * bbox_radius / sqrt(n_vertices) (:455-460);
position_lr_* are scaled by 0.01 relative to free-Gaussian training.

The step runs eagerly on the params' device with autograd over the
``BoundParams`` leaves: on CUDA tensors the render goes through the
preprocess kernel and K1, and its backward through K2, K3 and the
preprocess backward kernel (one launch of each per step); the
per-Gaussian gradients then flow through the barycentric gathers and
``matrix_to_quaternion`` into the mesh vertices.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Callable

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.io import ply as ply_io
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.api import rasterize_preprocessed
from sugar_tpu_torch.raster.preprocess import preprocess_fields
from sugar_tpu_torch.refine import bound as B
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.trainers.schedule import CameraSchedule
from sugar_tpu_torch.utils import checkpoint as ckpt
from sugar_tpu_torch.utils import losses, profiling


@dataclasses.dataclass
class RefineConfig:
    num_iterations: int = 15_000  # 'long'; 'medium'=7000, 'short'=2000
    n_gaussians_per_triangle: int = 1
    dssim_factor: float = 0.2
    normal_consistency_factor: float = 0.1
    sh_degree: int = 3
    sh_warmup_every: int = 1_000
    white_background: bool = False
    k_max: int = 1024
    dup_capacity_mult: int = 8
    # "auto" = the fused production path (the kernels on CUDA tensors).
    render_mode: str = "auto"
    log_every: int = 50
    # reference refine position lrs = vanilla * 0.01 (coarse_sdf.py bind
    # branch / refine.py).
    position_lr_init: float = 0.00016 * 0.01
    position_lr_final: float = 0.0000016 * 0.01
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15
    # Reference refine milestones (refine.py:227): 2000/7000/15000.
    checkpoint_iterations: tuple = (2_000, 7_000, 15_000)


@dataclasses.dataclass(frozen=True)
class BoundAdamState:
    mu: B.BoundParams
    nu: B.BoundParams
    count: torch.Tensor  # () int32, on the params' device


def init_bound_adam(params: B.BoundParams) -> BoundAdamState:
    def zeros():
        return B.BoundParams(**{f: torch.zeros_like(getattr(params, f)) for f in B.BOUND_FIELDS})

    return BoundAdamState(mu=zeros(), nu=zeros(),
                          count=torch.zeros((), dtype=torch.int32, device=params.vertices.device))


def bound_lrs(cfg: RefineConfig, spatial_lr_scale: float) -> dict[str, Callable]:
    sched = opt.expon_lr_schedule(
        cfg.position_lr_init * spatial_lr_scale,
        cfg.position_lr_final * spatial_lr_scale,
        30_000,
        lr_delay_mult=0.01,
    )

    def const(v):
        return lambda step: torch.tensor(v, dtype=torch.float32)

    return dict(
        vertices=sched,
        log_scales=const(cfg.scaling_lr),
        complex_rot=const(cfg.rotation_lr),
        opacity_logit=const(cfg.opacity_lr),
        sh_dc=const(cfg.feature_lr),
        sh_rest=const(cfg.feature_lr / 20.0),
    )


@torch.no_grad()
@profiling.spanned("optimizer")
def bound_adam_step(params: B.BoundParams, grads: B.BoundParams, state: BoundAdamState, step,
                    lrs: dict[str, Callable], cfg: RefineConfig):
    """One Adam update of every BoundParams field; returns new params and
    state (the inputs are not modified)."""
    count = state.count + 1
    b1, b2 = cfg.beta1, cfg.beta2
    cf = count.to(torch.float32)
    c1 = 1.0 - b1**cf
    c2 = 1.0 - b2**cf
    new_p, new_mu, new_nu = {}, {}, {}
    for name in B.BOUND_FIELDS:
        p = getattr(params, name)
        g = getattr(grads, name)
        mu = b1 * getattr(state.mu, name) + (1 - b1) * g
        nu = b2 * getattr(state.nu, name) + (1 - b2) * g * g
        lr = float(lrs[name](step))  # a float32 value; no host-to-device copy
        new_p[name] = p - lr * (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        new_mu[name] = mu
        new_nu[name] = nu
    return B.BoundParams(**new_p), BoundAdamState(
        mu=B.BoundParams(**new_mu), nu=B.BoundParams(**new_nu), count=count
    )


def render_bound(
    params: B.BoundParams,
    bm: B.BoundMesh,
    camera: Camera,
    active_sh_degree: int,
    bg: torch.Tensor,
    dup_capacity: int,
    k_max: int,
    mode: str = "auto",
    tile_cap: int | None = None,
    cap_a: int = 4,
    big_cap: int | None = None,
) -> dict:
    """Render the bound Gaussians; differentiable in every field of
    ``params``. The centres, scales and unit quaternions are built from the
    mesh (``bound.gaussians``); ``preprocess_fields`` takes them with the
    opacity logit and SH as they are (on the card the preprocess kernels'
    built instantiation)."""
    with profiling.span("bound.gaussians"):
        centers = B.gaussian_centers(params, bm)
        scales = B.gaussian_scales(params, bm)
        quats = B.gaussian_quaternions(params, bm)
    with profiling.span("render.setup"):
        settings = dataclasses.replace(
            rc.from_camera(camera, bg=bg, device=params.vertices.device),
            sh_degree=active_sh_degree,
        )
    prep = preprocess_fields(centers, params.opacity_logit, None, None, params.sh_dc,
                             params.sh_rest, settings, scales=scales, unit_quaternions=quats)
    return rasterize_preprocessed(prep, settings, mode=mode, dup_capacity=dup_capacity,
                                  k_max=k_max, tile_cap=tile_cap, cap_a=cap_a, big_cap=big_cap)


def refine_loss(
    cfg: RefineConfig,
    p: B.BoundParams,
    bm: B.BoundMesh,
    pairs: torch.Tensor,
    camera: Camera,
    gt: torch.Tensor,
    active_sh_degree: int,
    dup_capacity: int,
    k_max: int | None = None,
    render_mode: str | None = None,
    tile_cap: int | None = None,
    cap_a: int = 4,
    big_cap: int | None = None,
):
    """One view's refinement loss (RGB + normal consistency,
    refine.py:553-587, 774-783), differentiable in ``p``. Returns (loss,
    aux) with aux holding the PSNR and the render's overflow counters."""
    if k_max is None:
        k_max = cfg.k_max
    if render_mode is None:
        render_mode = cfg.render_mode
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=p.vertices.device)
    out = render_bound(
        p, bm, camera, active_sh_degree, bg, dup_capacity, k_max,
        mode=render_mode, tile_cap=tile_cap, cap_a=cap_a, big_cap=big_cap,
    )
    with profiling.span("loss"):
        img = rc.clip(out["image"], 0.0, 1.0)
        loss = losses.rgb_loss_l1_dssim(img, gt, cfg.dssim_factor)
        with profiling.span("loss.normal"):
            loss = loss + cfg.normal_consistency_factor * B.normal_consistency_loss(
                p.vertices, bm.faces, pairs
            )
        with torch.no_grad():
            aux = dict(psnr=losses.psnr(img.detach(), gt))
    aux.update(adaptive.overflow_counters(out))
    return loss, aux


def make_refine_step(
    cfg: RefineConfig,
    bm: B.BoundMesh,
    pairs: torch.Tensor,
    lrs: dict[str, Callable],
    active_sh_degree: int,
    caps: adaptive.RasterCaps,
):
    """The refine step for one (SH degree, raster caps) pair:
    ``step_fn(params, adam, camera, gt, it)`` returns (new params, new adam,
    aux) with aux holding the loss, the PSNR and the overflow counters
    (device tensors, not synced); its inputs are left unchanged."""

    @profiling.spanned("refine.step")
    def step_fn(params: B.BoundParams, adam: BoundAdamState, camera: Camera, gt, it):
        leaves = [getattr(params, f).detach().requires_grad_(True) for f in B.BOUND_FIELDS]
        loss, aux = refine_loss(
            cfg, B.BoundParams(**dict(zip(B.BOUND_FIELDS, leaves))), bm, pairs, camera, gt,
            active_sh_degree, caps.dup_capacity, k_max=caps.k_max, tile_cap=caps.tile_cap,
            cap_a=caps.cap_a, big_cap=caps.big_cap,
        )
        with profiling.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        new_params, new_adam = bound_adam_step(
            params, B.BoundParams(**dict(zip(B.BOUND_FIELDS, grads))), adam, it, lrs, cfg)
        aux["loss"] = loss.detach()
        return new_params, new_adam, aux

    return step_fn


def refined_training(
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_colors: np.ndarray | None,
    cameras: list[Camera],
    images: list,
    extent: float,
    cfg: RefineConfig = RefineConfig(),
    seed: int = 0,
    log_fn: Callable[[dict], None] | None = None,
    init_sh_dc: np.ndarray | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = True,
    device: str | torch.device = "cuda",
) -> tuple[B.BoundParams, B.BoundMesh]:
    """Run refinement on ``device``; returns the optimized bound
    parameters. ``images`` are (H, W, 3) float arrays or tensors.

    With ``checkpoint_dir``, (params, Adam, iteration) are saved at
    ``cfg.checkpoint_iterations`` (reference milestones refine.py:227);
    with ``resume`` training restarts from the latest milestone replaying
    the exact camera order (bit-exact on the CPU with one intra-op thread;
    on CUDA the backward's scatter-adds sum in any order)."""
    params, bm = B.init_bound_params(
        vertices, faces, vertex_colors,
        n_gaussians_per_triangle=cfg.n_gaussians_per_triangle,
        extent=extent, sh_degree=cfg.sh_degree, device=device,
    )
    if init_sh_dc is not None:
        params = dataclasses.replace(
            params, sh_dc=torch.as_tensor(init_sh_dc, dtype=torch.float32, device=device))
    pairs = torch.as_tensor(B.normal_consistency_pairs(faces).astype(np.int64), device=device)
    # spatial_lr_scale = 10 * bbox_radius / sqrt(V) (refine.py:455-460).
    bbox_radius = 0.5 * float(np.linalg.norm(vertices.max(0) - vertices.min(0)))
    spatial_lr_scale = 10.0 * bbox_radius / np.sqrt(max(len(vertices), 1))
    lrs = bound_lrs(cfg, spatial_lr_scale)
    adam = init_bound_adam(params)
    cap_state = adaptive.CapState(
        adaptive.RasterCaps(
            tile_cap=16,
            dup_capacity=cfg.dup_capacity_mult * params.opacity_logit.shape[0],
            k_max=cfg.k_max,
        ),
        log_fn=log_fn,
    )

    start_iteration = 0
    if checkpoint_dir and resume:
        latest = ckpt.latest_milestone(checkpoint_dir, before=cfg.num_iterations)
        if latest is not None:
            like = dict(params=params, adam=adam, iteration=0)
            st = ckpt.restore_structured(ckpt.milestone_path(checkpoint_dir, latest), like)
            params, adam = st["params"], st["adam"]
            start_iteration = st["iteration"]
            if log_fn:
                log_fn({"event": "resume", "iteration": start_iteration})

    sched = CameraSchedule(seed, len(cameras))
    step_cache: dict[tuple, Callable] = {}
    t0 = time.time()
    gt_cache: dict[int, torch.Tensor] = {}  # device-resident GT images

    for it in range(start_iteration, cfg.num_iterations):
        deg = min(it // cfg.sh_warmup_every, cfg.sh_degree)
        skey = (deg, cap_state.key())
        if skey not in step_cache:
            step_cache[skey] = make_refine_step(cfg, bm, pairs, lrs, deg, cap_state.caps)
        ci = sched.index(it)
        gt = gt_cache.get(ci)
        if gt is None:
            gt = gt_cache[ci] = torch.as_tensor(images[ci], dtype=torch.float32, device=device)
        params, adam, aux = step_cache[skey](params, adam, cameras[ci], gt, it)
        if cap_state.check_lagged(it, aux):
            step_cache.clear()
        if checkpoint_dir and (it + 1) in cfg.checkpoint_iterations:
            ckpt.save_milestone(
                checkpoint_dir, it + 1,
                dict(params=params, adam=adam, iteration=it + 1),
            )
        if log_fn and ((it + 1) % cfg.log_every == 0):
            log_fn(
                dict(
                    iter=it + 1,
                    loss=float(aux["loss"]),
                    psnr=float(aux["psnr"]),
                    **adaptive.logged_overflow(aux),
                    elapsed_s=time.time() - t0,
                )
            )
    return params, bm


@torch.no_grad()
def export_refined_ply(params: B.BoundParams, bm: B.BoundMesh, path: str) -> None:
    """Export refined Gaussians as a 3DGS PLY for the web viewer
    (refine.py:877-892 convert_refined_sugar_into_gaussians)."""
    arrs = {k: v.cpu().numpy() for k, v in B.to_gaussian_arrays(params, bm).items()}
    sh = arrs["sh"]
    ply_io.save_gaussian_ply(
        path,
        xyz=arrs["centers"],
        sh_dc=sh[:, :, 0],
        sh_rest=sh[:, :, 1:],
        opacity_logit=params.opacity_logit.cpu().numpy(),
        log_scales=np.log(np.maximum(arrs["scales"], 1e-10)),
        quaternions=arrs["quaternions"],
    )


def load_refined_state(
    state_path: str, device: str | torch.device = "cuda"
) -> tuple[B.BoundParams, B.BoundMesh]:
    """Load a refined-model ``_state.pkl`` (the pickle of numpy arrays, an
    int and a float that the JAX package's pipeline.run_refine writes) back
    into (BoundParams, BoundMesh) on ``device`` — the hybrid representation
    the reference evaluates in metrics.py:283-300."""
    from sugar_tpu_torch.interop import bound_from_numpy  # interop imports this module

    with open(state_path, "rb") as f:
        st = pickle.load(f)
    return bound_from_numpy(st, st["faces"], st["n_per_triangle"], st["thickness"], device=device)
