"""Sharded refinement: the mesh-bound joint optimization over a mesh.

Port of ``sugar_tpu/parallel/refine.py``. The layout of the vanilla step
(``parallel.train``): every ``BoundParams`` leaf whose dim 0 divides by
the gauss size (the vertices and the per-Gaussian buffers, with their Adam
moments) is a row shard on ``gauss``, the others are replicated
(``refine.py:42-55``); each data group renders its own view with the
single-device ``refine.trainer.refine_loss`` on the leaves gathered over
the gauss group, each rank's loss is scaled by 1/n_data, and the
gradients are summed over the data group.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sugar_tpu_torch.parallel import comm
from sugar_tpu_torch.parallel.launch import kernel_launches, launches_by_rank, to_device
from sugar_tpu_torch.parallel.mesh import Axis, Mesh, make_mesh, rows
from sugar_tpu_torch.parallel.train import _grads, sum_over
from sugar_tpu_torch.parallel.trainer import ViewOrder
from sugar_tpu_torch.refine import bound as B
from sugar_tpu_torch.refine.trainer import (
    BoundAdamState,
    RefineConfig,
    bound_adam_step,
    bound_lrs,
    init_bound_adam,
    refine_loss,
)


def shard_bound_state(
    axis: Axis, params: B.BoundParams, adam: BoundAdamState
) -> tuple[B.BoundParams, BoundAdamState, dict[str, bool]]:
    """This rank's rows of every leaf whose dim 0 divides by the axis size
    (the rest whole), for the params and the Adam moments; and which
    fields are sharded."""
    sharded = {f: getattr(params, f).shape[0] > 0
               and getattr(params, f).shape[0] % axis.size == 0 for f in B.BOUND_FIELDS}

    def place(p):
        return B.BoundParams(**{f: rows(getattr(p, f), axis).contiguous() if sharded[f]
                                else getattr(p, f) for f in B.BOUND_FIELDS})

    return place(params), BoundAdamState(mu=place(adam.mu), nu=place(adam.nu),
                                         count=adam.count), sharded


def gather_bound(params: B.BoundParams, axis: Axis, sharded: dict[str, bool],
                 backward: str = "replicated") -> B.BoundParams:
    return B.BoundParams(**{
        f: comm.all_gather(getattr(params, f), axis, 0, backward) if sharded[f]
        else getattr(params, f) for f in B.BOUND_FIELDS})


def make_sharded_refine_step(
    mesh: Mesh,
    cfg: RefineConfig,
    bm: B.BoundMesh,
    pairs: torch.Tensor,
    lrs: dict,
    active_sh_degree: int,
    dup_capacity: int,
    sharded: dict[str, bool],
):
    """``step_fn(params, adam, cams, gts, it)`` on this rank's leaves
    (``shard_bound_state``); ``cams``, ``gts`` hold one view per data
    group. Returns (params, adam, aux) with aux's loss and PSNR the batch
    means and the overflow counters the sums."""
    nd = mesh.data.size

    def step_fn(params, adam, cams, gts, it):
        dev = params.vertices.device
        leaves = [getattr(params, f).detach().requires_grad_(True) for f in B.BOUND_FIELDS]
        whole = gather_bound(B.BoundParams(**dict(zip(B.BOUND_FIELDS, leaves))), mesh.gauss,
                             sharded)
        i = mesh.data.index
        loss, aux = refine_loss(cfg, whole, bm, pairs, cams[i],
                                torch.as_tensor(gts[i], device=dev), active_sh_degree,
                                dup_capacity, k_max=cfg.k_max)
        grads = _grads(loss / nd, leaves)
        ovf = torch.stack([torch.as_tensor(aux.get(k, 0), device=dev).to(torch.float32)
                           for k in ("bin_overflow", "tile_overflow")])
        summed = sum_over(grads + [(loss.detach() / nd).reshape(1),
                                   (aux["psnr"] / nd).reshape(1), ovf], mesh.data)
        new_params, new_adam = bound_adam_step(
            params, B.BoundParams(**dict(zip(B.BOUND_FIELDS, summed[:-3]))), adam, it, lrs, cfg)
        return new_params, new_adam, dict(
            loss=summed[-3][0], psnr=summed[-2][0],
            bin_overflow=summed[-1][0].to(torch.int64), tile_overflow=summed[-1][1].to(torch.int64))

    return step_fn


def refined_training_sharded(
    mesh: Mesh,
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_colors: np.ndarray | None,
    cameras: list,
    images: list,
    extent: float,
    cfg: RefineConfig,
    seed: int = 0,
    log_fn=None,
) -> tuple[B.BoundParams, B.BoundMesh]:
    """The sharded refinement loop on this rank (every rank calls it with
    the same arguments): each step consumes n_data views, iterations count
    per-view updates (the SH warmup falls where the single-device loop's
    does). Returns the whole (BoundParams, BoundMesh) on every rank."""
    dev = mesh.device
    n_data = mesh.data.size
    params0, bm = B.init_bound_params(
        vertices, faces, vertex_colors, n_gaussians_per_triangle=cfg.n_gaussians_per_triangle,
        extent=extent, sh_degree=cfg.sh_degree, device=dev)
    pairs = torch.as_tensor(B.normal_consistency_pairs(np.asarray(faces)).astype(np.int64),
                            device=dev)
    bbox_radius = 0.5 * float(np.linalg.norm(np.asarray(vertices).max(0)
                                             - np.asarray(vertices).min(0)))
    spatial_lr_scale = 10.0 * bbox_radius / np.sqrt(max(len(vertices), 1))
    lrs = bound_lrs(cfg, spatial_lr_scale)
    params, adam, sharded = shard_bound_state(mesh.gauss, params0, init_bound_adam(params0))
    dup_capacity = cfg.dup_capacity_mult * params0.opacity_logit.shape[0]

    order = ViewOrder(seed, len(cameras))
    step_cache: dict = {}
    gt_cache: dict[int, torch.Tensor] = {}
    t0 = time.time()
    it = 0
    while it < cfg.num_iterations:
        deg = min(it // cfg.sh_warmup_every, cfg.sh_degree)
        if deg not in step_cache:
            step_cache[deg] = make_sharded_refine_step(mesh, cfg, bm, pairs, lrs, deg,
                                                       dup_capacity, sharded)
        batch = order.take(n_data)
        for ci in batch:
            if ci not in gt_cache:
                gt_cache[ci] = torch.as_tensor(np.asarray(images[ci]), dtype=torch.float32,
                                               device=dev)
        params, adam, aux = step_cache[deg](params, adam, [cameras[ci] for ci in batch],
                                            [gt_cache[ci] for ci in batch], it)
        it += n_data
        if log_fn and ((it % max(cfg.log_every, 1)) < n_data):
            log_fn(dict(iter=it, loss=float(aux["loss"]), psnr=float(aux["psnr"]),
                        elapsed_s=time.time() - t0, mesh=str(mesh.shape)))
    return gather_bound(params, mesh.gauss, sharded), bm


def refine_rank(device, vertices, faces, vertex_colors, cameras, images, extent, cfg, n_data,
                n_gauss, seed=0):
    """``parallel.launch.run_ranks`` entry: the sharded refinement on this
    rank; returns ((params, bm), the log records of rank 0, the last of
    them every rank's K1-K3 and binning launches)."""
    since = kernel_launches()
    logs: list[dict] = []
    mesh = make_mesh(n_data=n_data, n_gauss=n_gauss, device=device)
    out = refined_training_sharded(mesh, vertices, faces, vertex_colors,
                                   to_device(cameras, device), images, extent, cfg, seed=seed,
                                   log_fn=logs.append)
    logs.append(dict(event="kernel_launches", per_rank=launches_by_rank(since)))
    return out, logs
