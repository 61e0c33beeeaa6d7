"""Sharded coarse-SuGaR training (SDF / density regularization).

Port of ``sugar_tpu/parallel/coarse.py``. The mesh layout is the vanilla
step's (``parallel.train``): parameters, Adam moments and the KNN table
are row shards on ``gauss``, and each data group renders its own view and
draws its own SDF samples. The loss body is ``trainers.coarse.coarse_loss``
itself, on the parameters and the KNN table gathered over the gauss
group; each rank's loss is scaled by 1/n_data and the shard gradients are
summed over the data group.

Each view's sample draw is keyed by its per-view iteration (the view of
data group j at step ``it`` draws from ``iteration_generator(seed, it +
j)``; ``coarse.py:182-184``), so a view's draw does not depend on the rank
count; the step takes the draws as an argument (tests feed the JAX
package's). The KNN refresh and the prune-time rebuild run the ring search
(``parallel.knn.knn_sharded``) over every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel, GaussianParams
from sugar_tpu_torch.parallel import comm
from sugar_tpu_torch.parallel.knn import knn_sharded
from sugar_tpu_torch.parallel.launch import kernel_launches, launches_by_rank, to_device
from sugar_tpu_torch.parallel.mesh import Mesh, gather_params, make_mesh, rows, shard_params
from sugar_tpu_torch.parallel.train import _grads, _leaves, sum_over
from sugar_tpu_torch.parallel.trainer import ViewOrder
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.trainers.coarse import CoarseConfig, coarse_loss
from sugar_tpu_torch.trainers.schedule import iteration_generator


def make_sharded_coarse_step(
    mesh: Mesh,
    cfg: CoarseConfig,
    lrs: dict[str, Callable],
    extent: float,
    dup_capacity: int,
    with_entropy: bool,
    with_sdf: bool,
):
    """``step_fn(params, alive, adam, knn_idx, cams, gts, it, draws)`` on
    this rank's shards; ``cams``, ``gts`` and ``draws`` hold one entry per
    data group. Returns (params, adam, aux) with aux's loss and PSNR the
    batch means, n_visible the max and the overflow counters the sums."""
    nd = mesh.data.size
    spatial_extent = float(extent)

    def step_fn(params, alive, adam, knn_idx, cams, gts, it, draws):
        dev = params.xyz.device
        leaves = _leaves(params)
        whole = gather_params(GaussianParams(**dict(zip(PARAM_FIELDS, leaves))), mesh.gauss,
                              "replicated")
        i = mesh.data.index
        loss, aux = coarse_loss(
            cfg, whole, gather_params(alive, mesh.gauss), gather_params(knn_idx, mesh.gauss),
            cams[i], torch.as_tensor(gts[i], device=dev), draws[i], spatial_extent,
            dup_capacity, with_entropy, with_sdf,
        )
        grads = _grads(loss / nd, leaves)
        ovf = torch.stack([torch.as_tensor(aux.get(k, 0), device=dev).to(torch.float32)
                           for k in ("bin_overflow", "tile_overflow")])
        summed = sum_over(grads + [(loss.detach() / nd).reshape(1),
                                   (aux["psnr"] / nd).reshape(1), ovf], mesh.data)
        n_vis = comm.all_reduce(aux["n_visible"].reshape(1), mesh.data, "max")
        new_params, new_adam = opt.adam_step(
            params, GaussianParams(**dict(zip(PARAM_FIELDS, summed[:-3]))), adam, it, lrs,
            cfg.optim)
        return new_params, new_adam, dict(
            loss=summed[-3][0], psnr=summed[-2][0], n_visible=n_vis[0],
            bin_overflow=summed[-1][0].to(torch.int64), tile_overflow=summed[-1][1].to(torch.int64))

    return step_fn


def train_coarse_sharded(
    mesh: Mesh,
    model: GaussianModel,
    scene_cameras: list[Camera],
    scene_images: list,
    extent: float,
    cfg: CoarseConfig,
    seed: int = 0,
    log_fn: Callable[[dict], None] | None = None,
) -> GaussianModel:
    """The sharded coarse loop on this rank (every rank calls it with the
    same whole ``model``); returns the whole model on every rank.
    Iterations count per-view updates, so the schedule's boundaries
    (entropy window, prune, SDF start, KNN cadence) fall where the
    single-device loop's do."""
    dev = model.device
    n_data = mesh.data.size
    capacity = model.capacity
    lrs = opt.group_lrs(cfg.optim, spatial_lr_scale=extent)
    dup_capacity = cfg.dup_capacity_mult * capacity
    params = shard_params(model.params, mesh.gauss)
    adam = shard_params(opt.init_adam(model.params), mesh.gauss)
    alive = shard_params(model.alive, mesh.gauss)
    knn_idx = None

    def knn_table():
        xyz = comm.all_gather(params.xyz, mesh.gauss)
        _, ki = knn_sharded(mesh.world, xyz, xyz, k=cfg.knn_to_track,
                            ref_mask=gather_params(alive, mesh.gauss))
        return rows(ki, mesh.gauss).contiguous()

    order = ViewOrder(seed, len(scene_cameras))
    step_cache: dict = {}
    gt_cache: dict[int, torch.Tensor] = {}
    t0 = time.time()
    it = cfg.start_iteration
    while it < cfg.num_iterations:
        iteration = it + 1
        with_entropy = cfg.entropy_start < iteration < cfg.entropy_end
        with_sdf = iteration > cfg.start_sdf_estimation_from
        needs_knn = iteration > cfg.regularize_from
        if needs_knn and (knn_idx is None or (iteration % cfg.reset_neighbors_every) < n_data):
            knn_idx = knn_table()
        if knn_idx is None:
            knn_idx = torch.zeros((params.xyz.shape[0], cfg.knn_to_track), dtype=torch.int64,
                                  device=dev)
        key = (with_entropy, with_sdf)
        if key not in step_cache:
            step_cache[key] = make_sharded_coarse_step(mesh, cfg, lrs, extent, dup_capacity,
                                                       with_entropy, with_sdf)
        batch = order.take(n_data)
        for ci in batch:
            if ci not in gt_cache:
                gt_cache[ci] = torch.as_tensor(scene_images[ci], dtype=torch.float32, device=dev)
        params, adam, aux = step_cache[key](
            params, alive, adam, knn_idx, [scene_cameras[ci] for ci in batch],
            [gt_cache[ci] for ci in batch], it,
            [iteration_generator(seed, it + j, dev) for j in range(n_data)])

        prev_it = it
        it += n_data
        for p_at in cfg.prune_at:
            if prev_it < p_at <= it:
                alive = alive & (torch.sigmoid(params.opacity_logit)
                                 >= cfg.prune_hard_opacity_threshold)
                knn_idx = knn_table()

        if log_fn and ((it % max(cfg.log_every, 1)) < n_data):
            log_fn(dict(iter=it, loss=float(aux["loss"]), psnr=float(aux["psnr"]),
                        n_alive=int(comm.all_reduce(alive.sum().reshape(1), mesh.gauss)[0]),
                        elapsed_s=time.time() - t0, mesh=str(mesh.shape)))

    return dataclasses.replace(model, params=gather_params(params, mesh.gauss),
                               alive=gather_params(alive, mesh.gauss))


def coarse_rank(device, model, cameras, images, extent, cfg, n_data, n_gauss, seed=0):
    """``parallel.launch.run_ranks`` entry: the sharded coarse loop on
    this rank; returns (model, the log records of rank 0, the last of
    them every rank's K1-K3 and binning launches)."""
    since = kernel_launches()
    logs: list[dict] = []
    mesh = make_mesh(n_data=n_data, n_gauss=n_gauss, device=device)
    model = train_coarse_sharded(mesh, to_device(model, device), to_device(cameras, device),
                                 images, extent, cfg, seed=seed, log_fn=logs.append)
    logs.append(dict(event="kernel_launches", per_rank=launches_by_rank(since)))
    return model, logs
