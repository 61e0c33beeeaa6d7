"""Sharded vanilla 3DGS training loop.

Port of ``sugar_tpu/parallel/trainer.py``: each optimizer step consumes
``n_data`` views (one per data group) with the Gaussian buffers sharded
over ``gauss`` (``parallel.train.make_sharded_train_step``).
``iterations`` counts per-view updates, so the loop takes iterations /
n_data steps, and the camera order is the JAX loop's (a numpy permutation
per epoch, consumed from the back). Densify and prune run as a global
pass: gather the shards, run ``models.densifier.densify_and_prune`` (every
rank the same pass on the same data), take the shards again. As in the
JAX loop there is no opacity reset, milestone or cap growth.

The split noise is an argument, as in the single-device trainer: by
default ``torch.randn`` from ``iteration_generator(seed, it)``.

:func:`train_vanilla_sharded` runs inside the ranks of a
``torch.distributed`` group; :func:`vanilla_rank` is the function a
single-controller caller hands to ``parallel.launch.run_ranks``.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.models import densifier as dens
from sugar_tpu_torch.models.gaussians import GaussianModel, create_from_pcd
from sugar_tpu_torch.parallel.launch import kernel_launches, launches_by_rank, to_device
from sugar_tpu_torch.parallel.mesh import gather_params, make_mesh, shard_params
from sugar_tpu_torch.parallel.train import make_sharded_train_step
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.trainers.schedule import iteration_generator
from sugar_tpu_torch.trainers.vanilla import TrainConfig


class ViewOrder:
    """The JAX sharded loops' camera order: ``take(k)`` pops k indices
    from the back of a numpy permutation, drawing a new one per epoch."""

    def __init__(self, seed: int, n_cameras: int):
        self._rng = np.random.default_rng(seed)
        self._n = n_cameras
        self._order: list[int] = []

    def take(self, k: int) -> list[int]:
        out = []
        while len(out) < k:
            if not self._order:
                self._order = list(self._rng.permutation(self._n))
            out.append(int(self._order.pop()))
        return out


def train_vanilla_sharded(
    scene_cameras: list[Camera],
    scene_images: list,
    points: np.ndarray,
    colors: np.ndarray,
    extent: float,
    cfg: TrainConfig,
    n_data: int | None = None,
    n_gauss: int | None = None,
    seed: int = 0,
    log_fn: Callable[[dict], None] | None = None,
    split_noise: Callable[[int], torch.Tensor] | None = None,
    device: str | torch.device = "cuda",
) -> GaussianModel:
    """The sharded loop on this rank (every rank of the default group
    calls it with the same arguments); returns the whole model on every
    rank. ``split_noise(it)`` gives the (2, capacity, 3) standard normals
    of the densify pass after per-view iteration ``it``."""
    dev = torch.device(device)
    mesh = make_mesh(n_data=n_data, n_gauss=n_gauss, device=dev)
    n_data = mesh.data.size
    model = create_from_pcd(points, colors, cfg.capacity, sh_degree=cfg.sh_degree, device=dev)
    lrs = opt.group_lrs(cfg.optim, spatial_lr_scale=extent)
    dup_capacity = cfg.dup_capacity_mult * cfg.capacity
    if split_noise is None:
        def split_noise(it):
            return torch.randn((2, cfg.capacity, 3), generator=iteration_generator(seed, it, dev),
                               device=dev)

    params = shard_params(model.params, mesh.gauss)
    adam = shard_params(opt.init_adam(model.params), mesh.gauss)
    stats = shard_params(dens.DensifyStats.zeros(cfg.capacity, device=dev), mesh.gauss)
    alive = shard_params(model.alive, mesh.gauss)

    order = ViewOrder(seed, len(scene_cameras))
    step_cache: dict[int, Callable] = {}
    gt_cache: dict[int, torch.Tensor] = {}
    t0 = time.time()
    n_steps = max(cfg.iterations // n_data, 1)
    for step_i in range(n_steps):
        it = step_i * n_data
        deg = min(it // cfg.sh_warmup_every, cfg.sh_degree)
        if deg not in step_cache:
            step_cache[deg] = make_sharded_train_step(
                mesh, lrs, cfg.optim, deg, dup_capacity, k_max=cfg.k_max,
                lambda_dssim=cfg.lambda_dssim, white_background=cfg.white_background)
        batch = order.take(n_data)
        for ci in batch:
            if ci not in gt_cache:
                gt_cache[ci] = torch.as_tensor(scene_images[ci], dtype=torch.float32, device=dev)
        params, adam, stats, aux = step_cache[deg](
            params, alive, adam, stats, [scene_cameras[ci] for ci in batch],
            [gt_cache[ci] for ci in batch], it)

        it1 = it + n_data
        if cfg.densify_from < it1 <= cfg.densify_until and (
            step_i % max(cfg.densify_every // n_data, 1) == 0 and step_i > 0
        ):
            whole = GaussianModel(gather_params(params, mesh.gauss),
                                  gather_params(alive, mesh.gauss), model.sh_degree)
            mss = cfg.prune_max_screen if it1 > cfg.opacity_reset_every else None
            whole, adam_w, stats_w, _ = dens.densify_and_prune(
                whole, gather_params(adam, mesh.gauss), gather_params(stats, mesh.gauss),
                split_noise(it1), extent,
                grad_threshold=cfg.densify_grad_threshold,
                min_opacity=cfg.prune_min_opacity,
                max_screen_size=mss,
                percent_dense=cfg.percent_dense,
            )
            params, alive = shard_params(whole.params, mesh.gauss), shard_params(
                whole.alive, mesh.gauss)
            adam, stats = shard_params(adam_w, mesh.gauss), shard_params(stats_w, mesh.gauss)

        if log_fn and (step_i % max(cfg.log_every // n_data, 1) == 0):
            log_fn(dict(iter=it1, loss=float(aux["loss"]), elapsed_s=time.time() - t0,
                        mesh=str(mesh.shape)))

    return GaussianModel(gather_params(params, mesh.gauss), gather_params(alive, mesh.gauss),
                         model.sh_degree)


def vanilla_rank(device, cameras, images, points, colors, extent, cfg, n_data, n_gauss,
                 seed=0):
    """``parallel.launch.run_ranks`` entry: the sharded loop on this rank;
    returns (model, the log records of rank 0, the last of them every
    rank's K1-K3 and binning launches)."""
    since = kernel_launches()
    logs: list[dict] = []
    model = train_vanilla_sharded(
        to_device(cameras, device), images, points, colors, extent, cfg, n_data=n_data,
        n_gauss=n_gauss, seed=seed, log_fn=logs.append, device=device)
    logs.append(dict(event="kernel_launches", per_rank=launches_by_rank(since)))
    return model, logs
