"""Level-set point collection with the cameras spread over ranks.

Port of ``sugar_tpu/parallel/meshing.py``. The per-camera level set
(``meshing.levelset.level_surface_points_one_camera``: depth render, KNN,
ray samples, density) is independent per camera, so the cameras go to the
ranks in groups of ``world`` (rank i takes camera b0 + i; the last group
is padded with its last camera and the padding's results dropped), each
rank holding the whole model. Each camera's valid points come back to the
caller in camera order, and the caller draws the per-camera subsample
from ``rng`` in that order: the cloud equals the single-device
``meshing.levelset.collect_surface_points`` for any rank count.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from sugar_tpu_torch.meshing.levelset import level_surface_points_one_camera
from sugar_tpu_torch.models.gaussians import GaussianModel
from sugar_tpu_torch.parallel.launch import kernel_launches, launches_by_rank, run_ranks, to_device
from sugar_tpu_torch.parallel.mesh import world_axis
from sugar_tpu_torch.raster import adaptive


def level_set_rank(device, model: GaussianModel, cameras: list, surface_level: float,
                   dup_capacity: int, k_max: int) -> tuple[list[dict], list]:
    """``parallel.launch.run_ranks`` entry: this rank's cameras of each
    group; returns, on rank 0, every camera's valid pixel indices with
    their points, normals and Gaussian ids (host numpy) and its depth
    render's overflow counters, in camera order, and every rank's K1-K3
    and binning launches."""
    since = kernel_launches()
    axis = world_axis()
    model = to_device(model, device)
    cameras = to_device(cameras, device)
    per_cam: list[dict] = []
    for b0 in range(0, len(cameras), axis.size):
        group = cameras[b0:b0 + axis.size]
        n_real = len(group)
        cam = group[min(axis.index, n_real - 1)]
        out = level_surface_points_one_camera(model.params, model.alive, cam,
                                              surface_level=surface_level,
                                              dup_capacity=dup_capacity, k_max=k_max)
        idx = torch.nonzero(out["valid"])[:, 0]
        mine = dict(idx=idx.cpu().numpy(),
                    **{k: out[k][idx].cpu().numpy() for k in ("points", "normals",
                                                               "gaussian_idx")},
                    overflow=adaptive.read_overflow(out))
        got = [None] * axis.size
        dist.all_gather_object(got, mine, group=axis.group)
        per_cam.extend(got[:n_real])
    return per_cam, launches_by_rank(since)


def collect_surface_points_sharded(
    world: int,
    model: GaussianModel,
    cameras: list,
    surface_level: float = 0.3,
    total_points: int = 10_000_000,
    rng: np.random.Generator | None = None,
    dup_capacity: int = 2**22,
    k_max: int = 1024,
    colors_per_gaussian: np.ndarray | None = None,
    device: str = "cuda",
) -> dict:
    """Sharded drop-in for ``meshing.levelset.collect_surface_points``
    over ``world`` ranks on ``device`` ("cuda" or "cpu"), called by a
    single controller: it starts the ranks (``parallel.launch``) and
    subsamples on the caller's side. The result also holds ``launches``,
    every rank's K1-K3 and binning launches."""
    if not isinstance(world, int):
        raise TypeError(f"world must be a number of ranks, got {type(world).__name__}")
    rng = rng or np.random.default_rng(0)
    per_cam = total_points // max(len(cameras), 1)
    outs, launches = run_ranks(level_set_rank, world, device=device,
                               args=(model, cameras, surface_level, dup_capacity, k_max))
    pts, nrm, gid, cols, ovf = [], [], [], [], []
    for out in outs:
        idx = out["idx"]
        pos = np.arange(len(idx))
        if len(idx) > per_cam:
            pos = np.searchsorted(idx, rng.choice(idx, size=per_cam, replace=False))
        pts.append(out["points"][pos])
        nrm.append(out["normals"][pos])
        g = out["gaussian_idx"][pos]
        gid.append(g)
        if colors_per_gaussian is not None:
            cols.append(colors_per_gaussian[g])
        ovf.append(out["overflow"])
    return dict(
        points=np.concatenate(pts) if pts else np.zeros((0, 3), np.float32),
        normals=np.concatenate(nrm) if nrm else np.zeros((0, 3), np.float32),
        gaussian_idx=np.concatenate(gid) if gid else np.zeros((0,), np.int64),
        colors=np.concatenate(cols) if cols else None,
        overflow=ovf,
        launches=launches,
    )
