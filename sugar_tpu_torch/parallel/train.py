"""Sharded vanilla 3DGS train steps.

Port of ``sugar_tpu/parallel/train.py``. Two steps, as in the JAX package:

- :func:`make_sharded_train_step` over a (data, gauss) mesh. The gauss
  axis is ZeRO-style: parameters, Adam moments and densify statistics live
  as row shards; the step gathers the whole parameters over the gauss
  group, each data group renders its own view of the camera batch with the
  single-device ``models.render.render_params``, and each rank's loss is
  scaled by 1/n_data. The ranks of a gauss group render the same view, so
  the parameter gather's backward keeps this rank's rows ("replicated",
  ``comm.all_gather``); the shard gradients are then summed over the data
  group, which gives the gradient of the batch's mean loss. Adam and the
  densify statistics update the shard. The statistics take the norm of the
  summed ndc-offset gradient (``densifier.update_stats``) and the max of
  the radii over the data group.
- :func:`make_tile_sharded_train_step` over one axis: every rank renders
  the same view through ``parallel.render.render_band`` (Gaussian shards
  and tile bands), gathers the whole image and computes the same loss
  (SSIM's window crosses the bands).

Each step takes and returns this rank's shards and leaves its inputs
unchanged. The JAX steps take the camera batch sharded on ``data``; here
every rank gets the whole batch (lists of cameras and images) and renders
entry ``mesh.data.index``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from sugar_tpu_torch.core.quaternions import normalize as quat_normalize
from sugar_tpu_torch.models import densifier as dens
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianParams
from sugar_tpu_torch.models.render import render_params
from sugar_tpu_torch.parallel import comm
from sugar_tpu_torch.parallel.mesh import Axis, Mesh, gather_params, rows
from sugar_tpu_torch.parallel.render import gather_band, render_band
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.utils import losses


def sum_over(tensors: list[torch.Tensor], axis: Axis) -> list[torch.Tensor]:
    """Each tensor summed over ``axis``, in one all-reduce."""
    flat = comm.all_reduce(torch.cat([t.reshape(-1) for t in tensors]), axis)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


def _leaves(params: GaussianParams) -> list[torch.Tensor]:
    return [getattr(params, f).detach().requires_grad_(True) for f in PARAM_FIELDS]


def _grads(loss, inputs: list[torch.Tensor]) -> list[torch.Tensor]:
    gs = torch.autograd.grad(loss, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, gs)]


def make_sharded_train_step(
    mesh: Mesh,
    lrs: dict[str, Callable],
    optim_cfg: opt.OptimConfig,
    active_sh_degree: int,
    dup_capacity: int,
    k_max: int = 512,
    lambda_dssim: float = 0.2,
    white_background: bool = False,
):
    """``step_fn(params, alive, adam, stats, cams, gts, it)`` on this
    rank's shards (rows on ``mesh.gauss``); ``cams`` and ``gts`` hold one
    view per data group. Returns (params, adam, stats, aux) with aux's
    ``loss`` the batch mean on every rank."""
    nd = mesh.data.size

    def step_fn(params, alive, adam, stats, cams, gts, it):
        dev = params.xyz.device
        bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
        leaves = _leaves(params)
        whole = gather_params(GaussianParams(**dict(zip(PARAM_FIELDS, leaves))), mesh.gauss,
                              "replicated")
        alive_all = gather_params(alive, mesh.gauss)
        probe = torch.zeros((whole.xyz.shape[0], 2), device=dev, requires_grad=True)
        i = mesh.data.index
        out = render_params(whole, alive_all, cams[i], active_sh_degree, bg, ndc_offset=probe,
                            dup_capacity=dup_capacity, k_max=k_max)
        img = rc.clip(out["image"], 0.0, 1.0)
        loss = losses.rgb_loss_l1_dssim(img, torch.as_tensor(gts[i], device=dev), lambda_dssim)
        grads = _grads(loss / nd, leaves + [probe])
        summed = sum_over(grads[:-1] + [rows(grads[-1], mesh.gauss),
                                         (loss.detach() / nd).reshape(1)], mesh.data)
        radii = comm.all_reduce(rows(out["radii"], mesh.gauss), mesh.data, "max")
        new_params, new_adam = opt.adam_step(
            params, GaussianParams(**dict(zip(PARAM_FIELDS, summed[:-2]))), adam, it, lrs,
            optim_cfg)
        new_stats = dens.update_stats(stats, summed[-2], radii)
        return new_params, new_adam, new_stats, dict(loss=summed[-1][0])

    return step_fn


def make_tile_sharded_train_step(
    axis: Axis,
    lrs: dict[str, Callable],
    optim_cfg: opt.OptimConfig,
    active_sh_degree: int,
    tile_cap: int = 16,
    route_cap: int | None = None,
    k_max: int = 8192,
    lambda_dssim: float = 0.2,
    white_background: bool = False,
):
    """``step_fn(params, alive, adam, stats, cam, gt, it)`` on this rank's
    shards (rows on ``axis``), every rank cooperating on the one view.
    Returns (params, adam, stats, aux) with aux holding the loss and the
    three overflow counters (any nonzero count means dropped slots)."""

    def step_fn(params, alive, adam, stats, cam, gt, it):
        dev = params.xyz.device
        bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
        settings = dataclasses.replace(rc.from_camera(cam, bg=bg, device=dev),
                                       sh_degree=active_sh_degree)
        leaves = _leaves(params)
        p = GaussianParams(**dict(zip(PARAM_FIELDS, leaves)))
        probe = torch.zeros((p.xyz.shape[0], 2), device=dev, requires_grad=True)
        k = (active_sh_degree + 1) ** 2
        sh = torch.cat([p.sh_dc[:, :, None], p.sh_rest], dim=-1)
        out = render_band(
            axis, p.xyz.shape[0] * axis.size, p.xyz, torch.sigmoid(p.opacity_logit), settings,
            scales_l=torch.exp(p.log_scales), quats_l=quat_normalize(p.quaternions),
            shs_l=sh[:, :, :k], alive_l=alive, ndc_l=probe, tile_cap=tile_cap,
            route_cap=route_cap, k_max=k_max,
        )
        img = rc.clip(gather_band(out["image"], axis, settings), 0.0, 1.0)
        loss = losses.rgb_loss_l1_dssim(img, torch.as_tensor(gt, device=dev), lambda_dssim)
        grads = _grads(loss, leaves + [probe])
        new_params, new_adam = opt.adam_step(
            params, GaussianParams(**dict(zip(PARAM_FIELDS, grads[:-1]))), adam, it, lrs,
            optim_cfg)
        new_stats = dens.update_stats(stats, grads[-1], out["radii"])
        return new_params, new_adam, new_stats, dict(
            loss=loss.detach(), route_overflow=out["route_overflow"],
            tile_overflow=out["tile_overflow"], kmax_overflow=out["kmax_overflow"])

    return step_fn
