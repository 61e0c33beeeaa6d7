"""Per-group Adam optimizer for Gaussian parameters.

Port of ``sugar_tpu/trainers/optimizer.py`` (reference semantics:
sugar_scene/sugar_optimizer.py:67-109 and gaussian_model.py:149-175): Adam
with eps=1e-15, named parameter groups with their own learning rates
(sh_rest lr = sh lr / 20), and an exponential position-LR schedule scaled
by ``spatial_lr_scale``.

Adam is written out in tensor ops, not ``torch.optim``, so densification
can do the reference's "optimizer surgery" (zeroing the moments of the
slots it writes) slot by slot, as plain tensor scatters. The bias
correction uses the global step count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from sugar_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianParams
from sugar_tpu_torch.utils import profiling


def expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    max_steps: int,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
) -> Callable[[int], torch.Tensor]:
    """get_expon_lr_func (sugar_utils/general_utils.py:24-56): log-linear
    interpolation from lr_init to lr_final, optional delayed warmup. The
    schedule returns a float32 () tensor, computed in float32 as the JAX
    package computes it."""

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        log_lerp = torch.exp(
            math.log(max(lr_init, 1e-30)) * (1 - t) + math.log(max(lr_final, 1e-30)) * t
        )
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0)
            )
        else:
            delay_rate = 1.0
        lr = delay_rate * log_lerp
        if lr_init == 0.0 and lr_final == 0.0:
            return torch.zeros_like(lr)
        return lr

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Learning rates; defaults = reference OptimizationParams
    (gaussian_splatting/arguments/__init__.py + gs_model.py:33-61)."""

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15


@dataclasses.dataclass(frozen=True)
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    count: torch.Tensor  # () int32, on the params' device


def init_adam(params: GaussianParams) -> AdamState:
    zeros = {f: torch.zeros_like(getattr(params, f)) for f in PARAM_FIELDS}
    return AdamState(
        mu=GaussianParams(**zeros),
        nu=GaussianParams(**{f: torch.zeros_like(v) for f, v in zeros.items()}),
        count=torch.zeros((), dtype=torch.int32, device=params.xyz.device),
    )


def group_lrs(cfg: OptimConfig, spatial_lr_scale: float) -> dict[str, Callable]:
    """Per-field LR schedules (constant except xyz)."""
    xyz_sched = expon_lr_schedule(
        cfg.position_lr_init * spatial_lr_scale,
        cfg.position_lr_final * spatial_lr_scale,
        cfg.position_lr_max_steps,
        lr_delay_mult=cfg.position_lr_delay_mult,
    )

    def const(v):
        return lambda step: torch.tensor(v, dtype=torch.float32)

    return dict(
        xyz=xyz_sched,
        sh_dc=const(cfg.feature_lr),
        sh_rest=const(cfg.feature_lr / 20.0),
        opacity_logit=const(cfg.opacity_lr),
        log_scales=const(cfg.scaling_lr),
        quaternions=const(cfg.rotation_lr),
    )


@torch.no_grad()
@profiling.spanned("optimizer")
def adam_step(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    step,
    lrs: dict[str, Callable],
    cfg: OptimConfig,
) -> tuple[GaussianParams, AdamState]:
    """One Adam update; returns new params and state (the inputs are not
    modified). Per-slot moments; the bias correction uses the global step
    count (the densifier zeroes the moments of the slots it writes, as the
    reference's cat_tensors_to_optimizer does)."""
    count = state.count + 1
    b1, b2 = cfg.beta1, cfg.beta2
    cf = count.to(torch.float32)
    c1 = 1.0 - b1**cf
    c2 = 1.0 - b2**cf

    new_p, new_mu, new_nu = {}, {}, {}
    for name in PARAM_FIELDS:
        p = getattr(params, name)
        g = getattr(grads, name)
        mu = b1 * getattr(state.mu, name) + (1 - b1) * g
        nu = b2 * getattr(state.nu, name) + (1 - b2) * g * g
        lr = float(lrs[name](step))  # a float32 value; no host-to-device copy
        upd = lr * (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        new_p[name] = p - upd
        new_mu[name] = mu
        new_nu[name] = nu
    return (
        GaussianParams(**new_p),
        AdamState(mu=GaussianParams(**new_mu), nu=GaussianParams(**new_nu), count=count),
    )
