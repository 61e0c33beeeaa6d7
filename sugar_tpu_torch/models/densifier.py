"""Static-shape densification: clone / split / prune / opacity-reset.

Port of ``sugar_tpu/models/densifier.py`` (reference semantics:
sugar_scene/sugar_densifier.py:156-251 and gaussian_model.py:282-407).
Gaussians live in fixed-capacity tensors with an ``alive`` mask: clone and
split write children into dead slots found by a stable sort (a free list
on the device), and the Adam moments of every written slot are zeroed, as
the reference's cat_tensors_to_optimizer / _prune_optimizer surgery does.

Criteria (thresholds identical to the reference):
- densify: mean screen-space NDC-grad norm >= grad_threshold (0.0002);
  clone if max(scale) <= percent_dense * extent, else split into n_split=2
  children sampled from the Gaussian, scales / (0.8 n_split), parent
  pruned.
- prune: opacity < min_opacity (0.005), or (when screen-size pruning is on)
  2D radius > max_screen px or world scale > 0.1 * extent.
- reset_opacity: clamp opacity to <= 0.01 and zero the opacity moments.

More candidates than free slots: the lowest-priority candidates are
dropped (``n_dropped``). The split noise is an argument, so a test can feed
in the JAX package's ``jax.random`` draw.
"""

from __future__ import annotations

import dataclasses

import torch

from sugar_tpu_torch.core.quaternions import normalize as quat_normalize
from sugar_tpu_torch.core.quaternions import quaternion_to_matrix
from sugar_tpu_torch.models.gaussians import (
    PARAM_FIELDS,
    GaussianModel,
    GaussianParams,
    inverse_sigmoid,
)
from sugar_tpu_torch.trainers.optimizer import AdamState
from sugar_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class DensifyStats:
    """Accumulated screen-space gradient stats (sugar_densifier.py:134-164)."""

    grad_accum: torch.Tensor  # (N,) sum of NDC-grad norms
    denom: torch.Tensor  # (N,) number of visible updates
    max_radii: torch.Tensor  # (N,) float32 max 2D radius seen

    @staticmethod
    def zeros(capacity: int, device: str | torch.device = "cuda") -> "DensifyStats":
        z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)  # noqa: E731
        return DensifyStats(grad_accum=z(), denom=z(), max_radii=z())


@torch.no_grad()
@profiling.spanned("densify.stats")
def update_stats(
    stats: DensifyStats, ndc_grad: torch.Tensor, radii: torch.Tensor
) -> DensifyStats:
    """Accumulate after a backward pass; ``ndc_grad`` is the gradient of the
    rasterizer's ndc_offset (= CUDA viewspace_point_tensor.grad)."""
    visible = radii > 0
    g = ndc_grad[:, :2]
    norm = torch.sqrt((g * g).sum(dim=-1))
    return DensifyStats(
        grad_accum=stats.grad_accum + torch.where(visible, norm, 0.0),
        denom=stats.denom + visible.to(torch.float32),
        max_radii=torch.maximum(
            stats.max_radii, torch.where(visible, radii.to(torch.float32), 0.0)
        ),
    )


def _alloc_slots(free_mask: torch.Tensor, want_mask: torch.Tensor, priority: torch.Tensor):
    """Map the i-th wanted slot (by descending priority) to the i-th free
    slot. Returns (dest (N,) int64, N where not granted; granted (N,) bool
    aligned with want_mask)."""
    n = free_mask.shape[0]
    n_free = free_mask.sum()
    # Free slots in index order (the bool key sorts as uint8, stably).
    free_order = torch.sort((~free_mask).to(torch.uint8), stable=True).indices
    # Rank wanted slots by priority (desc) so overflow drops the weakest.
    neg_prio = torch.where(want_mask, -priority, torch.inf)
    want_order = torch.sort(neg_prio, stable=True).indices
    rank_of = torch.empty(n, dtype=torch.int64, device=free_mask.device)
    rank_of[want_order] = torch.arange(n, device=free_mask.device)
    granted = want_mask & (rank_of < n_free)
    dest = torch.where(granted, free_order[torch.clamp(rank_of, 0, n - 1)], n)
    return dest, granted


def _scatter_rows(dst: torch.Tensor, src: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """dst with row dest[i] set to src[i]; dest == N (not granted) is
    dropped, as JAX's ``.at[dest].set(mode="drop")``. torch raises on an
    out-of-range index, so those rows are masked out first."""
    keep = dest < dst.shape[0]
    out = dst.clone()
    out[dest[keep]] = src[keep]
    return out


def _scatter_params(params: GaussianParams, src: GaussianParams, dest) -> GaussianParams:
    return GaussianParams(
        **{f: _scatter_rows(getattr(params, f), getattr(src, f), dest) for f in PARAM_FIELDS}
    )


def _set_true(mask: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    return _scatter_rows(mask, torch.ones_like(mask), dest)


@torch.no_grad()
def densify_and_prune(
    model: GaussianModel,
    adam: AdamState,
    stats: DensifyStats,
    noise: torch.Tensor,
    extent,
    grad_threshold: float = 0.0002,
    min_opacity: float = 0.005,
    max_screen_size: float | None = None,
    percent_dense: float = 0.01,
) -> tuple[GaussianModel, AdamState, DensifyStats, dict]:
    """One densify+prune pass. ``noise`` (n_split, N, 3) holds standard
    normal draws, one (N, 3) block per split child. Returns (model, adam,
    fresh stats, info)."""
    p = model.params
    alive = model.alive
    n = alive.shape[0]
    n_split = noise.shape[0]
    if noise.shape[1:] != (n, 3):
        raise ValueError(f"noise must be (n_split, {n}, 3), got {tuple(noise.shape)}")

    grads = torch.where(
        stats.denom > 0, stats.grad_accum / torch.clamp(stats.denom, min=1.0), 0.0
    )
    scales = torch.exp(p.log_scales)
    max_scale = scales.amax(dim=-1)
    high_grad = alive & (grads >= grad_threshold)
    clone_mask = high_grad & (max_scale <= percent_dense * extent)
    split_mask = high_grad & (max_scale > percent_dense * extent)

    zeros = GaussianParams(**{f: torch.zeros_like(getattr(p, f)) for f in PARAM_FIELDS})
    fresh = torch.zeros((n,), dtype=torch.bool, device=alive.device)  # slots written

    # ---- clone: copy candidates into free slots (gaussian_model.py:349-365)
    dest_c, granted_c = _alloc_slots(~alive, clone_mask, grads)
    new_params = _scatter_params(p, p, dest_c)
    new_mu = _scatter_params(adam.mu, zeros, dest_c)
    new_nu = _scatter_params(adam.nu, zeros, dest_c)
    alive = _set_true(alive, dest_c)
    fresh = _set_true(fresh, dest_c)

    # ---- split: n_split children per parent (gaussian_model.py:320-347):
    # child xyz ~ N(mean, Sigma), child scales = scales / (0.8 n_split);
    # the parent is pruned (its slot is free for the next children). All
    # reads come from the pre-pass params.
    alive = alive & ~split_mask
    rot = quaternion_to_matrix(quat_normalize(p.quaternions))
    child_log_scales = torch.log(torch.clamp(scales / (0.8 * n_split), min=1e-30))
    n_drop = torch.zeros((), dtype=torch.int64, device=alive.device)
    for k in range(n_split):
        v = noise[k] * scales
        child_xyz = p.xyz + (rot * v[:, None, :]).sum(dim=-1)
        dest_s, granted_s = _alloc_slots(~alive, split_mask, grads)
        src = dataclasses.replace(p, xyz=child_xyz, log_scales=child_log_scales)
        new_params = _scatter_params(new_params, src, dest_s)
        new_mu = _scatter_params(new_mu, zeros, dest_s)
        new_nu = _scatter_params(new_nu, zeros, dest_s)
        alive = _set_true(alive, dest_s)
        fresh = _set_true(fresh, dest_s)
        n_drop = n_drop + (split_mask & ~granted_s).sum()

    # ---- prune AFTER densification (gaussian_model.py:367-377): opacity
    # and world size apply to the new population; the screen radius uses
    # accumulated stats, valid only for slots not rewritten this pass.
    opacity = torch.sigmoid(new_params.opacity_logit)
    prune = alive & (opacity < min_opacity)
    if max_screen_size is not None:
        prune |= alive & ~fresh & (stats.max_radii > max_screen_size)
        prune |= alive & (torch.exp(new_params.log_scales).amax(dim=-1) > 0.1 * extent)
    alive = alive & ~prune

    info = dict(
        n_cloned=granted_c.sum(),
        n_split=split_mask.sum(),
        n_pruned=(prune | split_mask).sum(),
        n_dropped=n_drop + (clone_mask & ~granted_c).sum(),
        n_alive=alive.sum(),
    )
    new_model = dataclasses.replace(model, params=new_params, alive=alive)
    new_adam = dataclasses.replace(adam, mu=new_mu, nu=new_nu)
    return new_model, new_adam, DensifyStats.zeros(n, device=alive.device), info


@torch.no_grad()
def reset_opacity(model: GaussianModel, adam: AdamState) -> tuple[GaussianModel, AdamState]:
    """Clamp opacity to <= 0.01 and zero its Adam moments
    (gaussian_model.py:210-214 + replace_tensor_to_optimizer)."""
    op = torch.sigmoid(model.params.opacity_logit)
    new_logit = inverse_sigmoid(torch.clamp(op, max=0.01))
    params = dataclasses.replace(model.params, opacity_logit=new_logit)
    mu = dataclasses.replace(adam.mu, opacity_logit=torch.zeros_like(new_logit))
    nu = dataclasses.replace(adam.nu, opacity_logit=torch.zeros_like(new_logit))
    return (
        dataclasses.replace(model, params=params),
        dataclasses.replace(adam, mu=mu, nu=nu),
    )


def prune_low_opacity(model: GaussianModel, threshold: float = 0.5) -> GaussianModel:
    """Hard prune by opacity (SuGaR coarse stage, coarse_sdf.py:487-497)."""
    op = torch.sigmoid(model.params.opacity_logit)
    return dataclasses.replace(model, alive=model.alive & (op >= threshold))
