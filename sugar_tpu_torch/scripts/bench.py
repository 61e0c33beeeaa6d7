"""Benchmark of the port on one CUDA card: rays/s through the production
renderer. The port of the JAX package's root ``bench.py``.

Prints three JSON lines, in ``bench.py``'s order:

- ``train_step_rays_per_s_256k_gaussians``: the vanilla train step (render
  + L1/SSIM loss + backward + Adam + densify statistics) through
  ``trainers/vanilla.make_train_step`` with the default render mode
  (``"auto"``, the fused path: K1, K2, K3), on 2^18 trained-statistics
  Gaussians at SH degree 0, 512x512, after the trainer's own cap growth;
- ``rays_per_s_fwd_bwd_1M_gaussians``: loss ``sum(image**2)`` through
  ``rasterize_gaussians(mode="pallas")`` and its gradients with respect to
  means, scales, quaternions, opacities and colors, on 1M random
  Gaussians at 512x512;
- ``rays_per_s_fwd_bwd_1M_gaussians_trained_stats``: the same on 1M
  Gaussians with trained-checkpoint statistics (the headline, last).

Each line keeps ``bench.py``'s keys: ``metric``, ``value`` (rays/s: pixels
over the mean time of ``ITERS`` iterations after a warm-up, on the host
clock from before the first to after ``torch.cuda.synchronize()`` behind
the last), ``unit`` and ``vs_baseline`` (against bench.py's bar of 1e7
rays/s). It adds ``device`` (the card's name and power limit), the
spread of the iterations (``ms_median``, ``ms_min``, ``ms_max``; each
iteration timed by CUDA events recorded between iterations, so the loop
runs as bench.py's does, without a synchronization inside it) and the
overflow counters that bench.py asserts to be 0 (``bin_overflow``,
``tile_overflow``: of the check forward for a scene, of the last timed
step for the train step). The train step's warm-up is the trainer's cap
growth, as in bench.py; a scene's is one fwd+bwd.

Run on a machine with a CUDA card (it refuses to run without one)::

    python -m sugar_tpu_torch.scripts.bench
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.core.sh import C0
from sugar_tpu_torch.eval.parity import _fibonacci_sphere, blob_colors, blob_surface
from sugar_tpu_torch.interop import params_from_numpy
from sugar_tpu_torch.models import densifier as dens
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.raster.api import rasterize_gaussians
from sugar_tpu_torch.raster.common import from_camera
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.trainers.vanilla import TrainConfig, make_train_step
from sugar_tpu_torch.utils.profiling import card_line, require_cuda

BASELINE = 1.0e7  # bench.py's bar: 7k iterations of ~0.25 Mpix in ~3 minutes
N = 1_000_000
H = W = 512
ITERS = 10
TILE_CAP = 16
# Both 1M scenes share bench.py's capacities: 1.58M / 1.64M culled dups
# (trained / random) and the trained scene's deepest tile below k_max.
DUP_CAPACITY = 1_900_000
K_MAX = 24832
TRAIN_N = 2**18
TRAIN_SEED = 2
TRAIN_K_MAX = 12288
TRAIN_CAPS = adaptive.RasterCaps(tile_cap=16, dup_capacity=1_200_000, k_max=TRAIN_K_MAX)
WARMUP_GROWTHS = 4  # bench.py's limit on the trainer's cap growth before timing


def _scene_random(n, g):
    """bench.py's random scene: (means, scales, quats, opacities, colors)
    float32 arrays, drawn from ``g`` in bench.py's order."""
    means = np.stack(
        [g.uniform(-1.5, 1.5, n), g.uniform(-1.5, 1.5, n), g.uniform(1.0, 8.0, n)], -1
    ).astype(np.float32)
    scales = np.exp(g.uniform(np.log(0.002), np.log(0.02), (n, 3))).astype(np.float32)
    quats = g.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = g.uniform(0.2, 0.9, n).astype(np.float32)
    colors = g.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


def _scene_trained(n, g):
    """bench.py's trained-statistics scene: Gaussians on the surface of the
    parity blob 3.2 in front of the origin (opacity 0.85-0.99, the normal
    axis a tenth of the tangent axes, rotated to the radial normal), with
    the depth complexity and tile occupancy of a trained coarse-SuGaR
    checkpoint. Returns (means, scales, quats, opacities, colors)."""
    d = _fibonacci_sphere(n)
    r = blob_surface(d)
    means = (d * r[:, None]).astype(np.float32)
    means += np.array([0.0, 0.0, 3.2], np.float32)  # camera at origin, +z forward
    # Tangent spacing ~ sqrt(area / n); trained scales ~ 1.5-4x the spacing.
    spacing = np.sqrt(4 * np.pi * 0.72**2 / n)
    t_scale = spacing * np.exp(g.uniform(np.log(1.5), np.log(4.0), n))
    scales = np.stack([t_scale, t_scale, t_scale / 10.0], -1).astype(np.float32)
    # The quaternion rotating +z to the surface normal (~radial for the blob).
    nrm = d.astype(np.float32)
    z = np.array([0.0, 0.0, 1.0], np.float32)
    v = np.cross(np.broadcast_to(z, nrm.shape), nrm)
    w_ = 1.0 + nrm @ z
    quats = np.concatenate([w_[:, None], v], -1).astype(np.float32)
    quats /= np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-9)
    opac = g.uniform(0.85, 0.99, n).astype(np.float32)
    colors = blob_colors(means).astype(np.float32)
    return means, scales, quats, opac, colors


def bench_camera(h: int, w: int, device="cuda"):
    """bench.py's camera: at the origin looking down +z, fov 1.2 x 1.2."""
    return make_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.2, height=h, width=w,
                       device=device)


def scene_loss(args, settings, dup_capacity: int, k_max: int):
    """(loss, render output) of bench.py's loss ``sum(image**2)`` for
    ``args`` = (means, scales, quats, opacities, colors) tensors."""
    means, scales, quats, opac, colors = args
    out = rasterize_gaussians(
        means, opac, settings, scales=scales, quaternions=quats, colors=colors,
        mode="pallas", dup_capacity=dup_capacity, tile_cap=TILE_CAP, k_max=k_max,
    )
    return torch.sum(out["image"] ** 2), out


def fwd_bwd(args, settings, dup_capacity: int, k_max: int):
    """One bench step: the loss and its gradients with respect to all five
    inputs (each must require grad)."""
    loss, _ = scene_loss(args, settings, dup_capacity, k_max)
    return loss, torch.autograd.grad(loss, args)


def _timed(fn, iters: int, warmup: int) -> tuple[float, list[float]]:
    """(mean seconds on the host clock, per-iteration ms by CUDA events) of
    ``iters`` calls of fn() after ``warmup`` calls; one synchronize, after
    the last call, as bench.py's loop."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(iters):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    return dt, [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def _record(name: str, h: int, w: int, dt: float, iter_ms: list[float], baseline: float,
            device: str, ovf: dict[str, int]) -> dict:
    rays_per_s = h * w / dt
    return {
        "metric": name,
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / baseline,
        "device": device,
        "iters": len(iter_ms),
        "ms_mean": dt * 1e3,
        "ms_median": statistics.median(iter_ms),
        "ms_min": min(iter_ms),
        "ms_max": max(iter_ms),
        "bin_overflow": ovf["bin_overflow"],
        "tile_overflow": ovf["tile_overflow"],
    }


def _bench_scene(name, arrays, h, w, dup_capacity, k_max, baseline, card: str) -> dict:
    """bench.py's ``_bench_scene`` on the card: checks that one forward
    drops nothing, times fwd+bwd, prints and returns the JSON record."""
    settings = from_camera(bench_camera(h, w), device="cuda")
    args = [torch.as_tensor(x, device="cuda").requires_grad_(True) for x in arrays]
    with torch.no_grad():
        _, check = scene_loss(args, settings, dup_capacity, k_max)
    ovf = adaptive.read_overflow(check)
    if ovf["bin_overflow"] != 0 or ovf["tile_overflow"] != 0:
        raise RuntimeError(f"{name}: the capacities drop splats: {ovf}")
    dt, iter_ms = _timed(lambda: fwd_bwd(args, settings, dup_capacity, k_max), ITERS, 1)
    rec = _record(name, h, w, dt, iter_ms, baseline, card, ovf)
    print(json.dumps(rec), flush=True)
    return rec


def train_step_setup(n: int, h: int, w: int, device="cuda") -> dict:
    """bench.py's train-step state: the trained-statistics scene of ``n``
    Gaussians from seed TRAIN_SEED at SH degree 0, all alive, fresh Adam
    and densify statistics, bench.py's camera and a random target drawn
    after the scene, and the trainer's config and learning rates."""
    g = np.random.default_rng(TRAIN_SEED)
    means, scales, quats, opac, colors = _scene_trained(n, g)
    params = params_from_numpy(dict(
        xyz=means,
        sh_dc=(colors - 0.5) / C0,
        sh_rest=np.zeros((n, 3, 0), np.float32),
        opacity_logit=np.log(opac / (1 - opac)),
        log_scales=np.log(scales),
        quaternions=quats,
    ), device=device)
    cfg = TrainConfig(sh_degree=0, capacity=n, k_max=TRAIN_K_MAX)
    return dict(
        cfg=cfg,
        lrs=opt.group_lrs(cfg.optim, spatial_lr_scale=1.0),
        params=params,
        alive=torch.ones((n,), dtype=torch.bool, device=device),
        adam=opt.init_adam(params),
        stats=dens.DensifyStats.zeros(n, device),
        cam=bench_camera(h, w, device),
        gt=torch.as_tensor(g.uniform(0, 1, (h, w, 3)).astype(np.float32), device=device),
    )


def warm_up_train_step(s: dict, caps: adaptive.RasterCaps):
    """bench.py's warm-up through the trainer's growth rule: run a step at
    iteration 0 and keep its result once it drops nothing, else grow the
    caps and build the step again (at most WARMUP_GROWTHS steps). Returns
    (step, state with params/adam/stats advanced, caps, steps run, last
    aux)."""
    step = make_train_step(s["cfg"], s["lrs"], active_sh_degree=0, caps=caps)
    for steps in range(1, WARMUP_GROWTHS + 1):
        p2, a2, s2, aux = step(s["params"], s["alive"], s["adam"], s["stats"], s["cam"], s["gt"],
                               0)
        ovf = adaptive.read_overflow(aux)
        if not adaptive.overflowed(ovf):
            s = dict(s, params=p2, adam=a2, stats=s2)
            break
        caps = caps.grown(ovf)
        step = make_train_step(s["cfg"], s["lrs"], active_sh_degree=0, caps=caps)
    if ovf["bin_overflow"] != 0 or ovf["tile_overflow"] != 0:
        raise RuntimeError(f"train step: the capacities still drop splats: {ovf}")
    return step, s, caps, steps, aux


def _bench_train_step(h, w, baseline, card: str) -> dict:
    """bench.py's ``_bench_train_step`` on the card; returns the record
    with the warm-up's steps and final caps beside it."""
    s = train_step_setup(TRAIN_N, h, w)
    step, s, caps, warm_steps, _ = warm_up_train_step(s, TRAIN_CAPS)
    state = [s["params"], s["adam"], s["stats"], None]

    def run():
        state[:] = step(state[0], s["alive"], state[1], state[2], s["cam"], s["gt"], 0)

    # The growth loop is the warm-up: bench.py times the next step on.
    dt, iter_ms = _timed(run, ITERS, 0)
    ovf = adaptive.read_overflow(state[3])  # the last timed step's counters
    rec = _record("train_step_rays_per_s_256k_gaussians", h, w, dt, iter_ms, baseline, card, ovf)
    print(json.dumps(rec), flush=True)
    # Returned, not printed: the warm-up's steps and the caps it grew to.
    return dict(rec, warmup_steps=warm_steps, caps=caps)


def main() -> list[dict]:
    """Print and return the three records, bench.py's order."""
    require_cuda("bench")
    card = card_line()
    recs = [_bench_train_step(H, W, BASELINE, card)]
    # The trained-statistics scene prints last: the headline is the
    # production-like number, not the easy random scene.
    recs.append(_bench_scene("rays_per_s_fwd_bwd_1M_gaussians",
                             _scene_random(N, np.random.default_rng(0)), H, W,
                             DUP_CAPACITY, K_MAX, BASELINE, card))
    recs.append(_bench_scene("rays_per_s_fwd_bwd_1M_gaussians_trained_stats",
                             _scene_trained(N, np.random.default_rng(1)), H, W,
                             DUP_CAPACITY, K_MAX, BASELINE, card))
    return recs


if __name__ == "__main__":
    main()
