"""Collective accounting of the sharded steps, by rank count.

Port of ``scripts/scaling_report.py``. The JAX script compiles each step
for N virtual devices and sums the output bytes of the collectives in the
optimized graph. Here each step runs in N ranks (``parallel.launch``) and
the collectives count their own bytes (``parallel.comm``, the same
output-bytes convention). For each rank count (1, 2 and 4 by default) it
runs, at the JAX script's toy scale (4,096-slot capacity, 512 points):

- one tile-sharded vanilla train step (``parallel.train.
  make_tile_sharded_train_step``: every rank on one 128 x 64 view, SH
  degree 1; the JAX script grows the height with the device count, here it
  is fixed so that the rows are comparable);
- one sharded coarse 'sdf' step (``parallel.coarse.make_sharded_coarse_step``
  over a (data, gauss) mesh with gauss 2 when N is even; 64 x 64 views,
  4,096 SDF samples, KNN 8, entropy and SDF terms on);
- one ring KNN build (``parallel.knn.knn_sharded``, k 8) over the
  Gaussians, the only path with point-to-point transfers.

It prints and writes a markdown table (``--out``, by default
``SCALING_torch.md`` in the temporary directory) of the collective bytes
per step by op on rank 0, the host-staged bytes, and the ms per step on
rank 0 with the device, the backend and the rank layout beside it. Ranks
that share a card (more ranks than cards) measure contention and host
staging, not multi-card scaling.

    python -m sugar_tpu_torch.scripts.scaling_report [--out PATH] [--worlds 1 2 4]
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.models import densifier as dens
from sugar_tpu_torch.models.gaussians import create_from_pcd
from sugar_tpu_torch.parallel import comm
from sugar_tpu_torch.parallel.coarse import make_sharded_coarse_step
from sugar_tpu_torch.parallel.knn import knn_sharded
from sugar_tpu_torch.parallel.launch import choose_backend, run_ranks
from sugar_tpu_torch.parallel.mesh import make_mesh, shard_params, world_axis
from sugar_tpu_torch.parallel.train import make_tile_sharded_train_step
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.trainers.coarse import CoarseConfig
from sugar_tpu_torch.trainers.schedule import iteration_generator

CAPACITY = 4096
N_POINTS = 512
TILE_HW = (128, 64)
COARSE_RES = 64
COARSE_SAMPLES = 4096


def _points(seed: int = 0):
    g = np.random.default_rng(seed)
    pts = np.stack([g.uniform(-1, 1, N_POINTS), g.uniform(-1, 1, N_POINTS),
                    g.uniform(1.5, 4, N_POINTS)], -1).astype(np.float32)
    return pts, g.uniform(0, 1, (N_POINTS, 3)).astype(np.float32), g


def _timed(dev, run, iters: int) -> tuple[dict, list[float]]:
    """One warm-up call, the counters of one call, then ``iters`` timed
    calls (synchronized on a card)."""
    run()
    comm.reset_counters()
    run()
    counts = comm.counters()
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return counts, times


def report_rank(dev, iters: int) -> dict:
    """``parallel.launch.run_ranks`` entry: the two steps and the KNN build
    on this rank; rank 0's counters and times are the ones reported."""
    pts, cols, g = _points()
    model = create_from_pcd(pts, cols, CAPACITY, sh_degree=1, device=dev)
    adam0 = opt.init_adam(model.params)
    axis = world_axis()
    h, w = TILE_HW
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.2, height=h, width=w,
                      device=dev)
    gt = torch.as_tensor(g.uniform(0, 1, (h, w, 3)).astype(np.float32), device=dev)
    step = make_tile_sharded_train_step(axis, opt.group_lrs(opt.OptimConfig(), 1.0),
                                        opt.OptimConfig(), 1, tile_cap=8, k_max=512)
    state = [shard_params(x, axis) for x in (model.params, model.alive, adam0,
                                             dens.DensifyStats.zeros(CAPACITY, device=dev))]
    tile = _timed(dev, lambda: step(*state, cam, gt, 0), iters)

    n_gauss = 2 if axis.size % 2 == 0 else 1
    mesh = make_mesh(n_data=axis.size // n_gauss, n_gauss=n_gauss, device=dev)
    cfg = CoarseConfig(mode="sdf", n_samples_for_sdf_regularization=COARSE_SAMPLES,
                       knn_to_track=8, k_max=512, sh_degree=1)
    cstep = make_sharded_coarse_step(mesh, cfg, opt.group_lrs(cfg.optim, 1.5), 1.5,
                                     8 * CAPACITY, True, True)
    nd = mesh.data.size
    cams = [make_camera(R=np.eye(3), T=np.array([0.05 * i, 0, 0]), fov_x=1.2, fov_y=1.2,
                        height=COARSE_RES, width=COARSE_RES, device=dev) for i in range(nd)]
    gts = [torch.as_tensor(g.uniform(0, 1, (COARSE_RES, COARSE_RES, 3)).astype(np.float32),
                           device=dev) for _ in range(nd)]
    cstate = [shard_params(x, mesh.gauss) for x in (
        model.params, model.alive, adam0,
        torch.zeros((CAPACITY, 8), dtype=torch.int64, device=dev))]

    def coarse_once():
        draws = [iteration_generator(0, 9001 + j, dev) for j in range(nd)]
        return cstep(*cstate, cams, gts, 9001, draws)

    coarse = _timed(dev, coarse_once, iters)
    knn = _timed(dev, lambda: knn_sharded(axis, model.params.xyz, model.params.xyz, 8,
                                          ref_mask=model.alive), iters)
    return dict(tile=tile, coarse=coarse, knn=knn, mesh=(nd, n_gauss), backend=axis.backend)


def _card() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return f"{torch.cuda.get_device_name(0)} (power limit not read: no nvidia-smi)"
    return out.strip().splitlines()[0]


def _by_op(counts: dict) -> str:
    return ", ".join(f"{k}: {v:,}" for k, v in counts.items()
                     if k in comm.OPS and v) or "none"


def main(argv=None, device: str = "cuda") -> list[dict]:
    p = argparse.ArgumentParser(description="Collective bytes and ms per sharded step.")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "SCALING_torch.md"))
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args(argv)
    if device == "cuda":
        cards = torch.cuda.device_count()
        where = f"{_card()} x {cards}"
    else:
        cards, where = 0, "CPU"
    rows = []
    for world in args.worlds:
        out = run_ranks(report_rank, world, device=device, args=(args.iters,))
        if device == "cuda":
            share = ("one rank per card" if world <= cards
                     else f"{world} ranks sharing {cards} card{'s' * (cards > 1)}")
        else:
            share = f"{world} CPU processes"
        out.update(world=world, layout=f"{share}, {choose_backend(world, device)}")
        rows.append(out)
        for name in ("tile", "coarse", "knn"):
            counts, times = out[name]
            print(f"{name} world={world} ({out['layout']}): {_by_op(counts)}; host staged "
                  f"{counts['host_staged']:,} B; {statistics.median(times):.2f} ms/step "
                  f"(median of {len(times)}) on {where}", flush=True)
    lines = [
        "# Collective accounting of the port's sharded steps",
        "",
        f"Device: {where}. Bytes are rank 0's per step, the output bytes of each",
        "collective (parallel/comm.py); `host_staged` is what gloo copied through",
        "host buffers. Ranks that share a card measure correctness, contention and",
        "host staging, not multi-card scaling.",
        "",
        f"## Tile-sharded train step ({CAPACITY} slots, {TILE_HW[0]}x{TILE_HW[1]}, SH 1)",
        "",
        "| ranks | layout | collective bytes/step (by op) | host staged B | ms/step (median) |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        counts, times = r["tile"]
        lines.append(f"| {r['world']} | {r['layout']} | {_by_op(counts)} | "
                     f"{counts['host_staged']:,} | {statistics.median(times):.2f} |")
    lines += [
        "",
        f"## Sharded coarse 'sdf' step ({CAPACITY} slots, {COARSE_RES}px views, "
        f"{COARSE_SAMPLES} SDF samples)",
        "",
        "| ranks | mesh (data x gauss) | layout | collective bytes/step (by op) "
        "| host staged B | ms/step (median) |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        counts, times = r["coarse"]
        lines.append(f"| {r['world']} | {r['mesh'][0]}x{r['mesh'][1]} | {r['layout']} | "
                     f"{_by_op(counts)} | {counts['host_staged']:,} | "
                     f"{statistics.median(times):.2f} |")
    lines += [
        "",
        f"## Ring KNN ({CAPACITY} slots, {N_POINTS} alive, k 8, queries = references)",
        "",
        "| ranks | layout | collective bytes/build (by op) | host staged B | ms/build (median) |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        counts, times = r["knn"]
        lines.append(f"| {r['world']} | {r['layout']} | {_by_op(counts)} | "
                     f"{counts['host_staged']:,} | {statistics.median(times):.2f} |")
    lines += ["", "Regenerate with `python -m sugar_tpu_torch.scripts.scaling_report`."]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
