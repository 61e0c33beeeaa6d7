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

Then, as the JAX script's ``--bench-scale`` section (on by default there
and here), ``bench_scale`` runs the two steps at the JAX script's bench
sizes, at 2 and 8 ranks: the tile-sharded step at capacity 2^20 on a
(32 N) x 512 view, and the coarse 'sdf' step at capacity 2^20 on 512 x 512
views with 262,144 SDF samples. The JAX script compiles these graphs
without running them; here each step runs once after a warm-up, and the
"BENCH SCALE" table holds that run's collective bytes by op on rank 0, the
host-staged bytes, their total, its ms on rank 0 and the peak GB per rank
(``torch.cuda.max_memory_allocated``). Its rank counts and sizes are the
module's ``BENCH_*`` constants.

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
import torch.distributed as dist

from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.models import densifier as dens
from sugar_tpu_torch.models.gaussians import create_from_pcd
from sugar_tpu_torch.parallel import comm
from sugar_tpu_torch.parallel.coarse import make_sharded_coarse_step
from sugar_tpu_torch.parallel.knn import knn_sharded
from sugar_tpu_torch.parallel.launch import (
    choose_backend,
    kernel_launches,
    launches_by_rank,
    run_ranks,
)
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
# The JAX script's bench scale (scripts/scaling_report.py:230-258).
BENCH_WORLDS = (2, 8)
BENCH_CAPACITY = 2**20
BENCH_WIDTH = 512
BENCH_RES = 512
BENCH_SAMPLES = 262_144


def _points(seed: int = 0):
    g = np.random.default_rng(seed)
    pts = np.stack([g.uniform(-1, 1, N_POINTS), g.uniform(-1, 1, N_POINTS),
                    g.uniform(1.5, 4, N_POINTS)], -1).astype(np.float32)
    return pts, g.uniform(0, 1, (N_POINTS, 3)).astype(np.float32), g


def _timed(dev, run, iters: int) -> tuple[dict, list[float], list]:
    """One warm-up call, then ``iters`` timed calls (synchronized on a
    card): the collective bytes of the first, the ms of each, and every
    rank's peak GB over them (None on the CPU)."""
    run()
    comm.reset_counters()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(iters):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts = comm.counters()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    return counts, times, peaks


def _tile_step(dev, axis, model, adam0, capacity: int, h: int, w: int, g):
    """One tile-sharded vanilla train step on an h x w view (SH 1, tile_cap
    8, k_max 512) over this rank's shards of ``model``, as a closure."""
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.2, height=h, width=w,
                      device=dev)
    gt = torch.as_tensor(g.uniform(0, 1, (h, w, 3)).astype(np.float32), device=dev)
    step = make_tile_sharded_train_step(axis, opt.group_lrs(opt.OptimConfig(), 1.0),
                                        opt.OptimConfig(), 1, tile_cap=8, k_max=512)
    state = [shard_params(x, axis) for x in (model.params, model.alive, adam0,
                                             dens.DensifyStats.zeros(capacity, device=dev))]
    return lambda: step(*state, cam, gt, 0)


def _coarse_step(dev, axis, model, adam0, capacity: int, res: int, samples: int, g):
    """One sharded coarse 'sdf' step (gauss 2 when the rank count is even,
    one res x res view per data group, ``samples`` SDF samples, KNN 8,
    entropy and SDF terms) as a closure, and the mesh's (data, gauss)."""
    n_gauss = 2 if axis.size % 2 == 0 else 1
    mesh = make_mesh(n_data=axis.size // n_gauss, n_gauss=n_gauss, device=dev)
    cfg = CoarseConfig(mode="sdf", n_samples_for_sdf_regularization=samples,
                       knn_to_track=8, k_max=512, sh_degree=1)
    cstep = make_sharded_coarse_step(mesh, cfg, opt.group_lrs(cfg.optim, 1.5), 1.5,
                                     8 * capacity, True, True)
    nd = mesh.data.size
    cams = [make_camera(R=np.eye(3), T=np.array([0.05 * i, 0, 0]), fov_x=1.2, fov_y=1.2,
                        height=res, width=res, device=dev) for i in range(nd)]
    gts = [torch.as_tensor(g.uniform(0, 1, (res, res, 3)).astype(np.float32), device=dev)
           for _ in range(nd)]
    cstate = [shard_params(x, mesh.gauss) for x in (
        model.params, model.alive, adam0,
        torch.zeros((capacity, 8), dtype=torch.int64, device=dev))]

    def coarse_once():
        draws = [iteration_generator(0, 9001 + j, dev) for j in range(nd)]
        return cstep(*cstate, cams, gts, 9001, draws)

    return coarse_once, (nd, n_gauss)


def report_rank(dev, iters: int) -> dict:
    """``parallel.launch.run_ranks`` entry: the two steps and the KNN build
    on this rank; rank 0's counters and times are the ones reported."""
    pts, cols, g = _points()
    model = create_from_pcd(pts, cols, CAPACITY, sh_degree=1, device=dev)
    adam0 = opt.init_adam(model.params)
    axis = world_axis()
    tile = _timed(dev, _tile_step(dev, axis, model, adam0, CAPACITY, *TILE_HW, g), iters)
    coarse_once, mesh = _coarse_step(dev, axis, model, adam0, CAPACITY, COARSE_RES,
                                     COARSE_SAMPLES, g)
    coarse = _timed(dev, coarse_once, iters)
    knn = _timed(dev, lambda: knn_sharded(axis, model.params.xyz, model.params.xyz, 8,
                                          ref_mask=model.alive), iters)
    return dict(tile=tile, coarse=coarse, knn=knn, mesh=mesh, backend=axis.backend)



def bench_rank(dev, capacity: int, width: int, res: int, samples: int) -> dict:
    """``run_ranks`` entry of the bench-scale section: the tile-sharded step
    on a (32 ranks) x ``width`` view and the coarse 'sdf' step, each at
    ``capacity`` slots holding the 512 points of seed 0 (SH 1), each run
    once after a warm-up (``_timed``); every rank's K1-K3 and binning
    launches."""
    since = kernel_launches()
    pts, cols, g = _points()
    axis = world_axis()
    model = create_from_pcd(pts, cols, capacity, sh_degree=1, device=dev)
    adam0 = opt.init_adam(model.params)
    h = 32 * axis.size
    tile = _timed(dev, _tile_step(dev, axis, model, adam0, capacity, h, width, g), 1)
    coarse_once, mesh = _coarse_step(dev, axis, model, adam0, capacity, res, samples, g)
    coarse = _timed(dev, coarse_once, 1)
    return dict(tile=tile, coarse=coarse, mesh=mesh, tile_hw=(h, width),
                launches=launches_by_rank(since))


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


def _layout(world: int, device: str, cards: int) -> str:
    if device == "cuda":
        share = ("one rank per card" if world <= cards
                 else f"{world} ranks sharing {cards} card{'s' * (cards > 1)}")
    else:
        share = f"{world} CPU processes"
    return f"{share}, {choose_backend(world, device)}"


def bench_scale(worlds, capacity: int, width: int, res: int, samples: int,
                device: str = "cuda") -> list[dict]:
    """The bench-scale section: ``bench_rank`` at each rank count in
    ``worlds``; one row per step and rank count (rank 0's bytes and ms,
    every rank's peak GB and launches, the layout)."""
    cards = torch.cuda.device_count() if device == "cuda" else 0
    rows = []
    for world in worlds:
        out = run_ranks(bench_rank, world, device=device,
                        args=(capacity, width, res, samples))
        layout = _layout(world, device, cards)
        for name in ("tile", "coarse"):
            counts, (ms,), peak_gb = out[name]
            total = sum(v for k, v in counts.items() if k in comm.OPS)
            peaks = [p for p in peak_gb if p is not None]
            nd, ng = out["mesh"]
            rows.append(dict(
                step="tile-sharded" if name == "tile" else "coarse-sdf", world=world,
                counts=counts, total=total, ms=ms,
                peak_gb=max(peaks) if peaks else None, peak_gb_by_rank=peak_gb,
                launches=out["launches"], layout=layout,
                size=(f"{out['tile_hw'][0]}x{out['tile_hw'][1]}" if name == "tile" else
                      f"{nd} x {res}x{res}, {samples:,} SDF samples, mesh {nd}x{ng}")))
            print(f"bench {rows[-1]['step']} world={world} ({layout}): "
                  f"{_by_op(counts)}; total {total:,} B; host staged "
                  f"{counts['host_staged']:,} B; {ms:.2f} ms; peak GB per rank "
                  f"{peak_gb}; launches per rank {out['launches']}", flush=True)
    return rows


def bench_scale_lines(rows: list[dict], capacity: int, where: str) -> list[str]:
    lines = [
        "",
        f"## BENCH SCALE ({capacity:,}-slot capacity, {N_POINTS} points alive, SH 1)",
        "",
        f"Device: {where}. The JAX script's bench-scale steps, each run once after a",
        "warm-up: bytes are rank 0's in that run, peak GB the largest of the ranks'",
        "`torch.cuda.max_memory_allocated` after the warm-up (n/a on the CPU).",
        "",
        "| step | ranks | view | collective bytes/step (by op) | host staged B | total B/step "
        "| peak GB per rank | ms (rank 0) | layout |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        peak = "n/a" if r["peak_gb"] is None else f"{r['peak_gb']:.3f}"
        lines.append(f"| {r['step']} | {r['world']} | {r['size']} | {_by_op(r['counts'])} | "
                     f"{r['counts']['host_staged']:,} | {r['total']:,} | {peak} | "
                     f"{r['ms']:.2f} | {r['layout']} |")
    return lines


def main(argv=None, device: str = "cuda") -> tuple[list[dict], list[dict]]:
    """Both sections; returns (the toy rows, one per rank count; the bench
    rows, one per step and rank count)."""
    p = argparse.ArgumentParser(description="Collective bytes and ms per sharded step.")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "SCALING_torch.md"))
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--bench-scale", action="store_true", default=True)
    args = p.parse_args(argv)
    if device == "cuda":
        cards = torch.cuda.device_count()
        where = f"{_card()} x {cards}"
    else:
        cards, where = 0, "CPU"
    rows = []
    for world in args.worlds:
        out = run_ranks(report_rank, world, device=device, args=(args.iters,))
        out.update(world=world, layout=_layout(world, device, cards))
        rows.append(out)
        for name in ("tile", "coarse", "knn"):
            counts, times, _ = out[name]
            print(f"{name} world={world} ({out['layout']}): {_by_op(counts)}; host staged "
                  f"{counts['host_staged']:,} B; {statistics.median(times):.2f} ms/step "
                  f"(median of {len(times)}) on {where}", flush=True)
    brows = []
    if args.bench_scale:
        brows = bench_scale(BENCH_WORLDS, BENCH_CAPACITY, BENCH_WIDTH, BENCH_RES,
                            BENCH_SAMPLES, device)
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
        counts, times, _ = r["tile"]
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
        counts, times, _ = r["coarse"]
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
        counts, times, _ = r["knn"]
        lines.append(f"| {r['world']} | {r['layout']} | {_by_op(counts)} | "
                     f"{counts['host_staged']:,} | {statistics.median(times):.2f} |")
    if brows:
        lines += bench_scale_lines(brows, BENCH_CAPACITY, where)
    lines += ["", "Regenerate with `python -m sugar_tpu_torch.scripts.scaling_report`."]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")
    return rows, brows


if __name__ == "__main__":
    main()
