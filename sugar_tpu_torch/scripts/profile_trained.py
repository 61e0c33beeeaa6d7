"""Per-stage times of the production (fused) render on bench.py's
trained-statistics 1M scene, or its random scene, at 512x512: the port of
the JAX package's ``scripts/profile_trained.py``.

Times, one line per stage (CUDA events, mean of ``ITERS`` calls after one
warm-up): preprocess; the fused binning (``bin_fused``, on the card the
kernels of ``csrc/binning.cu``: exact-support culling over every rect
tile, the tile ranges, the per-tile depth order) with its dup count,
deepest tile and the tiles deeper than 2,048 slots; pack + dup gather; the
compositing kernel's forward (K1); the full forward and fwd+bwd
(``render_fused``); the kernel's forward+backward alone (K1, K2, with the
loss sum(image^2) + sum(final_T)). Then the mean n_contrib and final_T of
the composite. The first line is the card's name and power limit.

Run on a machine with a CUDA card (it refuses to run without one)::

    python -m sugar_tpu_torch.scripts.profile_trained [--scene trained|random]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sugar_tpu_torch.raster.common import RasterSettings, from_camera
from sugar_tpu_torch.raster.dup_gather import gather_dup, pack_params, pad_rows
from sugar_tpu_torch.raster.fused import assemble_tiles, bin_fused, render_fused
from sugar_tpu_torch.raster.preprocess import preprocess
from sugar_tpu_torch.raster.tile_composite import C_CHUNK, tile_composite
from sugar_tpu_torch.scripts import bench
from sugar_tpu_torch.utils.profiling import card_line, require_cuda, time_line

N = 1_000_000
H = W = 512
TILE_CAP = 16
CAP_A = 4
DUP_CAPACITY = 1_900_000
# k_max per scene: the trained scene's deepest tile is 24,745 slots.
K_MAX = {"trained": 24832, "random": 10240}
DEEP = 2048  # a tile deeper than this many slots counts as deep
ITERS = 5
LIVE_ROWS = 9  # mean2d 2, conic 3, opacity 1, color 3


def big_cap_of(n: int) -> int:
    """The script's bucket-B rows: max(n // 8, 65536) (``bin_fused`` takes
    at most n)."""
    return max(n // 8, 65536)


def scene_arrays(scene: str, n: int):
    """bench.py's scene of that name: trained from seed 1, random from 0."""
    if scene == "trained":
        return bench._scene_trained(n, np.random.default_rng(1))
    return bench._scene_random(n, np.random.default_rng(0))


def prep_of(args, settings):
    means, scales, quats, opac, colors = args
    return preprocess(means, opac, settings, scales=scales, quaternions=quats, colors=colors)


def bin_of(prep, settings: RasterSettings, tile_cap: int, capacity: int) -> dict:
    n = prep.mean2d.shape[0]
    return bin_fused(prep, settings.tiles_x * settings.tiles_y, settings.tiles_x, tile_cap, CAP_A,
                     big_cap_of(n), capacity)


def gather_of(prep, b: dict):
    """Pack (rows padded to 16) and gather into the binning's dup order."""
    packed = pad_rows(pack_params(prep.mean2d, prep.conic, prep.opacity, prep.color))
    return gather_dup(packed, b["gid"], prep.mean2d.shape[0], b["inexact"] == 0, LIVE_ROWS)


def composite(b: dict, dup, settings: RasterSettings, k_max: int):
    max_chunks = (k_max + C_CHUNK - 1) // C_CHUNK
    count = torch.clamp(b["tile_count"], max=max_chunks * C_CHUNK)
    return tile_composite(b["tile_start"], count, dup, settings.bg, settings.tiles_x, 3,
                          max_chunks)


def full_render(args, settings, tile_cap: int, capacity: int, k_max: int) -> dict:
    return render_fused(prep_of(args, settings), settings, tile_cap=tile_cap, capacity=capacity,
                        max_per_tile=k_max)


def stages(args, settings, tile_cap: int, capacity: int, k_max: int) -> dict:
    """The stage outputs, each from the stage before: preprocess, the fused
    binning, the gathered dups, the composite, and the image they
    assemble."""
    with torch.no_grad():
        prep = prep_of(args, settings)
        b = bin_of(prep, settings, tile_cap, capacity)
        dup = gather_of(prep, b)
        img, final_t, n_contrib = composite(b, dup, settings, k_max)
    return dict(prep=prep, bins=b, dup=dup, img=img, final_t=final_t, n_contrib=n_contrib,
                image=assemble_tiles(img, settings))


def main(argv=None) -> dict:
    """Print the card line and one line per stage; return the times, the
    binning's counts, the composite's means, and the stage-by-stage image
    beside the one-call production render of the same scene."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="trained", choices=["trained", "random"])
    a = ap.parse_args(argv)
    require_cuda("profile_trained")
    card = card_line()
    k_max = K_MAX[a.scene]
    print(f"profile_trained on {card}: bench.py's {a.scene} scene, {N} Gaussians, {H}x{W}, "
          f"tile_cap {TILE_CAP}, capacity {DUP_CAPACITY}, k_max {k_max}", flush=True)
    args = [torch.as_tensor(x, device="cuda") for x in scene_arrays(a.scene, N)]
    settings = from_camera(bench.bench_camera(H, W), device="cuda")
    ms = {}

    def timeit(name, fn):
        ms[name] = time_line(name, fn, ITERS)

    st = stages(args, settings, TILE_CAP, DUP_CAPACITY, k_max)
    prep, b, dup = st["prep"], st["bins"], st["dup"]
    with torch.no_grad():
        timeit("preprocess fwd", lambda: prep_of(args, settings))
        timeit("bin_fused (expand+sort+ranges)",
               lambda: bin_of(prep, settings, TILE_CAP, DUP_CAPACITY))
        counts = dict(num_rendered=int(b["num_rendered"]), max_tile_count=int(b["tile_count"].max()),
                      deep_tiles=int((b["tile_count"] > DEEP).sum()))
        print(f"  num_rendered={counts['num_rendered']}  max_tile_count={counts['max_tile_count']}  "
              f"tiles>{DEEP} deep={counts['deep_tiles']}", flush=True)
        timeit("pack + gather_dup", lambda: gather_of(prep, b))
        timeit("tile_composite fwd (kernel)", lambda: composite(b, dup, settings, k_max))
        timeit("full forward",
               lambda: full_render(args, settings, TILE_CAP, DUP_CAPACITY, k_max)["image"])
    grad_args = [x.clone().requires_grad_(True) for x in args]

    def full_fwd_bwd():
        img = full_render(grad_args, settings, TILE_CAP, DUP_CAPACITY, k_max)["image"]
        return torch.autograd.grad(torch.sum(img**2), grad_args)

    timeit("full fwd+bwd", full_fwd_bwd)
    dup_g = dup.clone().requires_grad_(True)

    def kernel_fwd_bwd():
        img, t, _ = composite(b, dup_g, settings, k_max)
        return torch.autograd.grad(torch.sum(img**2) + torch.sum(t), dup_g)

    timeit("kernel fwd+bwd (d dup_data)", kernel_fwd_bwd)
    means = dict(n_contrib=float(st["n_contrib"].float().mean()),
                 final_t=float(st["final_t"].mean()))
    print(f"  mean n_contrib={means['n_contrib']:.1f}  mean final_T={means['final_t']:.4f}",
          flush=True)
    with torch.no_grad():
        one_call = full_render(args, settings, TILE_CAP, DUP_CAPACITY, k_max)["image"]
    diff = float((st["image"] - one_call).abs().max())
    print(f"  stage-by-stage image vs one-call render (render_fused): max abs diff {diff}",
          flush=True)
    return dict(card=card, scene=a.scene, ms=ms, counts=counts, means=means,
                image_stages=st["image"], image_one_call=one_call)


if __name__ == "__main__":
    main()
