"""Per-stage times of the two-pass render on bench.py's random 1M scene at
512x512: the port of the JAX package's ``scripts/profile_raster.py``.

Times, one line per stage (CUDA events, mean of ``ITERS`` calls after one
warm-up): preprocess; dense binning (``bin_gaussians_dense``, capacity
2,560,000) with its dup count, overflow and tile counts; the two-pass
forward (``render_twopass``, the counterpart of ``render_pallas``); the
production render's forward and fwd+bwd (``mode="pallas"``, k_max 8192);
the dup gather forward and forward+backward (K3 in its backward); the
compositing kernel's forward alone (K1) and forward+backward alone (K1,
K2). The first line is the card's name and power limit.

Run on a machine with a CUDA card (it refuses to run without one)::

    python -m sugar_tpu_torch.scripts.profile_raster
"""

from __future__ import annotations

import numpy as np
import torch

from sugar_tpu_torch.raster.api import rasterize_gaussians
from sugar_tpu_torch.raster.binning import bin_gaussians_dense
from sugar_tpu_torch.raster.common import from_camera
from sugar_tpu_torch.raster.dup_gather import gather_dup, pack_params, pad_rows
from sugar_tpu_torch.raster.fused import assemble_tiles
from sugar_tpu_torch.raster.preprocess import preprocess
from sugar_tpu_torch.raster.tile_composite import C_CHUNK, tile_composite
from sugar_tpu_torch.raster.twopass import render_twopass
from sugar_tpu_torch.scripts import bench
from sugar_tpu_torch.utils.profiling import card_line, require_cuda, time_line

N = 1_000_000
H = W = 512
TILE_CAP = 16
CAPACITY = 2_560_000
K_MAX = 8192
ITERS = 5
LIVE_ROWS = 9  # mean2d 2, conic 3, opacity 1, color 3


def prep_of(args, settings):
    means, scales, quats, opac, colors = args
    return preprocess(means, opac, settings, scales=scales, quaternions=quats, colors=colors)


def dense_gather_inputs(prep, binning):
    """The gather's inputs on a dense binning, as the JAX script builds
    them: (packed rows padded to 16, gid with the sentinel n over the
    chunk padding, grads_exact)."""
    n = prep.mean2d.shape[0]
    d = binning.sorted_gauss.shape[0]
    d_pad = ((d + C_CHUNK - 1) // C_CHUNK) * C_CHUNK + C_CHUNK
    gid = torch.cat([binning.sorted_gauss,
                     torch.full((d_pad - d,), n, dtype=torch.int32, device=prep.mean2d.device)])
    packed = pad_rows(pack_params(prep.mean2d, prep.conic, prep.opacity, prep.color))
    return packed, gid, binning.num_rendered <= d


def composite(binning, dup_data, settings, k_max: int):
    """The compositing kernel alone on a dense binning's ranges: (image
    tiles (T, 256, 3) with the background, final_T, n_contrib)."""
    max_chunks = max(1, k_max // C_CHUNK)
    count_clip = torch.clamp(binning.tile_count, max=max_chunks * C_CHUNK)
    return tile_composite(binning.tile_start, count_clip, dup_data, settings.bg, settings.tiles_x,
                          3, max_chunks)


def stages(args, settings, tile_cap: int, capacity: int, k_max: int) -> dict:
    """The stage outputs, each from the stage before: preprocess, dense
    binning, the dup gather, the compositing kernel, and the image they
    assemble."""
    with torch.no_grad():
        prep = prep_of(args, settings)
        binning = bin_gaussians_dense(prep, settings, tile_cap, capacity=capacity)
        packed, gid, ok = dense_gather_inputs(prep, binning)
        dup = gather_dup(packed, gid, prep.mean2d.shape[0], ok, LIVE_ROWS)
        img, final_t, n_contrib = composite(binning, dup, settings, k_max)
    return dict(prep=prep, binning=binning, packed=packed, gid=gid, grads_exact=ok, dup=dup,
                img=img, final_t=final_t, n_contrib=n_contrib,
                image=assemble_tiles(img, settings))


def main() -> dict:
    """Print the card line and one line per stage; return the times, the
    binning's counts, and the stage-by-stage image beside the one-call
    two-pass render of the same scene."""
    require_cuda("profile_raster")
    card = card_line()
    print(f"profile_raster on {card}: bench.py's random scene, {N} Gaussians, {H}x{W}, "
          f"tile_cap {TILE_CAP}, capacity {CAPACITY}, k_max {K_MAX}", flush=True)
    arrays = bench._scene_random(N, np.random.default_rng(0))
    args = [torch.as_tensor(x, device="cuda") for x in arrays]
    settings = from_camera(bench.bench_camera(H, W), device="cuda")
    ms = {}

    def timeit(name, fn):
        ms[name] = time_line(name, fn, ITERS)

    st = stages(args, settings, TILE_CAP, CAPACITY, K_MAX)
    prep, binning = st["prep"], st["binning"]
    packed, gid, ok = st["packed"], st["gid"], st["grads_exact"]
    with torch.no_grad():
        timeit("preprocess", lambda: prep_of(args, settings))
        timeit("binning (dense)",
               lambda: bin_gaussians_dense(prep, settings, TILE_CAP, capacity=CAPACITY))
        counts = dict(num_rendered=int(binning.num_rendered), overflow=int(binning.overflow),
                      tile_count_max=int(binning.tile_count.max()),
                      tile_count_mean=float(binning.tile_count.float().mean()))
        print(f"  num_rendered {counts['num_rendered']}  overflow {counts['overflow']}  "
              f"tile_count max {counts['tile_count_max']}  mean {counts['tile_count_mean']:.1f}",
              flush=True)
        timeit("twopass fwd (gather+kernel)",
               lambda: render_twopass(prep, binning, settings, max_per_tile=K_MAX))
        timeit("full fwd", lambda: bench.scene_loss(args, settings, CAPACITY, K_MAX)[1]["image"])
    grad_args = [x.clone().requires_grad_(True) for x in args]
    timeit("full fwd+bwd", lambda: bench.fwd_bwd(grad_args, settings, CAPACITY, K_MAX))
    print(f"  rays/s: {H * W / (ms['full fwd+bwd'] / 1e3):.0f}", flush=True)

    with torch.no_grad():
        timeit("gather_dup fwd", lambda: gather_dup(packed, gid, N, ok, LIVE_ROWS))
        timeit("kernel fwd only", lambda: composite(binning, st["dup"], settings, K_MAX))
    dup = st["dup"].clone().requires_grad_(True)

    def kernel_fwd_bwd():
        img = composite(binning, dup, settings, K_MAX)[0]
        return torch.autograd.grad(torch.sum(img**2), dup)

    timeit("kernel fwd+bwd only", kernel_fwd_bwd)
    packed_g = packed.clone().requires_grad_(True)

    def gather_fwd_bwd():
        g = gather_dup(packed_g, gid, N, ok, LIVE_ROWS)
        return torch.autograd.grad(torch.sum(g**2), packed_g)

    timeit("gather_dup fwd+bwd", gather_fwd_bwd)
    with torch.no_grad():
        one_call = rasterize_gaussians(
            args[0], args[3], settings, scales=args[1], quaternions=args[2], colors=args[4],
            mode="pallas_twopass", tile_cap=TILE_CAP, dup_capacity=CAPACITY, k_max=K_MAX,
        )["image"]
    diff = float((st["image"] - one_call).abs().max())
    print(f"  stage-by-stage image vs one-call render (mode pallas_twopass): max abs diff {diff}",
          flush=True)
    return dict(card=card, ms=ms, counts=counts, image_stages=st["image"], image_one_call=one_call)


if __name__ == "__main__":
    main()
