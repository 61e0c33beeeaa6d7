"""Binning counts of the smoke scene from every implementation at hand.

Bins view 0 of bench.py's trained-statistics scene (1M Gaussians, the raw
arrays of ``bench._scene_trained``, 512x512, tile_cap 16, capacity 1.9M,
the default big_cap) and prints the culled dup count ``num_rendered`` and
the deepest tile ``max_tile_count`` of:

- ``port_cpu``: sugar_tpu_torch on CPU tensors (the plain path);
- ``port_gpu``: sugar_tpu_torch on the GPU, when one is present;
- ``port_gpu_bin_of_cpu_prep``: the GPU binning of the CPU preprocess
  output, which separates binning arithmetic from preprocess arithmetic;
- ``jax_cpu``: the JAX package on the CPU, when ``jax`` is installed.

For each pair it also counts the Gaussians whose integer preprocess fields
or per-Gaussian culled counts differ. Run from the repository root:

    python3 tools/torch_count_witness.py [--n N]

``--n`` cuts the scene to N Gaussians (for a quick run on a CPU). It
prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the scene and cameras, numpy + torch only)
from sugar_tpu_torch.raster import common as rc  # noqa: E402
from sugar_tpu_torch.raster.fused import bin_fused, default_big_cap  # noqa: E402
from sugar_tpu_torch.raster.preprocess import Preprocessed, preprocess  # noqa: E402
from sugar_tpu_torch.scripts import bench  # noqa: E402

INT_FIELDS = ("radius", "tiles_touched", "rect_min", "rect_max")
FLOAT_FIELDS = ("mean2d", "conic", "opacity", "depth")


def port_prep(arrays, device) -> tuple[Preprocessed, rc.RasterSettings]:
    means, scales, quats, opac, colors = (torch.as_tensor(x, device=device) for x in arrays)
    cam = chip_smoke.ring_cameras(1, device)[0]
    settings = rc.from_camera(cam, device=device)
    with torch.no_grad():
        prep = preprocess(means, opac, settings, scales=scales, quaternions=quats, colors=colors)
    return prep, settings


def port_bin(prep: Preprocessed, settings) -> dict:
    n = prep.mean2d.shape[0]
    caps = chip_smoke.CAPS
    return bin_fused(prep, settings.tiles_x * settings.tiles_y, settings.tiles_x,
                     caps.tile_cap, caps.cap_a, default_big_cap(n), caps.dup_capacity)


def numpy_of(prep, b) -> dict:
    out = {k: np.asarray(getattr(prep, k).cpu() if hasattr(getattr(prep, k), "cpu")
                         else getattr(prep, k)) for k in INT_FIELDS + FLOAT_FIELDS}
    out.update({k: np.asarray(b[k].cpu() if hasattr(b[k], "cpu") else b[k])
                for k in ("gid", "tile_count", "counts_culled", "num_rendered")})
    return out


def summary(x: dict) -> dict:
    return dict(num_rendered=int(x["num_rendered"]), max_tile_count=int(x["tile_count"].max()))


def diff(a: dict, b: dict) -> dict:
    """Gaussians whose integer fields / culled counts differ between two
    runs, the largest float difference of each float field, and whether
    the sorted dup order (gid) is identical."""
    out = {f"gaussians_{k}_differ": int((a[k] != b[k]).reshape(a[k].shape[0], -1).any(-1).sum())
           for k in INT_FIELDS + ("counts_culled",)}
    out["culled_count_sum_diff"] = int(a["counts_culled"].astype(np.int64).sum()
                                       - b["counts_culled"].astype(np.int64).sum())
    for k in FLOAT_FIELDS:
        fa, fb = a[k].astype(np.float64), b[k].astype(np.float64)
        fin = np.isfinite(fa) & np.isfinite(fb)
        out[f"{k}_max_abs_diff"] = float(np.abs(fa - fb)[fin].max())
    out["gid_equal"] = bool(np.array_equal(a["gid"], b["gid"]))
    return out


def jax_cpu(arrays) -> dict | None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    try:
        import jax
    except ImportError:
        return None
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sugar_tpu.core.cameras import make_camera
    from sugar_tpu.raster import fused as jfused
    from sugar_tpu.raster.common import from_camera
    from sugar_tpu.raster.preprocess import preprocess as jpreprocess

    means, scales, quats, opac, colors = (jnp.asarray(x) for x in arrays)
    h, w, fov = chip_smoke.H, chip_smoke.W, chip_smoke.FOV
    st = from_camera(make_camera(R=np.eye(3), T=np.zeros(3), fov_x=fov, fov_y=fov,
                                 height=h, width=w))
    prep = jpreprocess(means, opac, st, scales=scales, quaternions=quats, colors=colors)
    n = means.shape[0]
    caps = chip_smoke.CAPS
    b = jfused.bin_fused(prep, st.tiles_x * st.tiles_y, st.tiles_x, caps.tile_cap, caps.cap_a,
                         default_big_cap(n), caps.dup_capacity)
    return numpy_of(prep, b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=chip_smoke.N_GAUSS, help="number of Gaussians")
    n = ap.parse_args().n
    arrays = bench._scene_trained(n, np.random.default_rng(chip_smoke.SCENE_SEED))
    res: dict = {"scene": f"{n} Gaussians, view 0, {chip_smoke.H}x{chip_smoke.W}",
                 "jax_tpu_record": dict(zip(("num_rendered", "max_tile_count"),
                                            chip_smoke.JAX_TPU_RECORD))}
    prep_c, st_c = port_prep(arrays, "cpu")
    cpu = numpy_of(prep_c, port_bin(prep_c, st_c))
    res["port_cpu"] = summary(cpu)
    if torch.cuda.is_available():
        prep_g, st_g = port_prep(arrays, "cuda")
        gpu = numpy_of(prep_g, port_bin(prep_g, st_g))
        res["port_gpu"] = summary(gpu)
        res["port_gpu_vs_port_cpu"] = diff(gpu, cpu)
        moved = Preprocessed(**{k: getattr(prep_c, k).cuda()
                                for k in Preprocessed.__dataclass_fields__})
        g_of_c = numpy_of(prep_c, port_bin(moved, st_g))
        res["port_gpu_bin_of_cpu_prep"] = summary(g_of_c)
        res["port_gpu_bin_of_cpu_prep_vs_port_cpu"] = diff(g_of_c, cpu)
        del prep_g, moved
    jx = jax_cpu(arrays)
    if jx is None:
        res["jax_cpu"] = "jax is not installed here"
    else:
        res["jax_cpu"] = summary(jx)
        res["port_cpu_vs_jax_cpu"] = diff(cpu, jx)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
