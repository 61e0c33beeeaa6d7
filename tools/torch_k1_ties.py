"""How often K1 and its plain version make one include decision apart.

K1 (``csrc/tile_composite.cu``) takes each pixel's product of (1 - alpha)
in slot order with ``expf``; its plain version (``tile_composite_plain``)
takes it with ``torch.cumprod`` and ``torch.exp``. Where a product lands
within rounding of T_EPS, or an alpha within rounding of the 1/255
cutoff, the two include one slot differently: a tie pixel. This script
renders the level set's depth map (depth as the three colour channels, its
fixed caps: dup 2^22, k_max 1024) of chip_smoke.py's 1M SH-3 scene from
``--views`` ring cameras, holds each K1 launch against the plain version
with ``chip_smoke.compare``, and reports the tie pixels: how many, by how
much their n_contrib, final_T and image moved, and whether each view
passes the tie rule of ``chip_smoke.compare_ok`` and the rule before it
(every pixel's image and final_T within 1e-4, no chunk count apart).

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_k1_ties.py [--views N] [--min-opacity X]

It prints the card line and one JSON object.
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

import chip_smoke  # noqa: E402  (the scene, the cameras and the comparison)
from sugar_tpu_torch.interop import model_from_numpy  # noqa: E402
from sugar_tpu_torch.raster.tile_composite import tile_composite_cuda, tile_composite_plain  # noqa: E402
from sugar_tpu_torch.trainers.coarse import render_params_with_colors  # noqa: E402

DUP_CAPACITY, K_MAX = 2**22, 1024  # level_surface_points_one_camera's defaults


def tie_details(kern, plain, limit: int = 4) -> list[dict]:
    """The first ``limit`` tie pixels' n_contrib, final_T and image change."""
    dn = kern.n_contrib - plain.n_contrib
    out = []
    tie = chip_smoke.tie_mask(kern.n_contrib, plain.n_contrib, kern.final_t, plain.final_t)
    for t, p in torch.nonzero(tie)[:limit].tolist():
        out.append(dict(tile=t, pixel=p, n_contrib_kernel_minus_plain=int(dn[t, p]),
                        final_t_kernel=float(kern.final_t[t, p]), final_t_plain=float(plain.final_t[t, p]),
                        img_diff=float((kern.img[t, p] - plain.img[t, p]).abs().max()),
                        nch_apart=bool(kern.nch[t] != plain.nch[t])))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--views", type=int, default=32)
    p.add_argument("--min-opacity", type=float, default=None,
                   help="raise every opacity to at least this (an opaque surface, as a trained "
                        "coarse model's, crosses T_EPS at a large alpha)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k1_ties: this needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    chip_smoke.native.build_all()
    n = chip_smoke.N_GAUSS
    arrays = chip_smoke.scene_params(n, chip_smoke.SCENE_SEED, chip_smoke.SH_DEGREE)
    if args.min_opacity is not None:
        floor = np.float32(np.log(args.min_opacity / (1.0 - args.min_opacity)))
        arrays["opacity_logit"] = np.maximum(arrays["opacity_logit"], floor)
    model = model_from_numpy(arrays, np.ones(n, bool), chip_smoke.SH_DEGREE, device=dev)
    views, old_fail, new_fail, ties_total = [], 0, 0, 0
    for i, cam in enumerate(chip_smoke.ring_cameras(args.views, dev)):
        zs = model.params.xyz @ cam.world_view[2, :3] + cam.world_view[2, 3]
        with torch.no_grad(), chip_smoke.recorded_kernel_args() as recs:
            render_params_with_colors(model.params, model.alive, cam, zs[:, None].expand(-1, 3),
                                      bg=torch.full((3,), -1.0, device=dev),
                                      dup_capacity=DUP_CAPACITY, k_max=K_MAX)
            (fw,) = recs["K1"]
            kern = tile_composite_cuda(*fw)
            plain = tile_composite_plain(*fw)
        d = chip_smoke.compare(kern, plain, fw)
        old_ok = (chip_smoke.abs_err(d) <= chip_smoke.ATOL_IMAGE and d["nch_mismatch"] == 0
                  and d["n_contrib_mismatch"] <= 1e-4 * d["pixels"] and d["n_contrib_max_diff"] <= 1)
        new_ok = chip_smoke.compare_ok(d)
        old_fail += not old_ok
        new_fail += not new_ok
        ties_total += d["tie_pixels"]
        views.append(dict(view=i, old_rule_ok=old_ok, new_rule_ok=new_ok, ties=tie_details(kern, plain),
                          **{k: d[k] for k in ("img", "final_t", "entry_p", "tie_pixels", "tie_img",
                                               "tie_img_bound", "n_contrib_mismatch", "nch_mismatch")}))
        del recs, fw, kern, plain
    print(chip_smoke.card_line())
    print(json.dumps(dict(scene=f"{n} Gaussians, SH {chip_smoke.SH_DEGREE}, depth colours",
                          min_opacity=args.min_opacity,
                          caps=[DUP_CAPACITY, K_MAX], views=args.views, tie_pixels=ties_total,
                          views_with_ties=sum(v["tie_pixels"] > 0 for v in views),
                          old_rule_failures=old_fail, new_rule_failures=new_fail,
                          max_non_tie_img=max(v["img"] for v in views),
                          per_view=[v for v in views if v["tie_pixels"] or not v["new_rule_ok"]])))
    return 0 if new_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
