"""How many Gaussians the coarse prune keeps, against where the coarse
window starts.

The coarse stage runs entropy regularization on the opacities from
iteration 7000 to 9000 and then prunes every Gaussian under opacity 0.5
(trainers/coarse.py). A run cut in depth starts the stage later, so its
prune sees fewer entropy steps. This script writes ``chip_smoke.py``
``[18]``'s COLMAP scene (the 2^18 scene, 9 ring views at 512x512), runs
the vanilla stage as ``[18]`` configures it, then runs ``train_coarse``
from each start iteration up to the prune at 9000 (the pipeline's
``run_coarse`` arguments, no checkpoints) and reports for each start:
the wall time, the opacity quantiles just before the prune, and how many
Gaussians the prune keeps. Run from the repository root on a machine with
a CUDA card:

    python3 tools/torch_prune_window.py [--starts 8990,8900,8500] [--out DIR]

It prints the card line and one JSON object per start.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  ([18]'s scene writer and configuration, numpy + torch only)
from sugar_tpu_torch import pipeline  # noqa: E402
from sugar_tpu_torch.models.gaussians import load_ply  # noqa: E402
from sugar_tpu_torch.trainers.coarse import CoarseConfig, train_coarse  # noqa: E402

PRUNE_AT = 9_000
QUANTILES = (0.1, 0.5, 0.9, 0.99)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--starts", default="8990,8900,8750,8500,8000")
    p.add_argument("--out", default=os.path.join(ROOT, "sugar_tpu_torch", "_build",
                                                 "prune_window"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_prune_window: this needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    scene_dir, out_dir = os.path.join(args.out, "scene"), os.path.join(args.out, "out")
    shutil.rmtree(args.out, ignore_errors=True)
    chip_smoke.write_colmap_scene(
        scene_dir, chip_smoke.train_scene_fields(chip_smoke.TRAIN_N, chip_smoke.TRAIN_SEED),
        chip_smoke.PIPE_VIEWS, chip_smoke.H, chip_smoke.TRAIN_CAPS, dev)
    cfg = dataclasses.replace(chip_smoke.cli_config(["-s", scene_dir, "-o", out_dir]),
                              **chip_smoke.PIPE_WIDTH_ITERS)
    scene = pipeline.load_scene(cfg, device=dev)
    train_idx, _ = scene.split(cfg.eval_split)
    t0 = time.perf_counter()
    vanilla = pipeline.run_vanilla(cfg, scene, log_fn=lambda *_: None)
    vanilla_s = time.perf_counter() - t0
    model = load_ply(vanilla, device=dev)
    before = model.alive
    print(chip_smoke.card_line())
    print(json.dumps(dict(vanilla_iterations=cfg.vanilla_iterations, vanilla_s=vanilla_s,
                          alive=int(before.sum()))))
    q = torch.tensor(QUANTILES, device=dev)
    for start in (int(s) for s in args.starts.split(",")):
        ccfg = CoarseConfig(mode="sdf", white_background=cfg.white_background,
                            start_iteration=start, num_iterations=PRUNE_AT, log_every=PRUNE_AT)
        logs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_coarse(model, [scene.cameras[i] for i in train_idx],
                           [scene.images[i] for i in train_idx], extent=scene.extent, cfg=ccfg,
                           log_fn=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        op = torch.sigmoid(out.params.opacity_logit[before])
        print(json.dumps(dict(
            start=start, entropy_steps=PRUNE_AT - 1 - max(start, ccfg.entropy_start),
            wall_s=wall, opacity_quantiles=dict(zip(map(str, QUANTILES),
                                                    torch.quantile(op, q).tolist())),
            under_0_05=int((op < 0.05).sum()), over_0_95=int((op > 0.95).sum()),
            kept=int(out.alive.sum()), of=int(before.sum()), loss=logs[-1]["loss"],
            psnr=logs[-1]["psnr"])))
        del out, op
    shutil.rmtree(args.out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
