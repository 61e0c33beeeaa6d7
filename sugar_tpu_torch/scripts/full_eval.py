"""Benchmark-suite orchestration (the reference
gaussian_splatting/full_eval.py:15-74); the port of
``scripts/full_eval.py``. Runs train + metrics over the standard scene sets
whose data directories exist under ``--base_dir`` (mipnerf360: 9 scenes,
tanksandtemples: 2, deepblending: 2), skipping the missing ones. The JAX
script runs each step in a subprocess; this one calls the port's entry
points in-process, so they run on the caller's ``device``.

    python -m sugar_tpu_torch.scripts.full_eval --base_dir <datasets>
"""

from __future__ import annotations

import argparse
import json
import os

from sugar_tpu_torch.scripts import metrics, train_full_pipeline

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def main(argv=None, device="cuda") -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", required=True)
    p.add_argument("--output_dir", default="./output/full_eval")
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    args = p.parse_args(argv)

    scenes = MIPNERF360_OUTDOOR + MIPNERF360_INDOOR + TANKS_AND_TEMPLES + DEEP_BLENDING
    results = {}
    for scene in scenes:
        spath = os.path.join(args.base_dir, scene)
        if not os.path.isdir(spath):
            print(f"skip {scene}: not found")
            continue
        out = os.path.join(args.output_dir, scene)
        if not args.skip_training:
            train_full_pipeline.main(["-s", spath, "-o", out, "-r", "sdf"], device=device)
        if not args.skip_metrics:
            ckpt = os.path.join(out, "coarse", "coarse_15000.ply")
            results[scene] = metrics.main(
                ["--scene_path", spath, "--checkpoint", ckpt,
                 "--output", os.path.join(args.output_dir, "metrics.json")],
                device=device,
            )
    summary = {s: {obj: {k: v for k, v in r.items() if not k.startswith("per_")}
                   for obj, r in objs.items()} for s, objs in results.items()}
    print(json.dumps(summary, indent=2))
    return results


if __name__ == "__main__":
    main()
