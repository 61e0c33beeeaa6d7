"""The readings that set each cell's limits from above: the reference put
in the program's place in a lower precision (the control), and for a
training cell the planted fault that leaves half of the batch out of the
loss; each compared with the float32 reference as a run compares the
program.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13

prints one JSON line per seed: the control's numbers (``bfloat16``: the
render and the loss in bfloat16, the optimizer's state in float32) and,
for training, the fault's (``half``). A fault that returns the state
unchanged reads 1 in ``change_gap`` by the measure itself and needs no
run. The harness's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from benchmark import checks, run, scenes
from benchmark.drivers import common, serve_orbit
from benchmark.drivers import train as loop
from benchmark.frozen import require_cuda


def serve_images(model, inp: dict, cfg: dict, traffic: dict, dev, dtype, picks: list) -> list:
    views = scenes.orbit_views(cfg, traffic)
    return [model.reference_image(inp, views[i], dev, dtype=dtype).cpu() for i in picks]


def readings(name: str, seed: int, dev, cfg_override: dict | None = None) -> dict:
    spec = run.load_spec()
    _, cfg, traffic, limits = run.cell_parts(spec, name)
    cfg = dict(cfg, **(cfg_override or {}))
    model = importlib.import_module(f"benchmark.models.{cfg['model']}")
    common.reference_precision()
    if traffic["kind"] == "train":
        from sugar_tpu_torch.trainers.schedule import CameraSchedule

        inp = model.build(cfg, seed, dev, "train")
        # The views the loop's schedule gives the first steps.
        it0 = traffic["start_iteration"]
        sched = CameraSchedule(loop.SCHEDULE_SEED, len(inp["views"]))
        views = [sched.index(it0 + k) for k in range(loop.FIRST)]
        ref = loop.reference_steps(model, inp, it0, views, dev)
        out = {}
        for label, kw in (("bfloat16", dict(dtype=torch.bfloat16)), ("half", dict(half=True))):
            out[label] = checks.train_numbers(
                loop.reference_steps(model, inp, it0, views, dev, **kw), ref)
        out["unchanged"] = dict(change_gap=1.0)
    else:
        inp = model.build(cfg, seed, dev, "serve")
        g = torch.Generator().manual_seed(seed)
        picks = torch.randperm(traffic["views"], generator=g)[:serve_orbit.SAMPLE].tolist()
        ref = serve_images(model, inp, cfg, traffic, dev, torch.float32, picks)
        low = serve_images(model, inp, cfg, traffic, dev, torch.bfloat16, picks)
        out = dict(bfloat16=checks.serve_numbers([(checks.to_uint8(a), b)
                                                  for a, b in zip(low, ref)]))
    return dict(workload=name, seed=seed, limits=limits, **out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    try:
        require_cuda("benchmark.control")
    except RuntimeError as e:
        print(f"control: {e}", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
