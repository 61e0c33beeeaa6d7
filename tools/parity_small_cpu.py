"""The parity protocol's ``--small`` configuration in both packages on the
CPU, side by side.

Runs the port's ``sugar_tpu_torch.scripts.run_parity.main(["--small",
...], device="cpu")`` and the JAX package's ``scripts/run_parity.py
--small`` (through ``runpy``, its compilation-cache settings dropped) on
the same procedural scene and configuration (4k GT Gaussians, a
1.5k-Gaussian degraded init, 16 cameras at 128x128, 300 / 300 / 200
iterations), both in the ``"tiled"`` mode the JAX script picks on a CPU,
and prints each stage's held-out PSNR and SSIM, their differences, and
the two ordering invariants of ``tests/test_parity.py`` (coarse > vanilla
- 1 dB, refined > coarse - 3 dB) for each package. The packages draw
their own densify, SDF-sample and density-sample noise, so the scores
agree only to that noise. Run from the repository root:

    python3 tools/parity_small_cpu.py [--workdir DIR] [--only port|jax]

On two CPU cores the JAX side takes ~35 min and the port's (its plain
"tiled" mode, ~2 s a vanilla step) longer; on a card, ``python -m
sugar_tpu_torch.scripts.run_parity --small`` runs the port's side in
about a minute.

It writes ``parity_small_port.json`` and ``parity_small_jax.json`` under
``--workdir``.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("vanilla", "coarse_sdf", "refined")


def run_port(workdir: str) -> dict:
    import torch

    from sugar_tpu_torch.scripts import run_parity

    torch.set_num_threads(2)
    out = os.path.join(workdir, "parity_small_port.json")
    return run_parity.main(["--small", "--out", out, "--workdir", os.path.join(workdir, "port")],
                           device="cpu")


def run_jax(workdir: str) -> dict:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    update = jax.config.update
    jax.config.update = lambda k, v: None if "cache" in k else update(k, v)
    out = os.path.join(workdir, "parity_small_jax.json")
    argv = sys.argv
    sys.argv = ["run_parity.py", "--small", "--out", out, "--workdir",
                os.path.join(workdir, "jax")]
    try:
        runpy.run_path(os.path.join(ROOT, "scripts", "run_parity.py"), run_name="__main__")
    finally:
        sys.argv = argv
        jax.config.update = update
    with open(out) as f:
        return json.load(f)


def invariants(st: dict) -> dict:
    p = {k: st[k]["psnr"] for k in STAGES}
    return {"coarse - vanilla": p["coarse_sdf"] - p["vanilla"],
            "refined - coarse": p["refined"] - p["coarse_sdf"],
            "coarse > vanilla - 1": p["coarse_sdf"] > p["vanilla"] - 1.0,
            "refined > coarse - 3": p["refined"] > p["coarse_sdf"] - 3.0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", default=os.path.join(ROOT, "sugar_tpu_torch", "_build",
                                                     "parity_small"))
    p.add_argument("--only", choices=("port", "jax"), default=None)
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    res, walls = {}, {}
    for name, fn in (("port", run_port), ("jax", run_jax)):
        if args.only in (None, name):
            t0 = time.perf_counter()
            res[name] = fn(args.workdir)["stages"]
            walls[name] = time.perf_counter() - t0
    for name, st in res.items():
        print(json.dumps(dict(package=name, wall_s=round(walls[name], 1), stages=st,
                              invariants=invariants(st))))
    if len(res) == 2:
        print(json.dumps({k: dict(psnr=res["port"][k]["psnr"] - res["jax"][k]["psnr"],
                                  ssim=res["port"][k]["ssim"] - res["jax"][k]["ssim"])
                          for k in STAGES} | {"mesh": [res["port"]["mesh"], res["jax"]["mesh"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
