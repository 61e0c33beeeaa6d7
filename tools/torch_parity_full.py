"""The parity protocol at its full depth on the card, instrumented.

Runs ``sugar_tpu_torch.scripts.run_parity.main(["--out", OUT, "--workdir",
DIR])``, the entry point as ``python -m sugar_tpu_torch.scripts.run_parity``
runs it (the full configuration: 60k GT Gaussians, a 15k-Gaussian
degraded init, 80 cameras at 256x256, capacity 2^17, 3,000 / 1,200 /
7,000 iterations), through ``chip_smoke.parity_protocol``, which
``chip_smoke.py`` ``[19]`` runs at a cut depth: the plain K1-K3 raise;
each stage prints its wall, launches and peak GB and holds K1-K3 to their
plain versions on its last launches; every record the stages log (densify
passes, KNN builds, cap growth, live counts) and every QEM call are
printed; the scores are checked as ``[19]`` checks them. Run from the
repository root on a machine with a CUDA card:

    python3 tools/torch_parity_full.py [--out PARITY_torch_r01.json] [--iters 3000,1200,7000]

It writes the results JSON (run_parity's) to ``--out`` and exits 1 when a
check failed. The full depth takes tens of minutes.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (parity_protocol; numpy + torch only)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "PARITY_torch_r01.json"))
    p.add_argument("--workdir", default=os.path.join(ROOT, "sugar_tpu_torch", "_build",
                                                     "parity_full"))
    p.add_argument("--iters", default=None,
                   help="vanilla,coarse,refine iterations (default: the full configuration's)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_parity_full: this needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' bmm, as chip_smoke
    torch.backends.cudnn.allow_tf32 = False
    iters = tuple(int(x) for x in args.iters.split(",")) if args.iters else None
    card = chip_smoke.card_line()
    print(card, flush=True)
    shutil.rmtree(args.workdir, ignore_errors=True)
    check = chip_smoke.Checks()
    try:
        chip_smoke.parity_protocol(check, torch.device("cuda:0"), card, "[parity]", iters,
                                   args.out, args.workdir)
    finally:
        shutil.rmtree(args.workdir, ignore_errors=True)
    if check.failures:
        print(f"torch_parity_full: {len(check.failures)} check(s) failed: {check.failures}",
              file=sys.stderr)
        return 1
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
