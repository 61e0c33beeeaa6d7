"""Vanilla 3DGS training entry point (the reference
gaussian_splatting/train.py); the port of ``scripts/train_vanilla_gs.py``.

    python -m sugar_tpu_torch.scripts.train_vanilla_gs -s <scene> -o <output>
"""

from __future__ import annotations

import argparse

from sugar_tpu_torch.pipeline import PipelineConfig, load_scene, run_vanilla


def main(argv=None, device="cuda") -> str:
    p = argparse.ArgumentParser()
    p.add_argument("-s", "--scene_path", required=True)
    p.add_argument("-o", "--output_dir", default="./output")
    p.add_argument("--iterations", type=int, default=7000)
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--ip", default=None, help="network-GUI host (enables the "
                   "live-viewer protocol server, reference train.py:52-65)")
    p.add_argument("--port", type=int, default=6009)
    args = p.parse_args(argv)
    cfg = PipelineConfig(
        scene_path=args.scene_path,
        output_dir=args.output_dir,
        vanilla_iterations=args.iterations,
        white_background=args.white_background,
    )
    gui = None
    if args.ip:
        from sugar_tpu_torch.viewer.network_gui import NetworkGUI

        gui = NetworkGUI(args.ip, args.port)
    try:
        ckpt = run_vanilla(cfg, load_scene(cfg, device=device), network_gui=gui)
    finally:
        if gui is not None:
            gui.close()
    print("checkpoint:", ckpt)
    return ckpt


if __name__ == "__main__":
    main()
