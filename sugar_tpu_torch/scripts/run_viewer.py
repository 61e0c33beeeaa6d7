"""Viewer launcher (reference run_viewer.py:26-47); the port of
``scripts/run_viewer.py``: validates the ply/obj/png triplet and writes
the viewer's scene descriptor.

    python -m sugar_tpu_torch.scripts.run_viewer -p <refined.ply> -m <textured.obj>
"""

from __future__ import annotations

import argparse

from sugar_tpu_torch.viewer.export import write_scene_descriptor


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("-p", "--ply_path", required=True, help="refined gaussian PLY")
    p.add_argument("-m", "--obj_path", default=None, help="textured OBJ (optional)")
    p.add_argument("--viewer_dir", default="./sugar_viewer")
    args = p.parse_args(argv)
    out = write_scene_descriptor(args.viewer_dir, args.ply_path, args.obj_path)
    print("scene descriptor:", out)
    print("Serve any @mkkellogg/gaussian-splats-3d viewer (e.g. the reference's "
          "sugar_viewer) pointed at this descriptor.")
    return out


if __name__ == "__main__":
    main()
