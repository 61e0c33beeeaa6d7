"""COLMAP SfM front end (the reference gaussian_splatting/convert.py:1-124);
the port of ``scripts/convert.py``. Runs feature_extractor -> matcher ->
mapper -> undistorter to lay out the dataset the pipeline reads. Needs the
``colmap`` binary on PATH; raises SystemExit when it is missing.

    python -m sugar_tpu_torch.scripts.convert -s <dir with input/ images>
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess


def run(cmd: list[str]) -> None:
    print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("-s", "--source_path", required=True, help="dir with input/ images")
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    args = p.parse_args(argv)

    if shutil.which("colmap") is None:
        raise SystemExit("error: colmap binary not found on PATH; install COLMAP or run "
                         "SfM elsewhere and provide sparse/0 + images/ directly.")

    src = args.source_path
    use_gpu = "0" if args.no_gpu else "1"
    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        run(["colmap", "feature_extractor",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", args.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run(["colmap", "exhaustive_matcher",
             "--database_path", f"{src}/distorted/database.db",
             "--SiftMatching.use_gpu", use_gpu])
        run(["colmap", "mapper",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--output_path", f"{src}/distorted/sparse",
             "--Mapper.ba_global_function_tolerance=0.000001"])
    run(["colmap", "image_undistorter",
         "--image_path", f"{src}/input",
         "--input_path", f"{src}/distorted/sparse/0",
         "--output_path", src,
         "--output_type", "COLMAP"])
    # Move the sparse files into sparse/0 (reference convert.py:92-103).
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f != "0":
            shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))
    print("done:", src)
    return src


if __name__ == "__main__":
    main()
