"""The port imports neither JAX nor the JAX package, and chip_smoke.py
refuses to run without a CUDA card.

Each check runs in a fresh interpreter: one with ``jax`` and
``sugar_tpu`` blocked in ``sys.modules`` imports every module of
``sugar_tpu_torch`` and ``chip_smoke``.
"""

import os
import pkgutil
import shutil
import subprocess
import sys

import torch

import sugar_tpu_torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    mods = ["sugar_tpu_torch"]
    for info in pkgutil.walk_packages(sugar_tpu_torch.__path__, "sugar_tpu_torch."):
        mods.append(info.name)
    return mods


def _run(code):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=240,
    )


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for m in ("core.sh", "core.cameras", "raster.preprocess", "raster.fused",
              "raster.dup_gather", "raster.tile_composite", "raster.api",
              "raster.adaptive", "io.ply", "models.gaussians", "models.render",
              "utils.losses", "interop", "native", "raster.segsum",
              "trainers.optimizer", "trainers.schedule", "trainers.vanilla",
              "models.densifier", "utils.checkpoint", "io.colmap", "io.datasets",
              "fields.knn", "fields.density", "fields.regularizers", "fields.normals",
              "trainers.coarse", "meshing.poisson", "meshing.meshops", "meshing.levelset",
              "meshing.extract", "meshing.ablations", "refine.bound", "refine.trainer",
              "io.png", "io.obj", "io.blender_interop", "raster.binning", "refine.mesh_raster",
              "refine.texture", "refine.extract_textured", "eval.metrics", "eval.parity",
              "utils.profiling", "viewer.network_gui", "viewer.export", "pipeline",
              "scripts.train_full_pipeline", "scripts.extract_mesh", "scripts.train_refined",
              "scripts.extract_refined_mesh_with_texture", "scripts.metrics",
              "scripts.run_viewer", "raster.composite", "raster.reference_impl",
              "raster.tiled", "raster.twopass", "models.compositor", "scripts.render",
              "scripts.train_vanilla_gs", "scripts.demo_hybrid", "scripts.compose_animation",
              "scripts.run_parity", "scripts.full_eval", "scripts.convert",
              "parallel.launch", "parallel.comm", "parallel.mesh", "parallel.render",
              "parallel.train", "parallel.trainer", "parallel.knn", "parallel.coarse",
              "parallel.refine", "parallel.meshing", "scripts.scaling_report", "scripts.bench",
              "scripts.profile_raster", "scripts.profile_trained", "scripts.microbench_gather",
              "scripts.microbench_prims", "scripts.microbench_sort"):
        assert f"sugar_tpu_torch.{m}" in mods, m


def test_imports_without_jax_or_sugar_tpu():
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sugar_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None and "
        "(k == 'jax' or k.startswith('jax.') or k == 'sugar_tpu' or k.startswith('sugar_tpu.')))\n"
        "assert not bad, bad\n"
        "print('imported', len(sys.modules))\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported" in r.stdout


def test_importing_builds_nothing():
    """The kernel libraries and the host QEM library are built and loaded on
    first use, not at import, and neither the scene loaders nor any entry
    point imports Pillow (the loaders import it only when they read an
    image; the entry points write PNGs through io/png.py)."""
    code = (
        "import sys, os\n"
        "import sugar_tpu_torch.raster.tile_composite as t, sugar_tpu_torch.native as n\n"
        "import sugar_tpu_torch.raster.segsum as s, sugar_tpu_torch.trainers.coarse\n"
        "import sugar_tpu_torch.io.datasets\n"
        "before = sorted(os.listdir(n._BUILD)) if os.path.isdir(n._BUILD) else []\n"
        "import sugar_tpu_torch.meshing.extract, sugar_tpu_torch.meshing.ablations\n"
        "import sugar_tpu_torch.refine.trainer, sugar_tpu_torch.pipeline\n"
        "import sugar_tpu_torch.scripts.metrics, sugar_tpu_torch.viewer.network_gui\n"
        "from sugar_tpu_torch.scripts import render, train_vanilla_gs, demo_hybrid\n"
        "from sugar_tpu_torch.scripts import compose_animation, run_parity, full_eval, convert\n"
        "from sugar_tpu_torch.scripts import bench, profile_raster, profile_trained\n"
        "from sugar_tpu_torch.scripts import microbench_gather, microbench_prims, microbench_sort\n"
        "after = sorted(os.listdir(n._BUILD)) if os.path.isdir(n._BUILD) else []\n"
        "assert before == after, (before, after)\n"
        "assert 'PIL' not in sys.modules\n"
        "assert n._libs == {}\n"
        "assert t.tile_composite_cuda.launches == 0\n"
        "assert t.tile_composite_bwd_cuda.launches == 0\n"
        "assert s.segment_sum_cuda.launches == 0\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr[-3000:]


def test_chip_smoke_fails_without_cuda():
    assert not torch.cuda.is_available()
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True,
        timeout=240, env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=240, env=dict(os.environ, PYTHONPATH=""),
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
