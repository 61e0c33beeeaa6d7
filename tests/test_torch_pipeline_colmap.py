"""The pipeline from a COLMAP text scene on disk, the port against the JAX
package on the CPU, at a toy size of ``chip_smoke.py``'s [18]: its scene
writer (``write_colmap_scene``: 9 ring views at 48x48 of 200 Gaussians of
bench.py's trained scene) and the configuration ``train_full_pipeline``
builds (high_poly, sdf, long, eval split), with toy iteration counts and
sizes on top.

- The CLI: both packages' ``train_full_pipeline`` build the same config.
- The scene: the port's ``load_scene`` reads every view of the text model;
  the JAX package's text reader drops the image after each empty 2D-point
  line (ROADMAP.md, queue 3), so the JAX side reads the same scene from its
  binary twin. Cameras within 1e-6; images, points, colours, names, extent
  and split equal.
- The artifacts: ``run_full_pipeline`` writes the JAX package's names, and
  the JAX package's loaders read each artifact to the port's arrays; a
  second run skips every stage.
- ``train_refined``: the port's ``main`` against the JAX script (through
  ``runpy``) on the same scene and mesh, 2 iterations, both rendering in
  the JAX script's CPU mode ("tiled") from unequal in-plane scales (as
  ``tests/test_torch_refine.py`` does): every refined field within 1e-4,
  that file's refined_training window tolerance.
"""

import dataclasses
import functools
import json
import os
import pickle
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sugar_tpu.pipeline as jpipe
from test_io import write_colmap_binary
from test_torch_refine import unequal_scales
from sugar_tpu.io import colmap as jcolmap
from sugar_tpu.io import obj as jobj
from sugar_tpu.io import ply as jply
from sugar_tpu.models import gaussians as jgm
from sugar_tpu.refine import bound as JB
from sugar_tpu.refine import trainer as jtrainer
from sugar_tpu_torch import pipeline as pipe
from sugar_tpu_torch.io import obj, ply
from sugar_tpu_torch.models import gaussians as gm
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.refine import bound as B
from sugar_tpu_torch.refine import trainer
from sugar_tpu_torch.refine.bound import BOUND_FIELDS
from sugar_tpu_torch.scripts import train_refined

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEWS, SIZE, N_POINTS = chip_smoke.PIPE_VIEWS, 48, 200
CAPS = adaptive.RasterCaps(tile_cap=16, dup_capacity=8192, k_max=512)
# Toy counts and sizes on the CLI's presets: [18]'s vanilla cadence over 60
# iterations (enough for Gaussians to pass the 0.5 opacity prune at 9000),
# its coarse window, 3 refine iterations; caps and the Poisson grid for a
# 48x48 scene.
TOY = dict(
    capacity=1024, vanilla_iterations=60,
    vanilla_overrides=dict(densify_from=20, densify_every=25, k_max=512, log_every=10),
    coarse_overrides=dict(start_iteration=chip_smoke.COARSE_START,
                          num_iterations=chip_smoke.COARSE_END, k_max=512,
                          n_samples_for_sdf_regularization=2000, log_every=1),
    extract_overrides=dict(poisson_resolution=48, dup_capacity=2**14, k_max=512),
    refine_overrides=dict(num_iterations=3, k_max=512, log_every=1),
)
REFINE_ATOL = 1e-4


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The text scene and its binary twin (the same cameras, images and
    points; the images directory linked). Returns (text root, twin root,
    written pixels)."""
    root = str(tmp_path_factory.mktemp("colmap"))
    text, twin = os.path.join(root, "text"), os.path.join(root, "twin")
    pixels, cams, imgs, (xyz, rgb) = chip_smoke.write_colmap_scene(
        text, chip_smoke.train_scene_fields(N_POINTS, chip_smoke.TRAIN_SEED), VIEWS, SIZE, CAPS,
        "cpu")
    write_colmap_binary(os.path.join(twin, "sparse", "0"), list(cams.values()),
                        list(imgs.values()), (xyz, rgb, np.zeros(len(xyz))))
    os.symlink(os.path.join(text, "images"), os.path.join(twin, "images"))
    return text, twin, pixels


@pytest.fixture(scope="module")
def run(scene, tmp_path_factory):
    """run_full_pipeline on the text scene with the CLI's config and TOY.
    Returns (config, artifacts, logs)."""
    out = str(tmp_path_factory.mktemp("out"))
    cfg = dataclasses.replace(chip_smoke.cli_config(["-s", scene[0], "-o", out]), **TOY)
    logs = []
    art = pipe.run_full_pipeline(cfg, log_fn=logs.append, device="cpu")
    return cfg, art, [json.loads(r) for r in logs]


def test_cli_builds_the_jax_scripts_config(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(jpipe, "run_full_pipeline", lambda cfg: seen.setdefault("cfg", cfg) and {})
    monkeypatch.setattr(sys, "argv", ["train_full_pipeline.py", "-s", "scene", "-o", "out"])
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script prepends the repo
    runpy.run_path(os.path.join(ROOT, "scripts", "train_full_pipeline.py"), run_name="__main__")
    t = chip_smoke.cli_config(["-s", "scene", "-o", "out"])
    assert dataclasses.asdict(t) == dataclasses.asdict(seen["cfg"])
    assert (t.poly, t.regularization, t.refinement_time, t.eval_split, t.capacity) == (
        "high_poly", "sdf", "long", True, 2**19)


def test_port_reads_every_view_of_the_text_scene(scene):
    text, _, pixels = scene
    t = pipe.load_scene(pipe.PipelineConfig(scene_path=text), device="cpu")
    assert t.image_names == [f"view_{i:03d}.png" for i in range(VIEWS)]
    assert t.split() == (list(range(1, VIEWS - 1)), [0, VIEWS - 1])
    for img, px in zip(t.images, pixels):
        np.testing.assert_array_equal(img, px.astype(np.float32) / 255.0)
    # The JAX text reader keeps every other image of the same file.
    names = sorted(im.name for im in jcolmap.read_images_text(
        os.path.join(text, "sparse", "0", "images.txt")).values())
    assert names == [f"view_{i:03d}.png" for i in range(0, VIEWS, 2)]


def test_load_scene_matches_jax(scene):
    text, twin, _ = scene
    t = pipe.load_scene(pipe.PipelineConfig(scene_path=text), device="cpu")
    j = jpipe.load_scene(jpipe.PipelineConfig(scene_path=twin))
    assert len(t.cameras) == len(j.cameras) == VIEWS
    for a, b in zip(t.cameras, j.cameras):
        assert (a.height, a.width) == (b.height, b.width) == (SIZE, SIZE)
        assert a.tan_half_fov_x == pytest.approx(b.tan_half_fov_x, rel=1e-12)
        assert a.tan_half_fov_y == pytest.approx(b.tan_half_fov_y, rel=1e-12)
        for f in ("world_view", "full_proj", "cam_center"):
            np.testing.assert_allclose(getattr(a, f).numpy(), np.asarray(getattr(b, f)), rtol=0,
                                       atol=1e-6, err_msg=f)
    assert t.image_names == j.image_names
    for a, b in zip(t.images, j.images):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(t.points, j.points, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.colors, j.colors, rtol=0, atol=1e-6)
    assert abs(t.extent - j.extent) <= 1e-6
    assert t.split(True) == j.split(True) and t.split(False) == j.split(False)


def test_pipeline_writes_the_jax_artifact_names(run):
    cfg, art, logs = run
    names = {k: os.path.relpath(v, cfg.output_dir) for k, v in art.items()}
    assert names == dict(
        vanilla=os.path.join("vanilla_gs", "iteration_60", "point_cloud.ply"),
        coarse=os.path.join("coarse", "coarse_15000.ply"),
        mesh=os.path.join("coarse_mesh", "mesh_level0.3_decim1000000.ply"),
        refined=os.path.join("refined", "refined_1gpt_15000.ply"),
        textured=os.path.join("refined_mesh", "textured.obj"))
    alive = {r["iter"]: r["n_alive"] for r in logs if "n_alive" in r}
    assert 0 < alive[chip_smoke.COARSE_END] < alive[chip_smoke.COARSE_START + 1]  # the prune


def test_jax_loads_every_artifact(run):
    _, art, _ = run
    for key in ("vanilla", "coarse", "refined"):
        t, j = gm.load_ply(art[key], device="cpu"), jgm.load_ply(art[key])
        assert t.capacity == j.capacity and t.sh_degree == j.sh_degree
        np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))
        for f in PARAM_FIELDS:
            np.testing.assert_array_equal(getattr(t.params, f).numpy(),
                                          np.asarray(getattr(j.params, f)), err_msg=f"{key} {f}")
    for a, b in zip(ply.load_mesh_ply(art["mesh"]), jply.load_mesh_ply(art["mesh"])):
        np.testing.assert_array_equal(a, b)
    state = art["refined"].replace(".ply", "_state.pkl")
    tp, tbm = trainer.load_refined_state(state, device="cpu")
    jp, jbm = jtrainer.load_refined_state(state)
    for f in BOUND_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(tbm.faces.numpy(), np.asarray(jbm.faces))
    assert tbm.n_per_triangle == jbm.n_per_triangle == 1
    assert int(tp.opacity_logit.shape[0]) == len(tbm.faces)  # 1 Gaussian per triangle
    for a, b in zip(obj.load_obj(art["textured"]), jobj.load_obj(art["textured"])):
        np.testing.assert_array_equal(a, b)


def test_second_run_skips_every_stage(run):
    cfg, art, _ = run
    logs = []
    assert pipe.run_full_pipeline(cfg, log_fn=logs.append, device="cpu") == art
    assert [json.loads(r)["stage"] for r in logs] == list(chip_smoke.PIPE_STAGES)


def test_train_refined_matches_jax_script(scene, run, tmp_path, monkeypatch):
    text, twin, _ = scene
    _, art, _ = run
    iters = "2"
    monkeypatch.setattr(pipe, "RefineConfig",
                        functools.partial(trainer.RefineConfig, render_mode="tiled"))
    # Equal in-plane scales make the in-plane rotation a symmetry, whose
    # gradient is rounding that Adam's first steps blow up to +-lr:
    # tests/test_torch_refine.py's offsets break it in both packages.
    monkeypatch.setattr(JB, "init_bound_params", unequal_scales(JB.init_bound_params, jnp.asarray))
    monkeypatch.setattr(B, "init_bound_params", unequal_scales(B.init_bound_params, torch.as_tensor))
    out = train_refined.main(["-s", text, "-m", art["mesh"], "-o", str(tmp_path / "port"),
                              "-f", iters], device="cpu")
    monkeypatch.setattr(sys, "argv", ["train_refined.py", "-s", twin, "-m", art["mesh"], "-o",
                                      str(tmp_path / "jax"), "-f", iters])
    monkeypatch.setattr(sys, "path", list(sys.path))
    runpy.run_path(os.path.join(ROOT, "scripts", "train_refined.py"), run_name="__main__")
    jout = os.path.join(tmp_path, "jax", os.path.relpath(out, tmp_path / "port"))
    with open(out.replace(".ply", "_state.pkl"), "rb") as f:
        t = pickle.load(f)
    with open(jout.replace(".ply", "_state.pkl"), "rb") as f:
        j = pickle.load(f)
    assert t.keys() == j.keys() and t["n_per_triangle"] == j["n_per_triangle"] == 1
    np.testing.assert_array_equal(t["faces"], j["faces"])
    for f in BOUND_FIELDS:
        np.testing.assert_allclose(t[f], j[f], rtol=0, atol=REFINE_ATOL, err_msg=f)
    tm, jm = gm.load_ply(out, device="cpu"), gm.load_ply(jout, device="cpu")
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(tm.params, f).numpy(), getattr(jm.params, f).numpy(),
                                   rtol=0, atol=REFINE_ATOL, err_msg=f)
