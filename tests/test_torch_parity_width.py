"""``chip_smoke.py`` [19] on the CPU at a toy size, the port against the
JAX package where both have the function.

- The configuration [19] runs: ``run_parity.CONFIGS["full"]`` with only
  its iteration counts replaced by ``chip_smoke.PARITY_WIDTH_ITERS`` gives
  the port the scene and ``PipelineConfig`` that the JAX script
  ``scripts/run_parity.py`` builds for those iterations (its source run
  through ``exec`` with the full configuration's iteration line replaced,
  its compilation-cache settings dropped).
- The NeRF-synthetic writer (``write_nerf_synthetic``, RGBA PNGs through
  ``io/png``): both packages' ``load_blender_scene`` read it to the same
  cameras and images, within 1e-6 and 1/255 of the in-memory scene over a
  black and a white background, at resolution factors 1 and 2.
- A vanilla PLY in the reference layout loads equal through both
  packages' ``load_reference_checkpoint``.
- A second ``run_parity.main`` on the same workdir trains nothing: every
  stage logs ``stage_skip`` and no trainer or extractor runs.
"""

import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import sugar_tpu.eval.parity as jparity
import sugar_tpu.io.datasets as jds
import sugar_tpu.pipeline as jpipe
from sugar_tpu_torch import pipeline as pipe
from sugar_tpu_torch.eval.parity import make_parity_scene
from sugar_tpu_torch.io.datasets import load_blender_scene
from sugar_tpu_torch.io.png import read_png, write_png
from sugar_tpu_torch.models import gaussians as gm
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.scripts import run_parity

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL_ITERS_LINE = "vanilla_iters, coarse_iters, refine_iters = 3_000, 1_200, 7_000"
# run_parity at a toy size whose coarse prune (at 30% of the window) falls
# on the window's first iteration, which the trainer does not run
# (tests/test_torch_run_parity.py's TOY).
TOY = (dict(n_gt=600, n_init=300, n_cams=8, resolution=32), (30, 3, 6), 1024,
       dict(total_points=20_000, poisson_resolution=32, decimation_target=500,
            dup_capacity=2**13, prune_opacity_threshold=0.05))
SCENE = dict(n_gt=600, n_init=300, n_cams=16, resolution=32)


class Stop(Exception):
    pass


def run_jax_parity_with(iters, argv, monkeypatch):
    """scripts/run_parity.py as ``python scripts/run_parity.py argv`` runs
    it, with the full configuration's iterations set to ``iters`` and its
    compilation-cache settings dropped."""
    path = os.path.join(ROOT, "scripts", "run_parity.py")
    with open(path) as f:
        src = f.read()
    assert src.count(FULL_ITERS_LINE) == 1
    src = src.replace(FULL_ITERS_LINE, "vanilla_iters, coarse_iters, refine_iters = "
                      + ", ".join(str(i) for i in iters))
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: None if "cache" in k else update(k, v))
    monkeypatch.setattr(sys, "argv", [path] + list(argv))
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script prepends the repo
    try:
        exec(compile(src, path, "exec"), {"__name__": "__main__", "__file__": path})
    finally:
        monkeypatch.setattr(jax.config, "update", update)


def test_parity_width_config_matches_the_jax_script(tmp_path, monkeypatch):
    """[19]'s scene and PipelineConfig are the JAX script's at [19]'s
    iterations, up to the port's render_mode in each stage."""
    got = {}
    fake_scene = type("S", (), dict(split=lambda self, e: (list(range(70)), list(range(0, 80, 8))),
                                    cameras=[None] * 80))()

    def scene(who):
        def make(**kw):
            got[who + "_scene"] = kw
            return fake_scene, None
        return make

    def jax_config(**kw):
        got["jax_cfg"] = kw
        raise Stop

    def port_vanilla(cfg, *args, **kw):
        got["port_cfg"] = cfg
        raise Stop

    argv = ["--workdir", str(tmp_path / "w"), "--out", str(tmp_path / "o")]
    monkeypatch.setattr(jparity, "make_parity_scene", scene("jax"))
    monkeypatch.setattr(jpipe, "PipelineConfig", jax_config)
    with pytest.raises(Stop):
        run_jax_parity_with(chip_smoke.PARITY_WIDTH_ITERS, argv, monkeypatch)
    full = run_parity.CONFIGS["full"]
    monkeypatch.setattr(run_parity, "make_parity_scene", scene("port"))
    monkeypatch.setattr(run_parity, "run_vanilla", port_vanilla)
    with chip_smoke.swapped_item(run_parity.CONFIGS, "full",
                                 chip_smoke.parity_cut(chip_smoke.PARITY_WIDTH_ITERS)):
        with pytest.raises(Stop):
            run_parity.main(argv, device="cpu")
    assert run_parity.CONFIGS["full"] is full

    assert got["port_scene"].pop("device") == "cpu"
    assert got["port_scene"] == got["jax_scene"]
    assert got["jax_scene"]["n_gt"] == 60_000 and got["jax_scene"]["resolution"] == 256
    cfg, want = got["port_cfg"], got["jax_cfg"]
    for stage in ("vanilla_overrides", "coarse_overrides", "refine_overrides"):
        assert getattr(cfg, stage).pop("render_mode") == "tiled"
    for field, value in want.items():
        assert getattr(cfg, field) == value, field
    v_it, c_it, r_it = chip_smoke.PARITY_WIDTH_ITERS
    assert (cfg.vanilla_iterations, cfg.coarse_overrides["num_iterations"] - v_it,
            cfg.refine_overrides["num_iterations"]) == (v_it, c_it, r_it)
    assert cfg.capacity == 2**17 and cfg.extract_overrides["decimation_target"] == 50_000


@pytest.fixture(scope="module")
def nerf_scene(tmp_path_factory):
    """A toy parity scene, its coverage and its NeRF-synthetic copy."""
    scene, target = make_parity_scene(**SCENE, k_max=512, device="cpu")
    alphas = chip_smoke.scene_alphas(target, scene.cameras, adaptive.RasterCaps(
        tile_cap=16, dup_capacity=8 * SCENE["n_gt"], k_max=512))
    root = str(tmp_path_factory.mktemp("nerf"))
    chip_smoke.write_nerf_synthetic(scene, alphas, root)
    return scene, alphas, root


def test_write_png_rgba_reads_back(tmp_path):
    """An RGBA array written by io/png reads back equal in Pillow and in
    read_png."""
    a = np.random.default_rng(3).integers(0, 256, (7, 5, 4), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, a)
    assert np.array_equal(np.asarray(Image.open(path)), a)
    assert Image.open(path).mode == "RGBA"
    assert np.array_equal(read_png(path), a)


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("factor", [1, 2])
def test_nerf_synthetic_scene_in_both_packages(nerf_scene, white, factor):
    """Both packages read the written scene to the same cameras and images;
    at factor 1 those are the in-memory scene's (cameras within 1e-6,
    images within 1/255 of the view composited over the background); at
    factor 2 the cameras are half size with the same pose and field of
    view."""
    scene, alphas, root = nerf_scene
    port = load_blender_scene(root, white_background=white, resolution_factor=factor,
                              device="cpu")
    jax_scene = jds.load_blender_scene(root, white_background=white, resolution_factor=factor)
    assert len(port.cameras) == len(jax_scene.cameras) == len(scene.cameras)
    for a, b in zip(port.cameras, jax_scene.cameras):
        for k in ("world_view", "full_proj", "cam_center"):
            np.testing.assert_allclose(getattr(a, k).numpy(), np.asarray(getattr(b, k)), atol=1e-6)
        assert (a.height, a.width, a.tan_half_fov_x) == (b.height, b.width, b.tan_half_fov_x)
    for a, b in zip(port.images, jax_scene.images):
        np.testing.assert_array_equal(a, b)
    assert port.extent == pytest.approx(jax_scene.extent, rel=1e-12)
    agree = chip_smoke.scene_agreement(port, scene, range(len(scene.cameras)), alphas, white)
    assert agree["cam_err"] <= chip_smoke.NERF_CAM_ATOL
    if factor == 1:
        assert agree["same_size"] and agree["px_err"] <= chip_smoke.NERF_PX_ATOL, agree
    else:
        h2 = SCENE["resolution"] // 2
        assert all((c.height, c.width) == (h2, h2) for c in port.cameras)
        assert all(abs(c.tan_half_fov_x - s.tan_half_fov_x) <= 1e-6
                   for c, s in zip(port.cameras, scene.cameras))


def test_nerf_synthetic_test_split(nerf_scene):
    """transforms_test.json holds the held-out views, in both packages."""
    scene, alphas, root = nerf_scene
    _, test_idx = scene.split(True)
    port = load_blender_scene(root, split="test", white_background=False, device="cpu")
    jax_scene = jds.load_blender_scene(root, split="test", white_background=False)
    agree = chip_smoke.scene_agreement(port, scene, test_idx, alphas, False)
    assert agree["n"] == len(test_idx) == len(jax_scene.cameras) == 2
    assert agree["cam_err"] <= chip_smoke.NERF_CAM_ATOL
    assert agree["px_err"] <= chip_smoke.NERF_PX_ATOL
    for a, b in zip(port.images, jax_scene.images):
        np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_in_both_packages(tmp_path):
    """A port PLY at point_cloud/iteration_7000/point_cloud.ply loads to
    the same parameters through both packages' load_reference_checkpoint."""
    g = np.random.default_rng(5)
    pts = g.normal(size=(300, 3)).astype(np.float32)
    model = gm.create_from_pcd(pts, g.uniform(0, 1, (300, 3)).astype(np.float32), 512,
                               sh_degree=1, device="cpu")
    d = tmp_path / "gs" / "point_cloud" / "iteration_7000"
    d.mkdir(parents=True)
    gm.save_ply(model, str(d / "point_cloud.ply"))
    port = pipe.load_reference_checkpoint(str(tmp_path / "gs"), device="cpu")
    jm = jpipe.load_reference_checkpoint(str(tmp_path / "gs"))
    assert port.sh_degree == jm.sh_degree == 1
    alive = port.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(jm.alive))
    assert alive.sum() == 300
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(port.params, f).numpy()[alive],
                                      np.asarray(getattr(jm.params, f))[alive], err_msg=f)
        np.testing.assert_array_equal(getattr(port.params, f).numpy()[:300],
                                      getattr(model.params, f).numpy()[:300], err_msg=f)
    with pytest.raises(FileNotFoundError):
        pipe.load_reference_checkpoint(str(tmp_path / "gs"), iteration=30_000, device="cpu")


def test_run_parity_again_trains_nothing(tmp_path, monkeypatch, capsys):
    """run_parity.main twice on one workdir (the toy configuration): the
    second run logs stage_skip for the four stages, runs no trainer and no
    extraction, and writes the first run's scores."""
    monkeypatch.setitem(run_parity.CONFIGS, "small", TOY)
    argv = ["--small", "--workdir", str(tmp_path / "w")]
    first = run_parity.main(argv + ["--out", str(tmp_path / "a.json")], device="cpu")
    capsys.readouterr()

    def refuse(*args, **kwargs):
        raise AssertionError("a second run_parity.main trained or extracted")

    for name in ("train_vanilla_3dgs", "train_coarse", "extract_mesh_from_coarse_model",
                 "refined_training"):
        monkeypatch.setattr(pipe, name, refuse)
    again = run_parity.main(argv + ["--out", str(tmp_path / "b.json")], device="cpu")
    out = capsys.readouterr().out
    skips = [json.loads(line)["stage"] for line in out.splitlines() if '"stage_skip"' in line]
    assert skips == ["vanilla", "coarse", "extract_mesh", "refine"]
    assert again["stages"] == first["stages"]
    with open(tmp_path / "b.json") as f:
        assert json.load(f)["stages"] == first["stages"]
    shutil.rmtree(tmp_path / "w")
