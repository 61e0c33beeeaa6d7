"""The port's entry points against the JAX package's scripts on the CPU.

Each test runs the port's ``sugar_tpu_torch.scripts.<name>.main(...,
device="cpu")`` and the JAX package's ``scripts/<name>.py`` (in this
process, through ``runpy`` with its command line in ``sys.argv``) on the
same files, and holds what they write to each other:

- ``render``: every render and GT PNG within one uint8 level;
- ``train_vanilla_gs``: one iteration from the loader's seeded random
  init, the port in the JAX script's CPU mode ("tiled"); every parameter
  of the checkpoints within 1e-5;
- ``full_eval``: the same scenes skipped; PSNR within 1e-3 dB and SSIM
  within 1e-5 of what the JAX script's ``metrics.py`` writes;
- ``convert``: the same colmap commands in the same order (a stand-in
  ``colmap`` on PATH records them) and the same sparse/0 layout; both
  refuse to run without the binary.
"""

import functools
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import sugar_tpu.pipeline as jpipe
from test_torch_pipeline import write_toy_scene
from sugar_tpu_torch.io.png import read_png
from sugar_tpu_torch.models import gaussians as gm
from sugar_tpu_torch.models.render import render_model
from sugar_tpu_torch.pipeline import PipelineConfig, load_scene
from sugar_tpu_torch.scripts import convert, full_eval, render, train_vanilla_gs

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_script(name, argv, monkeypatch):
    """scripts/<name> of the JAX package as ``python scripts/<name> argv``
    would run it, in this process."""
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script prepends the repo
    runpy.run_path(os.path.join(ROOT, "scripts", name), run_name="__main__")


def png_levels(a_path, b_path):
    """The largest difference of two 8-bit PNGs, in levels."""
    return int(np.abs(read_png(a_path).astype(np.int16) - read_png(b_path)).max())


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """tests/test_torch_pipeline.py's toy scene and a checkpoint of its
    sphere."""
    root = str(tmp_path_factory.mktemp("scene"))
    write_toy_scene(root)
    g = np.random.default_rng(0)
    d = g.normal(size=(200, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    m = gm.create_from_pcd((0.7 * d).astype(np.float32),
                           (0.4 + 0.6 * np.abs(d)).astype(np.float32), 256, sh_degree=0,
                           initial_opacity=0.95, device="cpu")
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "point_cloud.ply")
    gm.save_ply(m, ckpt)
    return root, ckpt


def test_render_script_writes_renders_and_gt(toy, tmp_path, monkeypatch):
    root, ckpt = toy
    out, jout = str(tmp_path / "renders"), str(tmp_path / "jax")
    written = render.main(["-s", root, "-c", ckpt, "-o", out], device="cpu")
    assert set(written) == {"train", "test"}
    renders = sorted(os.listdir(os.path.join(out, "train", "renders")))
    gts = sorted(os.listdir(os.path.join(out, "train", "gt")))
    assert renders == gts == [f"{k:05d}.png" for k in range(7)]  # 8 views, every 8th held out
    assert os.listdir(os.path.join(out, "test", "renders")) == ["00000.png"]
    # The first test view is camera 0: its render is the checkpoint's.
    scene = load_scene(PipelineConfig(scene_path=root), device="cpu")
    want = render_model(gm.load_ply(ckpt, device="cpu"), scene.cameras[0])["image"].numpy()
    got = read_png(os.path.join(out, "test", "renders", "00000.png"))
    np.testing.assert_array_equal(got, (np.clip(want, 0, 1) * 255).astype(np.uint8))

    # The JAX script on the same scene and checkpoint writes the same files.
    run_jax_script("render.py", ["-s", root, "-c", ckpt, "-o", jout], monkeypatch)
    for split, n in (("train", 7), ("test", 1)):
        for kind in ("renders", "gt"):
            names = sorted(os.listdir(os.path.join(jout, split, kind)))
            assert names == sorted(os.listdir(os.path.join(out, split, kind)))
            assert len(names) == n
            for name in names:
                assert png_levels(os.path.join(out, split, kind, name),
                                  os.path.join(jout, split, kind, name)) <= 1, (split, kind, name)


def test_train_vanilla_gs_script(toy, tmp_path, monkeypatch):
    root, _ = toy
    # Both scripts take the pipeline's default capacity (2^19 slots); the
    # toy scene's random init holds 100,000 points. The JAX trainer's
    # "auto" mode is "tiled" on a CPU, the port's "pallas": at the default
    # k_max both drop slots of this scene's deepest tiles, each by its own
    # rule, so the port trains in the JAX script's mode here.
    monkeypatch.setattr(train_vanilla_gs, "PipelineConfig", functools.partial(
        train_vanilla_gs.PipelineConfig, capacity=2**17,
        vanilla_overrides=dict(render_mode="tiled")))
    ckpt = train_vanilla_gs.main(["-s", root, "-o", str(tmp_path / "port"), "--iterations", "1"],
                                 device="cpu")
    assert ckpt.endswith(os.path.join("iteration_1", "point_cloud.ply"))
    monkeypatch.setattr(jpipe, "PipelineConfig",
                        functools.partial(jpipe.PipelineConfig, capacity=2**17))
    run_jax_script("train_vanilla_gs.py",
                   ["-s", root, "-o", str(tmp_path / "jax"), "--iterations", "1"], monkeypatch)
    jckpt = os.path.join(tmp_path, "jax", "vanilla_gs", "iteration_1", "point_cloud.ply")
    t, j = gm.load_ply(ckpt, device="cpu"), gm.load_ply(jckpt, device="cpu")
    assert t.capacity == j.capacity and t.sh_degree == j.sh_degree
    assert torch.equal(t.alive, j.alive) and int(t.alive.sum()) == 100_000

    for field in gm.PARAM_FIELDS:
        np.testing.assert_allclose(getattr(t.params, field).numpy(),
                                   getattr(j.params, field).numpy(), atol=1e-5, rtol=0,
                                   err_msg=field)


def test_full_eval_skips_missing_scenes_and_scores_present_ones(toy, tmp_path, monkeypatch,
                                                                capsys):
    root, ckpt = toy
    base = tmp_path / "data"
    base.mkdir()
    assert full_eval.main(["--base_dir", str(base), "--output_dir", str(tmp_path / "o")],
                          device="cpu") == {}
    assert capsys.readouterr().out.count("not found") == 13
    os.symlink(root, base / "truck")
    for out in ("o", "j"):
        coarse = tmp_path / out / "truck" / "coarse"
        coarse.mkdir(parents=True)
        os.symlink(ckpt, coarse / "coarse_15000.ply")
    res = full_eval.main(["--base_dir", str(base), "--output_dir", str(tmp_path / "o"),
                          "--skip_training"], device="cpu")
    port_out = capsys.readouterr().out
    assert list(res) == ["truck"] and res["truck"]["gaussians"]["psnr"] > 20.0

    # The JAX script scores the same checkpoint through its metrics.py.
    run_jax_script("full_eval.py", ["--base_dir", str(base), "--output_dir", str(tmp_path / "j"),
                                    "--skip_training"], monkeypatch)
    jax_out = capsys.readouterr().out
    skipped = [ln for ln in port_out.splitlines() if ln.startswith("skip ")]
    assert len(skipped) == 12 and skipped == [ln for ln in jax_out.splitlines()
                                              if ln.startswith("skip ")]
    with open(tmp_path / "o" / "metrics.json") as f:
        got = json.load(f)
    with open(tmp_path / "j" / "metrics.json") as f:
        want = json.load(f)
    assert list(got) == list(want) == ["truck"]
    g, w = got["truck"]["gaussians"], want["truck"]["gaussians"]
    assert g["n_images"] == w["n_images"] == 1
    assert abs(g["psnr"] - w["psnr"]) <= 1e-3 and abs(g["ssim"] - w["ssim"]) <= 1e-5


def test_convert_needs_colmap(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(SystemExit, match="colmap binary not found"):
        convert.main(["-s", str(tmp_path)])
    with pytest.raises(SystemExit) as exc:  # the JAX script prints and exits 1
        run_jax_script("convert.py", ["-s", str(tmp_path)], monkeypatch)
    assert exc.value.code == 1


FAKE_COLMAP = """#!{python}
import json, os, sys
with open(os.environ["COLMAP_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
if sys.argv[1] == "image_undistorter":
    out = sys.argv[sys.argv.index("--output_path") + 1]
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        open(os.path.join(out, "sparse", name), "w").close()
"""


@pytest.mark.parametrize("skip_matching", [False, True])
def test_convert_runs_colmap_as_the_jax_script(tmp_path, monkeypatch, skip_matching):
    """A stand-in colmap on PATH records its command lines: both scripts
    run the same commands in the same order and leave the same layout."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "colmap").write_text(FAKE_COLMAP.format(python=sys.executable))
    (bin_dir / "colmap").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    extra = ["--skip_matching"] if skip_matching else []
    logs = {}
    for who in ("port", "jax"):
        src = tmp_path / who
        (src / "input").mkdir(parents=True)
        monkeypatch.setenv("COLMAP_LOG", str(tmp_path / f"{who}.log"))
        if who == "port":
            assert convert.main(["-s", str(src), "--no_gpu", *extra]) == str(src)
        else:
            run_jax_script("convert.py", ["-s", str(src), "--no_gpu", *extra], monkeypatch)
        with open(tmp_path / f"{who}.log") as f:
            logs[who] = [json.loads(ln.replace(str(src), "<src>")) for ln in f]
        assert sorted(os.listdir(src / "sparse")) == ["0"]
        assert sorted(os.listdir(src / "sparse" / "0")) == ["cameras.bin", "images.bin",
                                                            "points3D.bin"]
    assert logs["port"] == logs["jax"]
    assert [c[0] for c in logs["port"]] == (["image_undistorter"] if skip_matching else [
        "feature_extractor", "exhaustive_matcher", "mapper", "image_undistorter"])
