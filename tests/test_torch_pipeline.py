"""The port's pipeline on a toy NeRF-synthetic scene on disk:
``run_vanilla`` -> ``run_coarse`` -> ``run_extract_mesh`` -> ``run_refine``
-> ``run_texture`` at a few iterations each on the CPU (tests/
test_pipeline.py's flow). Every artifact loads in both packages; the JAX
package's ``_state.pkl`` (written by its own ``run_refine``) feeds the
port's ``run_texture`` and the port's feeds JAX's ``load_refined_state``;
a resumed run skips every stage; ``devices > 1`` raises; the entry points
run on the artifacts.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import sugar_tpu.pipeline as jpipe
from sugar_tpu.io import datasets as jds
from sugar_tpu.io import obj as jobj
from sugar_tpu.io import ply as jply
from sugar_tpu.models import gaussians as jgm
from sugar_tpu.refine import bound as JB
from sugar_tpu.refine import trainer as jtrainer
from sugar_tpu_torch import pipeline as pipe
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.io import obj, ply
from sugar_tpu_torch.io.png import read_png
from sugar_tpu_torch.models import gaussians as gm
from sugar_tpu_torch.models.render import render_model
from sugar_tpu_torch.refine.trainer import load_refined_state
from sugar_tpu_torch.scripts import extract_refined_mesh_with_texture as texture_script
from sugar_tpu_torch.scripts import metrics as metrics_script

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ["vanilla", "coarse", "extract_mesh", "refine", "texture"]


def write_toy_scene(root):
    """tests/test_pipeline.py's scene: 8 views at 48x48 of a 200-Gaussian
    sphere, rendered by the port, as transforms_train.json + PNGs."""
    g = np.random.default_rng(0)
    d = g.normal(size=(200, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    target = gm.create_from_pcd((0.7 * d).astype(np.float32),
                                (0.4 + 0.6 * np.abs(d)).astype(np.float32), 256, sh_degree=0,
                                initial_opacity=0.95, device="cpu")
    os.makedirs(os.path.join(root, "train"))
    frames = []
    for i in range(8):
        th = 2 * np.pi * i / 8
        fwd = -np.array([np.cos(th), 0.3 * np.sin(2 * th), np.sin(th)])
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        Rwc = np.stack([right, np.cross(fwd, right), fwd], 0)
        T = -Rwc @ (-fwd * 2.5)
        cam = make_camera(Rwc.T, T, 0.8, 0.8, 48, 48, device="cpu")
        img = torch.clamp(render_model(target, cam, dup_capacity=8192, k_max=256)["image"], 0, 1)
        Image.fromarray((img.numpy() * 255).astype(np.uint8)).save(
            os.path.join(root, "train", f"r_{i}.png"))
        c2w = np.linalg.inv(cam.world_view.numpy().astype(np.float64))
        c2w[:3, 1:3] *= -1  # back to Blender axes
        frames.append(dict(file_path=f"train/r_{i}", transform_matrix=c2w.tolist()))
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump(dict(camera_angle_x=0.8, frames=frames), f)


def toy_config(scene_path, out, **kw):
    """tests/test_pipeline.py's overrides at fewer iterations."""
    return pipe.PipelineConfig(
        scene_path=scene_path, output_dir=out, poly="low_poly", refinement_time="short",
        eval_split=False, white_background=True, capacity=512, vanilla_iterations=60,
        vanilla_overrides=dict(sh_degree=0, sh_warmup_every=1, densify_from=10_000,
                               densify_until=10_000, opacity_reset_every=10_000,
                               dup_capacity_mult=32, k_max=256, log_every=30),
        coarse_overrides=dict(start_iteration=0, num_iterations=16, entropy_start=2,
                              entropy_end=8, start_sdf_estimation_from=8, regularize_from=4,
                              prune_at=(), sh_degree=0, reset_neighbors_every=4,
                              n_samples_for_sdf_regularization=5_000, k_max=256,
                              dup_capacity_mult=32, log_every=8),
        extract_overrides=dict(total_points=30_000, poisson_resolution=48,
                               decimation_target=1_000, dup_capacity=2**14, k_max=256,
                               prune_opacity_threshold=0.1),
        refine_overrides=dict(num_iterations=3, sh_degree=0, sh_warmup_every=1, k_max=256,
                              dup_capacity_mult=16, log_every=1),
        **kw,
    )


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The five stages once; returns (scene path, config, scene, artifacts,
    logs)."""
    root = str(tmp_path_factory.mktemp("scene"))
    write_toy_scene(root)
    cfg = toy_config(root, str(tmp_path_factory.mktemp("out")))
    scene = pipe.load_scene(cfg, device="cpu")
    # Points near the sphere, as tests/test_pipeline.py, so the toy stages
    # converge quickly.
    g = np.random.default_rng(1)
    d = g.normal(size=(200, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    scene.points = (0.7 * d + 0.05 * g.normal(size=(200, 3))).astype(np.float32)
    scene.colors = np.full((200, 3), 0.5, np.float32)
    logs = []
    art = {}
    art["vanilla"] = pipe.run_vanilla(cfg, scene, log_fn=logs.append)
    art["coarse"] = pipe.run_coarse(cfg, scene, art["vanilla"], log_fn=logs.append)
    art["mesh"] = pipe.run_extract_mesh(cfg, scene, art["coarse"], log_fn=logs.append)
    art["refined"] = pipe.run_refine(cfg, scene, art["mesh"], log_fn=logs.append)
    art["textured"] = pipe.run_texture(cfg, scene, art["refined"], log_fn=logs.append)
    return root, cfg, scene, art, logs


def test_stages_write_the_jax_artifact_paths(run):
    root, cfg, scene, art, logs = run
    out = cfg.output_dir
    assert art == dict(
        vanilla=os.path.join(out, "vanilla_gs", "iteration_60", "point_cloud.ply"),
        coarse=os.path.join(out, "coarse", "coarse_15000.ply"),
        mesh=os.path.join(out, "coarse_mesh", "mesh_level0.3_decim200000.ply"),
        refined=os.path.join(out, "refined", "refined_6gpt_2000.ply"),
        textured=os.path.join(out, "refined_mesh", "textured.obj"))
    for p in list(art.values()) + [os.path.join(out, "vanilla_gs", "cameras.json"),
                                   art["refined"].replace(".ply", "_state.pkl"),
                                   art["textured"][:-4] + ".png", art["textured"][:-4] + ".mtl"]:
        assert os.path.exists(p), p
    assert len(scene.cameras) == 8 and scene.cameras[0].world_view.device.type == "cpu"
    events = [json.loads(r) for r in logs]
    assert any("loss" in e for e in events)


def test_every_artifact_loads_in_both_packages(run):
    _, cfg, _, art, _ = run
    for stage in ("vanilla", "coarse", "refined"):
        t, j = gm.load_ply(art[stage], device="cpu"), jgm.load_ply(art[stage])
        np.testing.assert_array_equal(t.params.xyz.numpy(), np.asarray(j.params.xyz))
        assert t.sh_degree == j.sh_degree and int(t.alive.sum()) > 0
    tv, tf, tc = ply.load_mesh_ply(art["mesh"])
    jv, jf, jc = jply.load_mesh_ply(art["mesh"])
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert len(tv) > 100 and len(tf) > 100 and tc is not None
    refined = jply.load_gaussian_ply(art["refined"])
    assert refined["xyz"].shape[0] == 6 * len(tf)  # low_poly: 6 Gaussians per triangle
    for a, b in zip(obj.load_obj(art["textured"]), jobj.load_obj(art["textured"])):
        np.testing.assert_array_equal(a, b)
    png = art["textured"][:-4] + ".png"
    np.testing.assert_array_equal(read_png(png), np.asarray(Image.open(png)))


def test_port_state_feeds_jax_load_refined_state(run):
    _, _, _, art, _ = run
    state = art["refined"].replace(".ply", "_state.pkl")
    with open(state, "rb") as f:
        st = pickle.load(f)
    assert sorted(st) == sorted(["vertices", "faces", "log_scales", "complex_rot",
                                 "opacity_logit", "sh_dc", "sh_rest", "n_per_triangle",
                                 "thickness"])
    assert all(isinstance(st[k], np.ndarray) for k in JB.BoundParams.__dataclass_fields__)
    assert st["faces"].dtype == np.int32 and isinstance(st["n_per_triangle"], int)
    jp, jbm = jtrainer.load_refined_state(state)
    tp, tbm = load_refined_state(state, device="cpu")
    for f in JB.BoundParams.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(tbm.faces.numpy(), np.asarray(jbm.faces))
    assert tbm.n_per_triangle == jbm.n_per_triangle == 6
    assert float(tbm.thickness) == float(jbm.thickness)


def test_jax_state_feeds_port_run_texture(run, tmp_path):
    """The JAX package's run_refine writes the pickle (its refined_training
    stood in by the binding itself, to skip the JAX training's compile);
    the port's run_texture bakes from it."""
    root, cfg, scene, art, _ = run
    jcfg = jpipe.PipelineConfig(**{**cfg.__dict__, "output_dir": str(tmp_path)})

    def binding(verts, faces, vc, cams, imgs, extent, cfg, **kw):
        return JB.init_bound_params(verts, faces, vc, cfg.n_gaussians_per_triangle, extent=extent,
                                    sh_degree=cfg.sh_degree)

    jscene = jds.SceneData(cameras=[None] * len(scene.cameras), images=[None] * len(scene.cameras),
                           image_names=scene.image_names, points=None, colors=None,
                           extent=scene.extent)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "refined_training", binding)
        j_refined = jpipe.run_refine(jcfg, jscene, art["mesh"], log_fn=lambda *_: None)
    textured = pipe.run_texture(pipe.PipelineConfig(**jcfg.__dict__), scene, j_refined,
                                log_fn=lambda *_: None)
    v, f, uvs, fuv = obj.load_obj(textured)
    mv, mf, _ = ply.load_mesh_ply(art["mesh"])
    np.testing.assert_allclose(v, mv, atol=1e-6)
    np.testing.assert_array_equal(f, mf)
    assert len(uvs) == 3 * len(mf) and read_png(textured[:-4] + ".png").shape[2] == 3


def test_resumed_run_skips_every_stage(run):
    _, cfg, scene, art, _ = run
    logs = []
    a = pipe.run_vanilla(cfg, scene, log_fn=logs.append)
    a = pipe.run_coarse(cfg, scene, a, log_fn=logs.append)
    a = pipe.run_extract_mesh(cfg, scene, a, log_fn=logs.append)
    a = pipe.run_refine(cfg, scene, a, log_fn=logs.append)
    a = pipe.run_texture(cfg, scene, a, log_fn=logs.append)
    events = [json.loads(r) for r in logs]
    assert [e["stage"] for e in events] == STAGES
    assert all(e["event"] == "stage_skip" for e in events)
    assert [e["artifact"] for e in events] == [art[k] for k in
                                               ("vanilla", "coarse", "mesh", "refined", "textured")]


@pytest.mark.parametrize("sharding", [{"devices": 3, "mesh_gauss": 2},
                                      {"devices": 2, "mesh_gauss": 4}])
def test_more_than_one_device_raises(run, sharding):
    """A mesh whose gauss axis does not divide the devices raises, before
    any stage runs or is skipped, in every stage that runs sharded (the
    texture stage runs on one device in both packages). The sharded
    stages themselves run in tests/test_torch_parallel_train.py's
    multichip pipeline test."""
    _, cfg, scene, art, _ = run
    many = pipe.PipelineConfig(**{**cfg.__dict__, **sharding})
    with pytest.raises(ValueError, match="does not divide"):
        pipe.run_full_pipeline(many, device="cpu")
    for fn, arg in ((pipe.run_vanilla, None), (pipe.run_coarse, art["vanilla"]),
                    (pipe.run_extract_mesh, art["coarse"]), (pipe.run_refine, art["mesh"])):
        with pytest.raises(ValueError, match="does not divide"):
            fn(many, scene, *(() if arg is None else (arg,)), log_fn=lambda *_: None)


def test_presets_match_jax():
    for poly in ("low_poly", "high_poly"):
        for rt in ("short", "medium", "long"):
            t = pipe.PipelineConfig(scene_path="s", poly=poly, refinement_time=rt)
            j = jpipe.PipelineConfig(scene_path="s", poly=poly, refinement_time=rt)
            assert (t.n_vertices_in_mesh, t.gaussians_per_triangle, t.refinement_iterations) == (
                j.n_vertices_in_mesh, j.gaussians_per_triangle, j.refinement_iterations)
    assert [f for f in pipe.PipelineConfig.__dataclass_fields__] == [
        f for f in jpipe.PipelineConfig.__dataclass_fields__]


def test_load_reference_checkpoint(run, tmp_path):
    _, _, _, art, _ = run
    d = tmp_path / "point_cloud" / "iteration_7000"
    d.mkdir(parents=True)
    with open(art["vanilla"], "rb") as a, open(d / "point_cloud.ply", "wb") as b:
        b.write(a.read())
    m = pipe.load_reference_checkpoint(str(tmp_path), device="cpu")
    assert int(m.alive.sum()) == int(gm.load_ply(art["vanilla"], device="cpu").alive.sum())
    with pytest.raises(FileNotFoundError):
        pipe.load_reference_checkpoint(str(tmp_path), iteration=30_000, device="cpu")


def test_entry_points_on_the_artifacts(run, tmp_path):
    """metrics over the three evaluated objects, the texture entry point on
    the port's state, and the viewer launcher as ``python -m``."""
    root, _, _, art, _ = run
    out = str(tmp_path / "metrics" / "results.json")
    res = metrics_script.main(["--scene_path", root, "--checkpoint", art["vanilla"],
                               "--refined_state", art["refined"].replace(".ply", "_state.pkl"),
                               "--textured_obj", art["textured"], "--output", out,
                               "--white_background"], device="cpu")
    assert sorted(res) == ["gaussians", "refined", "textured"]
    with open(out) as f:
        saved = json.load(f)
    assert list(saved) == [os.path.basename(root)]
    assert all(res[k]["n_images"] == 1 and np.isfinite(res[k]["psnr"]) for k in res)
    tex_obj = str(tmp_path / "tex" / "m.obj")
    os.makedirs(os.path.dirname(tex_obj))
    texture_script.main(["-s", root, "-m", art["refined"].replace(".ply", "_state.pkl"),
                         "-o", tex_obj, "--square_size", "12"], device="cpu")
    assert os.path.exists(tex_obj[:-4] + ".png")
    r = subprocess.run(
        [sys.executable, "-m", "sugar_tpu_torch.scripts.run_viewer", "-p", art["refined"], "-m",
         art["textured"], "--viewer_dir", str(tmp_path / "viewer")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(tmp_path / "viewer" / "src" / "scene_to_load.json") as f:
        desc = json.load(f)
    assert desc["png"] == os.path.abspath(art["textured"][:-4] + ".png")
