"""The port's scene loading and checkpointing against the JAX package:
COLMAP binary and text models with PNG images, a Blender (NeRF-synthetic)
scene, the cameras.json round trip, the npz checkpoint and milestone
helpers, and vanilla kill-and-resume on the CPU.

Tolerances: camera matrices and centers 1e-6; image pixels, sizes, names,
extents and splits exactly equal; resumed runs bit-exact.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_io import write_colmap_binary
from sugar_tpu.io import colmap as jcolmap
from sugar_tpu.io import datasets as jds
from sugar_tpu_torch.io import colmap, datasets
from sugar_tpu_torch.models.densifier import DensifyStats
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.trainers import vanilla
from sugar_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)


def colmap_model(seed=0):
    g = np.random.default_rng(seed)
    q = g.normal(size=4)
    q /= np.linalg.norm(q)
    cams = [jcolmap.ColmapCamera(1, "PINHOLE", 64, 48, np.array([60.0, 58.0, 31.0, 25.0])),
            jcolmap.ColmapCamera(2, "SIMPLE_PINHOLE", 40, 30, np.array([35.0, 20.0, 15.0]))]
    imgs = [
        jcolmap.ColmapImage(1, q, np.array([0.1, 0.2, 2.0]), 1, "c.png"),
        jcolmap.ColmapImage(2, np.array([1.0, 0, 0, 0]), np.array([0.0, 0.0, 3.0]), 2, "a.png"),
        jcolmap.ColmapImage(3, np.array([0.9, 0.1, -0.2, 0.3]) / np.linalg.norm([0.9, 0.1, -0.2, 0.3]),
                            np.array([-0.3, 0.1, 2.5]), 1, "b.png"),
    ]
    xyz = g.normal(size=(25, 3))
    rgb = g.integers(0, 256, (25, 3)).astype(np.uint8)
    err = g.random(25)
    return cams, imgs, (xyz, rgb, err)


def write_images(root, imgs, cams, seed=1):
    g = np.random.default_rng(seed)
    sizes = {c.camera_id: (c.height, c.width) for c in cams}
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for im in imgs:
        h, w = sizes[im.camera_id]
        Image.fromarray(g.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
            os.path.join(root, "images", im.name))


@pytest.fixture(params=["binary", "text"])
def colmap_scene(request, tmp_path):
    cams, imgs, pts = colmap_model()
    sparse = str(tmp_path / "sparse" / "0")
    if request.param == "binary":
        write_colmap_binary(sparse, cams, imgs, pts)
    else:
        os.makedirs(sparse)
        jcolmap.write_cameras_text(os.path.join(sparse, "cameras.txt"), {c.camera_id: c for c in cams})
        jcolmap.write_images_text(os.path.join(sparse, "images.txt"), {i.image_id: i for i in imgs})
        jcolmap.write_points3d_text(os.path.join(sparse, "points3D.txt"), *pts)
    write_images(str(tmp_path), imgs, cams)
    return str(tmp_path)


def jax_readable(root, tmp_path):
    """The scene as the JAX loader reads it whole: a binary model is itself;
    a text model becomes its binary twin (the same cameras, images and
    points; the images directory linked), since the JAX package's text
    reader drops the image after an empty 2D-point line (ROADMAP.md, queue
    3) where the port's reads every image."""
    if not os.path.exists(os.path.join(root, "sparse", "0", "images.txt")):
        return root
    cams, imgs, pts = colmap_model()
    twin = tmp_path / "binary_twin"
    write_colmap_binary(str(twin / "sparse" / "0"), cams, imgs, pts)
    os.symlink(os.path.join(root, "images"), twin / "images")
    return str(twin)


def assert_same_cameras(t_cams, j_cams):
    assert len(t_cams) == len(j_cams)
    for t, j in zip(t_cams, j_cams):
        assert (t.height, t.width) == (j.height, j.width)
        assert t.tan_half_fov_x == pytest.approx(j.tan_half_fov_x, rel=1e-12)
        assert t.tan_half_fov_y == pytest.approx(j.tan_half_fov_y, rel=1e-12)
        for f in ("world_view", "full_proj", "cam_center"):
            np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                       atol=1e-6, rtol=0, err_msg=f)


def assert_same_scene(t, j):
    assert_same_cameras(t.cameras, j.cameras)
    assert t.image_names == j.image_names
    assert t.extent == j.extent
    assert t.split() == j.split() and t.split(False) == j.split(False)
    assert (t.images is None) == (j.images is None)
    for a, b in zip(t.images or [], j.images or []):
        np.testing.assert_array_equal(a, b)
    for f in ("points", "colors"):
        if getattr(j, f) is None:
            assert getattr(t, f) is None
        else:
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


def test_colmap_readers_match_jax(colmap_scene, tmp_path):
    sparse = os.path.join(colmap_scene, "sparse", "0")
    tc, ti, tp = colmap.read_model(sparse)
    jc, ji, jp = jcolmap.read_model(os.path.join(jax_readable(colmap_scene, tmp_path), "sparse",
                                                 "0"))
    if os.path.exists(os.path.join(sparse, "images.txt")):
        # The JAX text reader loses an image; the port's reads all three.
        assert len(jcolmap.read_images_text(os.path.join(sparse, "images.txt"))) == 2
        assert sorted(ti) == [1, 2, 3]
    assert tc.keys() == jc.keys() and ti.keys() == ji.keys()
    for k in jc:
        assert (tc[k].model, tc[k].width, tc[k].height) == (jc[k].model, jc[k].width, jc[k].height)
        np.testing.assert_array_equal(tc[k].params, jc[k].params)
    for k in ji:
        assert (ti[k].name, ti[k].camera_id) == (ji[k].name, ji[k].camera_id)
        np.testing.assert_array_equal(ti[k].qvec, ji[k].qvec)
        np.testing.assert_array_equal(ti[k].tvec, ji[k].tvec)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)
    q = ji[3].qvec
    np.testing.assert_array_equal(colmap.qvec2rotmat(q), jcolmap.qvec2rotmat(q))


@pytest.mark.parametrize("resolution_factor", [1, 2])
def test_load_colmap_scene_matches_jax(colmap_scene, resolution_factor, tmp_path):
    t = datasets.load_colmap_scene(colmap_scene, resolution_factor=resolution_factor, device="cpu")
    j = jds.load_colmap_scene(jax_readable(colmap_scene, tmp_path),
                              resolution_factor=resolution_factor)
    assert_same_scene(t, j)
    # Text and binary alike: every image, though each text image's 2D-point
    # line is empty (the JAX package loads 2 of the 3 from the text model).
    assert t.image_names == ["a.png", "b.png", "c.png"] and t.split() == ([1, 2], [0])
    assert t.images[-1].shape == (48 // resolution_factor, 64 // resolution_factor, 3)
    assert t.cameras[0].world_view.device.type == "cpu"


def test_colmap_text_writers_match_jax(tmp_path):
    cams, imgs, (xyz, rgb, err) = colmap_model(seed=2)
    for mod, sub in ((colmap, "t"), (jcolmap, "j")):
        d = tmp_path / sub
        d.mkdir()
        mod.write_cameras_text(str(d / "cameras.txt"), {c.camera_id: c for c in cams})
        mod.write_images_text(str(d / "images.txt"), {i.image_id: i for i in imgs})
        mod.write_points3d_text(str(d / "points3D.txt"), xyz, rgb, err)
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


def write_blender_scene(root, n=4, hw=(30, 40), seed=3):
    g = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        th = 2 * np.pi * i / n
        c2w = np.eye(4)
        c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        c2w[:3, 3] = [4 * np.sin(th), 0.5, 4 * np.cos(th)]
        name = f"./train/r_{i}"
        os.makedirs(os.path.join(root, "train"), exist_ok=True)
        rgba = g.integers(0, 256, hw + (4,)).astype(np.uint8)
        Image.fromarray(rgba, "RGBA").save(os.path.join(root, name + ".png"))
        frames.append(dict(file_path=name, transform_matrix=c2w.tolist()))
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump(dict(camera_angle_x=0.69, frames=frames), f)


@pytest.mark.parametrize("white_background", [True, False])
def test_load_blender_scene_matches_jax(tmp_path, white_background):
    write_blender_scene(str(tmp_path))
    t = datasets.load_blender_scene(str(tmp_path), white_background=white_background, device="cpu")
    j = jds.load_blender_scene(str(tmp_path), white_background=white_background)
    assert_same_scene(t, j)
    assert len(t.cameras) == 4 and t.points.shape == (100_000, 3)


def test_cameras_json_round_trip_matches_jax(colmap_scene, tmp_path):
    scene = datasets.load_colmap_scene(colmap_scene, device="cpu")
    names = [n.split(".")[0] for n in scene.image_names]
    out = tmp_path / "gs"
    out.mkdir()
    datasets.save_cameras_json(str(out / "cameras.json"), scene.cameras, names)
    jscene = jds.load_colmap_scene(jax_readable(colmap_scene, tmp_path))
    jout = tmp_path / "jgs"
    jout.mkdir()
    jds.save_cameras_json(str(jout / "cameras.json"), jscene.cameras, names)
    assert json.loads((out / "cameras.json").read_text()) == json.loads(
        (jout / "cameras.json").read_text())
    t = datasets.load_gs_checkpoint_cameras(colmap_scene, str(out), device="cpu")
    j = jds.load_gs_checkpoint_cameras(colmap_scene, str(out))
    assert_same_scene(t, j)
    for a, b in zip(t.cameras, scene.cameras):
        np.testing.assert_allclose(a.world_view.numpy(), b.world_view.numpy(), atol=1e-5)


def test_checkpoint_round_trip_and_milestones(tmp_path):
    g = np.random.default_rng(4)
    params = vanilla.GaussianParams(**{
        f: torch.tensor(g.normal(size=s).astype(np.float32))
        for f, s in zip(PARAM_FIELDS, [(8, 3), (8, 3), (8, 3, 3), (8,), (8, 3), (8, 4)])})
    adam = opt.init_adam(params)
    state = dict(params=params, alive=torch.arange(8) < 5, adam=adam,
                 stats=DensifyStats.zeros(8, device="cpu"),
                 knn_idx=torch.arange(32).reshape(8, 4), iteration=17)
    path = ckpt.save_milestone(str(tmp_path), 17, state)
    assert os.path.exists(path + ".npz") and not os.path.exists(path + ".npz.tmp")
    raw = ckpt.load_checkpoint(path, state)
    assert set(raw) == set(state) and set(raw["adam"]) == {"mu", "nu", "count"}
    with np.load(path + ".npz") as data:
        assert "params/xyz" in data.files and "adam/mu/xyz" in data.files
        assert "iteration" in data.files
    back = ckpt.restore_structured(path, state)
    assert back["iteration"] == 17 and isinstance(back["iteration"], int)
    assert isinstance(back["params"], vanilla.GaussianParams)
    assert isinstance(back["adam"], opt.AdamState) and back["adam"].count.dtype == torch.int32
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(back["params"], f), getattr(params, f))
    assert torch.equal(back["alive"], state["alive"]) and back["knn_idx"].dtype == torch.int64
    ckpt.save_milestone(str(tmp_path), 5, state)
    ckpt.save_milestone(str(tmp_path), 30, state)
    (tmp_path / "milestone_x.npz").write_bytes(b"")
    (tmp_path / "other_99.npz").write_bytes(b"")
    assert ckpt.latest_milestone(str(tmp_path)) == 30
    assert ckpt.latest_milestone(str(tmp_path), before=30) == 17
    assert ckpt.latest_milestone(str(tmp_path), before=5) is None
    assert ckpt.latest_milestone(str(tmp_path / "missing")) is None
    assert ckpt.load_milestone(str(tmp_path), 5, state)["iteration"] == 17
    with pytest.raises(TypeError, match="leaf"):
        ckpt.save_checkpoint(str(tmp_path / "bad"), dict(x=object()))


def tiny_scene(n_cams=5, hw=32, n_pts=64, seed=0):
    """tests/test_checkpoint.py's _tiny_scene with the port's cameras."""
    g = np.random.default_rng(seed)
    d = g.normal(size=(n_pts, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = (0.7 * d).astype(np.float32)
    cols = (0.4 + 0.6 * np.abs(d)).astype(np.float32)
    cams, imgs = [], []
    for i in range(n_cams):
        th = 2 * np.pi * i / n_cams
        fwd = -np.array([np.cos(th), 0.2, np.sin(th)])
        fwd /= np.linalg.norm(fwd)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        rwc = np.stack([right, np.cross(fwd, right), fwd], 0)
        cams.append(datasets.make_camera(R=rwc.T, T=-rwc @ (-fwd * 2.5), fov_x=0.8, fov_y=0.8,
                                         height=hw, width=hw, device="cpu"))
        imgs.append(g.uniform(0, 1, (hw, hw, 3)).astype(np.float32))
    return pts, cols, cams, imgs


def run_vanilla(pts, cols, cams, imgs, iters, ckpt_dir=None, mid=None, log=None):
    cfg = vanilla.TrainConfig(
        iterations=iters, capacity=128, sh_degree=0, sh_warmup_every=1,
        densify_from=4, densify_until=iters, densify_every=5,
        opacity_reset_every=10_000, dup_capacity_mult=16, k_max=256,
        checkpoint_iterations=(mid,) if mid else (),
    )
    return vanilla.train_vanilla_3dgs(cams, imgs, pts, cols, 2.0, cfg, seed=0,
                                      checkpoint_dir=ckpt_dir, log_fn=log, device="cpu")


@pytest.fixture
def one_thread():
    """One intra-op thread: with several, the CPU's index_put_(accumulate)
    (the backward of the gathers) adds in any order, as the card's atomics
    do, and runs are not bit-equal."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_vanilla_kill_and_resume_bit_exact_on_cpu(tmp_path, one_thread):
    """tests/test_checkpoint.py:70-96 for the port."""
    pts, cols, cams, imgs = tiny_scene()
    total, mid = 14, 7
    full = run_vanilla(pts, cols, cams, imgs, total)
    ckpt_dir = str(tmp_path / "van")
    partial = run_vanilla(pts, cols, cams, imgs, mid, ckpt_dir=ckpt_dir, mid=mid)
    assert partial.iteration == mid and ckpt.latest_milestone(ckpt_dir) == mid
    logs = []
    resumed = run_vanilla(pts, cols, cams, imgs, total, ckpt_dir=ckpt_dir, mid=mid, log=logs.append)
    assert {"event": "resume", "iteration": mid} in logs
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(full.model.params, f), getattr(resumed.model.params, f)), f
    assert torch.equal(full.model.alive, resumed.model.alive)
    for f in ("grad_accum", "denom", "max_radii"):
        assert torch.equal(getattr(full.stats, f), getattr(resumed.stats, f)), f
    assert torch.equal(full.adam.count, resumed.adam.count)
    assert any(r.get("n_split", 0) + r.get("n_cloned", 0) > 0 for r in logs)
