"""The port's compositor and its remaining entry points on the CPU.

``models/compositor.composite_render`` against sugar_tpu's (two sets, a
rigid transform, a mask; image atol 1e-5, n_contrib equal);
``scripts.demo_hybrid.run_demo`` on a refined state in the pickle format
the JAX pipeline writes, beside the JAX script's frames (within 1/255);
``compose_animation`` end to end (tests/test_aux.py:288) beside the JAX
script's frames on the same PLYs (within 1/255). The other entry points
are held to the JAX scripts in tests/test_torch_scripts.py and
tests/test_torch_run_parity.py.
"""

import json
import os
import pickle
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.models import compositor as jcompositor
from sugar_tpu.refine import bound as JB
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.io.png import read_png
from sugar_tpu_torch.models import gaussians as gm
from sugar_tpu_torch.models.compositor import GaussianSet, composite_render
from sugar_tpu_torch.scripts import compose_animation, demo_hybrid

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = dict(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.2, height=32, width=32)


def set_arrays(seed, shift_x, color, n=30):
    g = np.random.default_rng(seed)
    centers = (g.normal(size=(n, 3)) * 0.2).astype(np.float32)
    centers[:, 0] += shift_x
    centers[:, 2] += 3.0
    q = g.normal(size=(n, 4)).astype(np.float32)
    return dict(
        centers=centers,
        scales=np.exp(g.uniform(np.log(0.03), np.log(0.15), (n, 3))).astype(np.float32),
        quaternions=q / np.linalg.norm(q, axis=-1, keepdims=True),
        opacities=g.uniform(0.5, 0.95, n).astype(np.float32),
        colors=np.tile(np.asarray([color], np.float32), (n, 1)),
    )


def both_sets():
    """(JAX sets, port sets): a red set on the left, moved by a rotation
    about y and a translation; a blue set on the right with half its
    Gaussians masked out."""
    th = 0.4
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                 np.float32)
    t = np.array([0.1, 0.05, 0.2], np.float32)
    mask = np.arange(30) % 2 == 0
    a, b = set_arrays(0, -0.7, [1.0, 0, 0]), set_arrays(1, 0.7, [0.0, 0, 1.0])
    jsets = [jcompositor.GaussianSet(**{k: jnp.asarray(v) for k, v in a.items()},
                                     transform_R=jnp.asarray(R), transform_t=jnp.asarray(t)),
             jcompositor.GaussianSet(**{k: jnp.asarray(v) for k, v in b.items()},
                                     mask=jnp.asarray(mask))]
    tsets = [GaussianSet(**{k: torch.tensor(v) for k, v in a.items()},
                         transform_R=torch.tensor(R), transform_t=torch.tensor(t)),
             GaussianSet(**{k: torch.tensor(v) for k, v in b.items()}, mask=torch.tensor(mask))]
    return jsets, tsets


def test_composite_render_matches_jax():
    jsets, tsets = both_sets()
    j = jcompositor.composite_render(jsets, jmake_camera(**CAM), k_max=128)
    t = composite_render(tsets, make_camera(**CAM, device="cpu"), k_max=128)
    np.testing.assert_allclose(t["image"].numpy(), np.asarray(j["image"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t["final_T"].numpy(), np.asarray(j["final_T"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t["n_contrib"].numpy(), np.asarray(j["n_contrib"]))
    np.testing.assert_array_equal(t["radii"].numpy(), np.asarray(j["radii"]))
    assert int(t["bin_overflow"]) == 0 and int(t["tile_overflow"]) == 0
    # Left half red-dominant, right half blue-dominant (tests/test_aux.py).
    img = t["image"].numpy()
    assert img[:, :16, 0].sum() > img[:, :16, 2].sum()
    assert img[:, 16:, 2].sum() > img[:, 16:, 0].sum()
    # Masked Gaussians are culled: radius 0.
    assert int((t["radii"][30:][~tsets[1].mask] != 0).sum()) == 0


def test_composite_render_transform_moves_the_set():
    """tests/test_aux.py's test_transform_applied."""
    s = GaussianSet(centers=torch.tensor([[0.0, 0, 3.0]]), scales=torch.full((1, 3), 0.15),
                    quaternions=torch.tensor([[1.0, 0, 0, 0]]), opacities=torch.tensor([0.95]),
                    colors=torch.tensor([[1.0, 1, 1]]), transform_R=torch.eye(3),
                    transform_t=torch.tensor([0.8, 0.0, 0.0]))
    img = composite_render([s], make_camera(**CAM, device="cpu"), k_max=32)["image"].numpy()
    assert img[:, 16:].sum() > img[:, :16].sum()


def uv_sphere(n_lat=8, n_lon=12, r=0.6):
    """A closed UV-sphere mesh: (vertices (V, 3) float32, faces (F, 3))."""
    lat = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.sin(lat)[:, None] * np.cos(lon), np.cos(lat)[:, None].repeat(n_lon, 1),
                     np.sin(lat)[:, None] * np.sin(lon)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]]) * r
    faces = []
    for j in range(n_lon):
        k = (j + 1) % n_lon
        faces.append([0, 1 + k, 1 + j])
        last = 1 + (n_lat - 2) * n_lon
        faces.append([len(verts) - 1, last + j, last + k])
    for i in range(n_lat - 2):
        for j in range(n_lon):
            k = (j + 1) % n_lon
            a, b = 1 + i * n_lon + j, 1 + i * n_lon + k
            faces.append([a, b, b + n_lon])
            faces.append([a, b + n_lon, a + n_lon])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def write_refined_state(path):
    """A refined state in the pickle format of sugar_tpu/pipeline.py:295-312
    (JAX init_bound_params of a sphere, opacities and colours drawn)."""
    verts, faces = uv_sphere()
    p, bm = JB.init_bound_params(verts, faces, None, 3, extent=2.0, sh_degree=1)
    d = {f: np.array(getattr(p, f)) for f in JB.BoundParams.__dataclass_fields__}
    g = np.random.default_rng(3)
    d["opacity_logit"] = g.normal(1.0, 1.0, d["opacity_logit"].shape).astype(np.float32)
    d["sh_dc"] = g.normal(0, 1, d["sh_dc"].shape).astype(np.float32)
    with open(path, "wb") as f:
        pickle.dump(dict(d, faces=np.asarray(bm.faces), n_per_triangle=bm.n_per_triangle,
                         thickness=float(bm.thickness)), f)


def test_run_demo_matches_the_jax_script(tmp_path):
    """tests/test_pipeline.py:148-157's call (2 frames, 64x64, k_max 256) in
    both packages on one refined state: the same files, every frame within
    one uint8 level of the JAX script's."""
    ply = str(tmp_path / "refined.ply")
    write_refined_state(ply.replace(".ply", "_state.pkl"))
    kw = dict(n_frames=2, resolution=64, k_max=256)
    t_written = demo_hybrid.run_demo(ply, str(tmp_path / "port"), device="cpu", **kw)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import demo_hybrid as jdemo
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    j_written = jdemo.run_demo(ply, str(tmp_path / "jax"), **kw)
    assert {k: len(v) for k, v in t_written.items()} == {"hybrid": 2, "composite": 2}
    for kind in ("hybrid", "composite"):
        for tp, jp in zip(t_written[kind], j_written[kind]):
            assert os.path.basename(tp) == os.path.basename(jp)
            a, b = read_png(tp).astype(np.int16), read_png(jp).astype(np.int16)
            assert a.shape == (64, 64, 3) and int(np.abs(a - b).max()) <= 1, tp
            assert a.max() > 50  # the sphere is in frame


def write_plys(tmp_path):
    g = np.random.default_rng(0)
    pts = (0.3 * g.normal(size=(20, 3))).astype(np.float32) + [0, 0, 3]
    m = gm.create_from_pcd(pts, np.full((20, 3), 0.7, np.float32), capacity=20, sh_degree=0,
                           initial_opacity=0.9, device="cpu")
    paths = [str(tmp_path / "a.ply"), str(tmp_path / "b.ply")]
    for p in paths:
        gm.save_ply(m, p)
    return paths


def test_compose_animation_end_to_end(tmp_path, monkeypatch):
    """tests/test_aux.py:288: two PLYs, a Blender trajectory and per-frame
    rigid transforms -> one PNG per frame; the second component moves. The
    JAX script on the same files writes the same frames (1 level)."""
    ply1, ply2 = write_plys(tmp_path)
    c2w = np.eye(4)
    c2w[:3, 1:3] *= -1  # Blender axes (the loader flips back)
    traj = [dict(matrix_world=c2w.reshape(-1).tolist(), lens=35.0) for _ in range(2)]
    anim = [[dict(R=np.eye(3).tolist(), t=[0, 0, 0]), dict(R=np.eye(3).tolist(), t=[x, 0, 0])]
            for x in (0.0, 0.5)]
    (tmp_path / "traj.json").write_text(json.dumps(traj))
    (tmp_path / "anim.json").write_text(json.dumps(anim))
    argv = ["--ply", ply1, "--ply", ply2, "--trajectory", str(tmp_path / "traj.json"),
            "--animation", str(tmp_path / "anim.json"), "--height", "32", "--width", "32",
            "--k_max", "64", "-o"]
    paths = compose_animation.main(argv + [str(tmp_path / "frames")], device="cpu")
    assert [os.path.basename(p) for p in paths] == ["frame_00000.png", "frame_00001.png"]
    f0, f1 = (read_png(p) for p in paths)
    assert f0.shape == (32, 32, 3) and f0.max() > 50
    assert int(np.abs(f0.astype(np.int16) - f1).max()) > 50  # the copy moved
    with pytest.raises(SystemExit, match="transforms"):
        compose_animation.main(["--ply", ply1, "--trajectory", str(tmp_path / "traj.json"),
                                "--animation", str(tmp_path / "anim.json"), "-o",
                                str(tmp_path / "frames")], device="cpu")

    monkeypatch.setattr(sys, "argv", ["compose_animation.py"] + argv + [str(tmp_path / "jax")])
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script prepends the repo
    runpy.run_path(os.path.join(ROOT, "scripts", "compose_animation.py"), run_name="__main__")
    assert sorted(os.listdir(tmp_path / "jax")) == [os.path.basename(p) for p in paths]
    for p in paths:
        want = read_png(str(tmp_path / "jax" / os.path.basename(p))).astype(np.int16)
        assert int(np.abs(read_png(p) - want).max()) <= 1, p
