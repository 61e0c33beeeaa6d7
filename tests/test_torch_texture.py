"""The port's texture bake against the JAX package: the triangle rasterizer
(``refine/mesh_raster.py``) on tests/test_texture.py's quads and occlusion
case and on a random mesh whose tiles are deeper than ``k_max``; the UV
atlas; ``bake_texture`` with one injected render; ``render_textured_mesh``;
``postprocess_mesh``; ``extract_textured_mesh`` from one ``_state.pkl``
through both packages; and the OBJ + MTL + PNG both ways.

Tolerances: face ids, overflow and tile order exactly equal; depth and
barycentrics 1e-5 (the JAX function is plain XLA, the port plain torch,
the projection a float32 matmul in each); the atlas bit-equal; the .obj
and .mtl text byte-equal and the PNG decode-equal for the same arrays.
Texels: ``(uv * tex_size).astype(int64)`` flips a texel when a
barycentric moves by an ulp, so a texel may differ only where a pixel's
UV lies within 1e-5 x tex_size of a texel edge; elsewhere 1e-6.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.io import obj as jobj
from sugar_tpu.raster.binning import bucketize_by_offsets as jbucketize
from sugar_tpu.refine import bound as JB
from sugar_tpu.refine import extract_textured as jext
from sugar_tpu.refine import mesh_raster as jmr
from sugar_tpu.refine import texture as jtex
from sugar_tpu.refine import trainer as jtrainer
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.io import obj
from sugar_tpu_torch.io.png import read_png
from sugar_tpu_torch.raster.binning import bucketize_by_offsets
from sugar_tpu_torch.refine import extract_textured as ext
from sugar_tpu_torch.refine import mesh_raster as mr
from sugar_tpu_torch.refine import texture as tex
from sugar_tpu_torch.refine.trainer import load_refined_state

torch.set_num_threads(1)

TEXEL_EDGE = 1e-5  # share of tex_size within which a texel may flip


def facing_quad(z=2.0, half=0.8):
    """tests/test_texture.py's quad."""
    verts = np.array(
        [[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]], np.float32)
    return verts, np.array([[0, 1, 2], [0, 2, 3]], np.int64)


def random_mesh(seed=1):
    """Two facing quads (z 2 and 4; faces 0-3, first in every tile) and 500
    random triangles between them: occlusion, and tiles holding far more
    faces than k_max."""
    g = np.random.default_rng(seed)
    rv = g.uniform(-1, 1, (300, 3)).astype(np.float32)
    rv[:, 2] += 3.0
    qf = np.array([[0, 1, 2], [0, 2, 3]])
    verts = np.concatenate([facing_quad(2.0, 0.5)[0], facing_quad(4.0, 0.5)[0], rv])
    faces = np.concatenate([qf, qf + 4, g.integers(0, 300, (500, 3)) + 8]).astype(np.int64)
    return verts, faces


def occlusion_mesh():
    v1, f1 = facing_quad(z=2.0, half=0.5)
    v2, f2 = facing_quad(z=4.0, half=0.5)
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4])


CAM = dict(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.2)
# name: (mesh, height, width, kwargs of rasterize_mesh)
RASTER_CASES = {
    "quad": (facing_quad(), 64, 64, dict(dup_capacity=1024, k_max=16)),
    "occlusion": (occlusion_mesh(), 32, 32, dict(dup_capacity=1024, k_max=16)),
    "random_deep": (random_mesh(), 40, 56, dict(dup_capacity=4096, k_max=32, tile_chunk=5)),
    "random_overflow": (random_mesh(), 40, 56, dict(dup_capacity=600, k_max=64)),
}

_cache = {}


def raster_pair(name):
    """(JAX outputs, port outputs) as numpy, cached per module."""
    if name not in _cache:
        (verts, faces), h, w, kw = RASTER_CASES[name]
        j = jmr.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces),
                               jmake_camera(height=h, width=w, **CAM), **kw)
        t = mr.rasterize_mesh(torch.as_tensor(verts), torch.as_tensor(faces),
                              make_camera(height=h, width=w, device="cpu", **CAM), **kw)
        _cache[name] = ({k: np.asarray(v) for k, v in j.items()},
                        {k: v.numpy() for k, v in t.items()})
    return _cache[name]


@pytest.mark.parametrize("name", list(RASTER_CASES))
def test_rasterize_mesh_matches_jax(name):
    j, t = raster_pair(name)
    np.testing.assert_array_equal(t["face_idx"], j["face_idx"])
    assert int(t["overflow"]) == int(j["overflow"])
    np.testing.assert_allclose(t["zbuf"], j["zbuf"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(t["bary"], j["bary"], atol=1e-5, rtol=0)
    hit = t["face_idx"] >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(t["bary"][hit].sum(-1), 1.0, atol=1e-4)
    assert (t["zbuf"][~hit] == -1.0).all() and (t["bary"][~hit] == 0.0).all()


def test_rasterize_mesh_cases_cover_what_they_claim():
    _, t = raster_pair("occlusion")
    assert t["face_idx"][16, 16] in (0, 1) and abs(t["zbuf"][16, 16] - 2.0) < 1e-3
    _, t = raster_pair("random_deep")
    assert int(t["tile_count_max"]) > 4 * 32  # tiles far deeper than k_max
    assert t["face_idx"][20, 28] in (0, 1)  # the near quad is first in the tile, and wins
    j, t = raster_pair("random_overflow")
    assert int(t["overflow"]) > 0


def test_tiles_do_not_depend_on_the_chunking():
    (verts, faces), h, w, kw = RASTER_CASES["random_deep"]
    cam = make_camera(height=h, width=w, device="cpu", **CAM)
    a = mr.rasterize_mesh(torch.as_tensor(verts), torch.as_tensor(faces), cam,
                          **dict(kw, tile_chunk=1))
    b = mr.rasterize_mesh(torch.as_tensor(verts), torch.as_tensor(faces), cam,
                          **dict(kw, tile_chunk=64))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_argmin_of_an_all_inf_column_is_zero():
    """Tiles with no face reduce over columns of +inf: both packages pick
    index 0 (and report no hit)."""
    z = np.full((5, 3), np.inf, np.float32)
    z[2, 1] = 1.0
    assert torch.argmin(torch.as_tensor(z), dim=0).tolist() == [0, 2, 0]
    assert np.asarray(jnp.argmin(jnp.asarray(z), axis=0)).tolist() == [0, 2, 0]


def test_bucketize_by_offsets_matches_jax():
    counts = np.random.default_rng(3).integers(0, 4, 50)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    t = bucketize_by_offsets(torch.as_tensor(offsets), 200)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jbucketize(jnp.asarray(offsets), 200)))


@pytest.mark.parametrize("n,square", [(1, 3), (2, 10), (10, 10), (1001, 12), (237_211, 10)])
def test_uv_atlas_bit_equal(n, square):
    uv_j, size_j = jtex.build_uv_atlas(n, square)
    uv_t, size_t = tex.build_uv_atlas(n, square)
    assert size_t == size_j
    np.testing.assert_array_equal(uv_t, uv_j)


# --- the bake -------------------------------------------------------------

BAKE_HW = 40


def bound_state(mesh="random_deep", gpt=1, seed=2):
    """JAX init_bound_params of a mesh with random opacities and SH-DC, as
    numpy fields + faces + thickness."""
    verts, faces = RASTER_CASES[mesh][0]
    p, bm = JB.init_bound_params(verts, faces, None, gpt, extent=2.0, sh_degree=1)
    d = {f: np.array(getattr(p, f)) for f in JB.BoundParams.__dataclass_fields__}
    g = np.random.default_rng(seed)
    d["opacity_logit"] = g.normal(0, 2, d["opacity_logit"].shape).astype(np.float32)
    d["sh_dc"] = g.normal(0, 1, d["sh_dc"].shape).astype(np.float32)
    return d, np.asarray(bm.faces), float(bm.thickness), gpt


def jax_bound(d, faces, th, gpt):
    _, bary = JB.BARY_TABLES[gpt]
    return (JB.BoundParams(**{k: jnp.asarray(v) for k, v in d.items()}),
            JB.BoundMesh(faces=jnp.asarray(faces), bary=jnp.asarray(bary.astype(np.float32)),
                         thickness=jnp.asarray(th, jnp.float32), n_per_triangle=gpt))


def port_bound(d, faces, th, gpt):
    from sugar_tpu_torch.interop import bound_from_numpy

    return bound_from_numpy(d, faces, gpt, th, device="cpu")


def edge_texels(verts_uv, fidx, bary, size):
    """Linear indices of the texels of pixels whose UV lies within
    TEXEL_EDGE x size of a texel edge (either side of the flip)."""
    hit = fidx >= 0
    uv = np.einsum("nkc,nk->nc", verts_uv[fidx[hit]], bary[hit]) * size
    near = (np.abs(uv - np.round(uv)) < TEXEL_EDGE * size).any(-1)
    ij = np.clip(np.floor(uv[near]).astype(np.int64), 0, size - 1)
    out = set()
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            out.update((np.clip(ij[:, 0] + di, 0, size - 1) * size
                        + np.clip(ij[:, 1] + dj, 0, size - 1)).tolist())
    return np.array(sorted(out), np.int64)


def assert_textures_match(t_tex, j_tex, verts_uv, j_raster, size):
    diff = np.abs(t_tex - j_tex).reshape(-1, 3).max(-1)
    excused = np.zeros(size * size, bool)
    excused[edge_texels(verts_uv, j_raster["face_idx"].reshape(-1),
                        j_raster["bary"].reshape(-1, 3), size)] = True
    assert diff[~excused].max() <= 1e-6, diff[~excused].max()


def test_bake_texture_one_injected_render():
    d, faces, th, gpt = bound_state()
    jp, jbm = jax_bound(d, faces, th, gpt)
    tp, tbm = port_bound(d, faces, th, gpt)
    img = np.random.default_rng(5).uniform(0, 1, (BAKE_HW, BAKE_HW, 3)).astype(np.float32)
    kw = dict(height=BAKE_HW, width=BAKE_HW, **CAM)
    j_tex, j_uv, j_size = jtex.bake_texture(jp, jbm, [jmake_camera(**kw)], lambda c: img,
                                            square_size=10, raster_dup_capacity=4096)
    t_tex, t_uv, t_size = tex.bake_texture(tp, tbm, [make_camera(device="cpu", **kw)],
                                           lambda c: torch.as_tensor(img), square_size=10,
                                           raster_dup_capacity=4096)
    assert t_size == j_size
    np.testing.assert_array_equal(t_uv, j_uv)
    j_r = jmr.rasterize_mesh(jnp.asarray(d["vertices"]), jnp.asarray(faces),
                             jmake_camera(**kw), dup_capacity=4096)
    assert_textures_match(t_tex, j_tex, j_uv, {k: np.asarray(v) for k, v in j_r.items()}, j_size)
    base, _, _ = tex.bake_texture(tp, tbm, [], None, square_size=10)  # no camera: base colours
    assert (t_tex != base).any(-1).sum() > 100  # texels that took render colours


def test_render_textured_mesh_matches_jax():
    verts, faces = RASTER_CASES["random_deep"][0]
    uv, size = tex.build_uv_atlas(len(faces), 10)
    texture = np.random.default_rng(6).uniform(0, 1, (size, size, 3)).astype(np.float32)
    kw = dict(height=BAKE_HW, width=BAKE_HW + 8, **CAM)
    j = jtex.render_textured_mesh(verts, faces, uv, texture, jmake_camera(**kw), bg=[0.1, 0.2, 0.3],
                                  dup_capacity=4096, k_max=64)
    t = tex.render_textured_mesh(verts, faces, uv, texture, make_camera(device="cpu", **kw),
                                 bg=[0.1, 0.2, 0.3], dup_capacity=4096, k_max=64)
    j_r = jmr.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces), jmake_camera(**kw),
                             dup_capacity=4096, k_max=64)
    fidx, bary = np.asarray(j_r["face_idx"]).reshape(-1), np.asarray(j_r["bary"]).reshape(-1, 3)
    hit = fidx >= 0
    uvp = np.einsum("nkc,nk->nc", uv[fidx[hit]], bary[hit]) * size
    near = np.zeros(fidx.shape, bool)
    near[hit] = (np.abs(uvp - np.round(uvp)) < TEXEL_EDGE * size).any(-1)
    diff = np.abs(t - j).reshape(-1, 3).max(-1)
    assert diff[~near].max() == 0.0
    assert (t.reshape(-1, 3)[~hit] == np.float32([0.1, 0.2, 0.3])).all()


def test_postprocess_mesh_masks_equal():
    """A 6x6 grid with low opacity on some border faces: the peeled faces
    and the kept Gaussians equal the JAX package's."""
    n = 7
    xs = np.linspace(-1, 1, n)
    verts = np.array([[x, y, 3.0] for x in xs for y in xs], np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    faces = np.array(faces, np.int64)
    gpt = 3
    p, bm = JB.init_bound_params(verts, faces, None, gpt, extent=2.0, sh_degree=0)
    d = {f: np.array(getattr(p, f)) for f in JB.BoundParams.__dataclass_fields__}
    d["opacity_logit"] = np.random.default_rng(1).normal(-1.5, 1.5, d["opacity_logit"].shape
                                                         ).astype(np.float32)
    th = float(bm.thickness)
    cfg_j = jext.TextureConfig(postprocess_mesh=True, postprocess_density_threshold=0.3)
    cfg_t = ext.TextureConfig(postprocess_mesh=True, postprocess_density_threshold=0.3)
    jp, jbm = jext.postprocess_mesh(*jax_bound(d, np.asarray(bm.faces), th, gpt), cfg_j)
    tp, tbm = ext.postprocess_mesh(*port_bound(d, np.asarray(bm.faces), th, gpt), cfg_t)
    assert 0 < len(tbm.faces) < len(faces)
    np.testing.assert_array_equal(tbm.faces.numpy(), np.asarray(jbm.faces))
    for f in d:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)


def write_state(path, d, faces, th, gpt):
    """The pickle sugar_tpu/pipeline.py:295-312 writes."""
    with open(path, "wb") as f:
        pickle.dump(dict(d, faces=faces.astype(np.int32), n_per_triangle=gpt, thickness=th), f)


def test_extract_textured_mesh_through_both_packages(tmp_path):
    """One _state.pkl, both packages' load_refined_state +
    extract_textured_mesh: the .obj and .mtl byte-equal, the textures equal
    up to texel flips at edges and one uint8 level (the renders agree to
    ~1e-6, the PNG truncates value x 255)."""
    d, faces, th, gpt = bound_state(mesh="random_deep", gpt=1)
    d["sh_rest"] = np.random.default_rng(4).normal(0, 0.1, d["sh_rest"].shape).astype(np.float32)
    state = str(tmp_path / "refined_state.pkl")
    write_state(state, d, faces, th, gpt)
    kw = dict(height=32, width=32, fov_x=1.2, fov_y=1.2)
    poses = [(np.eye(3), np.zeros(3)), (np.eye(3), np.array([0.2, -0.1, 0.3]))]
    jp, jbm = jtrainer.load_refined_state(state)
    tp, tbm = load_refined_state(state, device="cpu")
    jo, to = str(tmp_path / "jax" / "m.obj"), str(tmp_path / "port" / "m.obj")
    os.makedirs(os.path.dirname(jo))
    os.makedirs(os.path.dirname(to))
    jext.extract_textured_mesh(jp, jbm, [jmake_camera(R=R, T=T, **kw) for R, T in poses], jo,
                               sh_degree=1, dup_capacity=8192, k_max=1024)
    ext.extract_textured_mesh(tp, tbm, [make_camera(R=R, T=T, device="cpu", **kw) for R, T in poses],
                              to, sh_degree=1, dup_capacity=8192, k_max=1024)
    for suffix in (".obj", ".mtl"):
        with open(jo[:-4] + suffix, "rb") as a, open(to[:-4] + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    j_png = np.asarray(Image.open(jo[:-4] + ".png")).astype(np.int16)
    t_png = read_png(to[:-4] + ".png").astype(np.int16)
    assert t_png.shape == j_png.shape
    size = j_png.shape[0]
    uv, _ = jtex.build_uv_atlas(len(faces), 10)
    excused = np.zeros(size * size, bool)
    for R, T in poses:
        r = jmr.rasterize_mesh(jnp.asarray(d["vertices"]), jnp.asarray(faces),
                               jmake_camera(R=R, T=T, **kw))
        excused[edge_texels(uv, np.asarray(r["face_idx"]).reshape(-1),
                            np.asarray(r["bary"]).reshape(-1, 3), size)] = True
    diff = np.abs(t_png - j_png).max(-1).reshape(-1)
    assert diff[~excused].max() <= 1 and (diff[~excused] > 0).mean() < 0.01


def test_obj_round_trip_both_ways(tmp_path):
    verts, faces = RASTER_CASES["random_deep"][0]
    uv, size = tex.build_uv_atlas(len(faces), 6)
    texture = np.random.default_rng(0).uniform(-0.1, 1.1, (size, size, 3)).astype(np.float32)
    jp, tp = str(tmp_path / "j" / "mesh.obj"), str(tmp_path / "t" / "mesh.obj")
    os.makedirs(os.path.dirname(jp))
    os.makedirs(os.path.dirname(tp))
    jobj.save_obj(jp, verts, faces, verts_uv=uv, texture=texture)
    obj.save_obj(tp, verts, faces, verts_uv=uv, texture=texture)
    for suffix in (".obj", ".mtl"):
        with open(jp[:-4] + suffix, "rb") as a, open(tp[:-4] + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    expect = (np.clip(texture, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(tp[:-4] + ".png")), expect)
    np.testing.assert_array_equal(read_png(jp[:-4] + ".png"), expect)
    for writer in (jp, tp):
        j_out, t_out = jobj.load_obj(writer), obj.load_obj(writer)
        for a, b in zip(j_out, t_out):
            np.testing.assert_array_equal(b, a)
    v2, f2, uvs, fuv = t_out
    np.testing.assert_allclose(v2, verts, atol=1e-6)
    np.testing.assert_array_equal(f2, faces)
    assert len(uvs) == 3 * len(faces) and fuv.shape == (len(faces), 3)
    # Without UVs or texture: the faces alone, no .mtl.
    plain = str(tmp_path / "t" / "plain.obj")
    obj.save_obj(plain, verts, faces)
    jplain = str(tmp_path / "j" / "plain.obj")
    jobj.save_obj(jplain, verts, faces)
    with open(plain, "rb") as a, open(jplain, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(plain[:-4] + ".mtl")
    _, _, uvs, fuv = obj.load_obj(plain)
    assert uvs is None and fuv is None


def test_textured_render_roundtrip_through_obj(tmp_path):
    """tests/test_texture.py's textured round trip on the port: bake a
    constant colour, save, load with the metrics entry point's UV
    convention and the port's PNG reader, render."""
    verts, faces = facing_quad()
    uv, size = tex.build_uv_atlas(len(faces), square_size=10)
    texture = np.full((size, size, 3), [0.2, 0.6, 0.9], np.float32)
    path = str(tmp_path / "tex.obj")
    obj.save_obj(path, verts, faces, verts_uv=uv, texture=texture)
    lv, lf, luv, lfuv = obj.load_obj(path)
    vt = luv[lfuv]
    verts_uv = np.stack([1.0 - vt[..., 1], vt[..., 0]], axis=-1)
    t = read_png(path[:-4] + ".png").astype(np.float32)[..., :3] / 255.0
    cam = make_camera(height=48, width=48, device="cpu", **CAM)
    img = tex.render_textured_mesh(lv, lf, verts_uv, t, cam, dup_capacity=1024, k_max=16)
    np.testing.assert_allclose(img[24, 24], [0.2, 0.6, 0.9], atol=0.02)
    np.testing.assert_allclose(img[0, 0], 0.0, atol=1e-6)


def test_bake_constant_render_on_params_device_tensors():
    """tests/test_texture.py's constant bake with a tensor render: observed
    texels carry the colour."""
    verts, faces = facing_quad()
    from sugar_tpu_torch.refine.bound import init_bound_params

    params, bm = init_bound_params(verts, faces, None, 1, extent=1.0, sh_degree=0, device="cpu")
    cam = make_camera(height=48, width=48, device="cpu", **CAM)
    color = torch.tensor([0.1, 0.6, 0.9])
    t, _, _ = tex.bake_texture(params, bm, [cam], lambda c: color.expand(48, 48, 3),
                               square_size=12, raster_dup_capacity=1024)
    assert (np.abs(t - color.numpy()).max(-1) < 1e-4).sum() > 10
