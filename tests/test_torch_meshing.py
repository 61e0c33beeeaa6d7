"""The port's coarse mesh extraction against the JAX package: the copied
numpy modules (surface nets, FFT Poisson, outlier removal, cleanup, QEM
and vertex-clustering decimation, vertex normals) bit-equal on
tests/test_meshing.py's cases; the mesh PLY both ways; the level set of
one camera, the collected cloud and ``extract_mesh_from_coarse_model`` on
a tiny scene; the two ablations.

The scene: 200 flattened Gaussians on a sphere of radius 0.7 in 256 slots
(JAX padding), opacity 0.55-0.95 (none pruned at 0.5), 32x32 ring cameras.
The JAX level set has no mode argument; its depth render runs
``mode="pallas"`` with the Pallas kernel in interpret mode by patching the
``render_params_with_colors`` it calls.

Tolerances: the numpy modules bit-equal (the same code on the same
inputs); level-set masks, Gaussian indices and counts exactly equal;
depth, points and normals 1e-5; the ray offsets bit-equal to
``jnp.linspace``; the extracted meshes' counts and faces equal, vertices
1e-5 up to the order ``clean_mesh`` gives them (``vertex_matching``).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_meshing import sphere_points
from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.io import ply as jply
from sugar_tpu.meshing import ablations as jablations
from sugar_tpu.meshing import extract as jextract
from sugar_tpu.meshing import levelset as jlevelset
from sugar_tpu.meshing import meshops as jmeshops
from sugar_tpu.meshing import poisson as jpoisson
from sugar_tpu.models import gaussians as jgm
from sugar_tpu.native import qem_available as jqem_available
from sugar_tpu.native import qem_decimate as jqem_decimate
from sugar_tpu_torch import native
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.interop import model_from_numpy
from sugar_tpu_torch.io import ply
from sugar_tpu_torch.meshing import ablations, extract, levelset, meshops, poisson

torch.set_num_threads(2)

HW = 32
N, CAPACITY = 200, 256
CAPS = dict(dup_capacity=8192, k_max=256)


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- the copied numpy modules ------------------------------------------


def sphere_field(res):
    xs = np.linspace(-1.5, 1.5, res)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    return (np.sqrt(X**2 + Y**2 + Z**2) - 1.0).astype(np.float32), xs


def test_surface_nets_sphere_matches_jax():
    field, xs = sphere_field(48)
    verts, faces = poisson.surface_nets(field, 0.0)
    jv, jf = jpoisson.surface_nets(field, 0.0)
    eq(verts, jv)
    eq(faces, jf)
    assert len(verts) > 500 and len(faces) > 1000
    radii = np.linalg.norm(verts * (xs[1] - xs[0]) + xs[0], axis=-1)
    assert abs(radii.mean() - 1.0) < 0.05 and radii.std() < 0.05
    ekey = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(ekey, axis=0, return_counts=True)
    assert (counts == 2).mean() > 0.99


def test_surface_nets_orientation_outward():
    field, xs = sphere_field(32)
    verts, faces = poisson.surface_nets(field, 0.0)
    world = verts * (xs[1] - xs[0]) + xs[0]
    fn = meshops.face_normals(world, faces)
    eq(fn, jmeshops.face_normals(world, faces))
    frac_out = (np.sum(fn * world[faces].mean(axis=1), axis=-1) > 0).mean()
    assert frac_out > 0.99 or frac_out < 0.01


@pytest.mark.parametrize("noisy", [False, True])
def test_poisson_sphere_matches_jax(noisy):
    pts, nrm = sphere_points(n=30000 if noisy else 20000)
    if noisy:
        pts = pts + 0.01 * np.random.default_rng(1).normal(size=pts.shape).astype(np.float32)
    res_n = 64 if noisy else 96
    res = poisson.poisson_reconstruct(pts, nrm, resolution=res_n)
    jres = jpoisson.poisson_reconstruct(pts, nrm, resolution=res_n)
    for k in ("vertices", "faces", "densities"):
        eq(getattr(res, k), getattr(jres, k))
    radii = np.linalg.norm(res.vertices, axis=-1)
    assert abs(np.median(radii) - 1.0) < (0.1 if noisy else 0.08)
    v, f = poisson.remove_low_density_vertices(res, 0.1)
    jv, jf = jpoisson.remove_low_density_vertices(jres, 0.1)
    eq(v, jv)
    eq(f, jf)
    assert 0 < len(v) <= len(res.vertices) and len(f) > 0


def test_outlier_removal_matches_jax():
    pts, _ = sphere_points(n=5000)
    allpts = np.concatenate([pts, np.array([[10, 10, 10], [-8, 5, 3]], np.float32)])
    extra = np.arange(len(allpts))
    clean, (e,) = meshops.remove_statistical_outliers(allpts, [extra], nb_neighbors=20,
                                                      std_ratio=3.0)
    jclean, (je,) = jmeshops.remove_statistical_outliers(allpts, [extra], nb_neighbors=20,
                                                         std_ratio=3.0)
    eq(clean, jclean)
    eq(e, je)
    assert len(clean) <= 5000 and not np.isin([5000, 5001], e).any()


def test_clean_mesh_matches_jax():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 0], [2, 2, 2]], np.float32)
    faces = np.array([[0, 1, 2], [3, 1, 2], [1, 1, 2]], np.int64)
    v, f = meshops.clean_mesh(verts, faces)
    jv, jf = jmeshops.clean_mesh(verts, faces)
    eq(v, jv)
    eq(f, jf)
    assert len(v) == 3 and len(f) == 1


@pytest.fixture(scope="module")
def sphere64():
    pts, nrm = sphere_points(n=8000)
    return poisson.poisson_reconstruct(pts, nrm, resolution=64)


def test_qem_decimation_matches_jax(sphere64):
    v, f = native.qem_decimate(sphere64.vertices, sphere64.faces, 600)
    jv, jf = jqem_decimate(sphere64.vertices, sphere64.faces, 600)
    eq(v, jv)
    eq(f, jf)
    assert len(v) <= 650
    radii = np.linalg.norm(v, axis=-1)
    assert abs(np.median(radii) - 1.0) < 0.05 and radii.std() < 0.05
    assert f.min() >= 0 and f.max() < len(v)
    assert ((f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])).all()
    # decimate = QEM + clean_mesh, as the JAX package's when its build works.
    dv, df_ = meshops.decimate(sphere64.vertices, sphere64.faces, 600)
    jdv, jdf = jmeshops.decimate(sphere64.vertices, sphere64.faces, 600)
    eq(dv, jdv)
    eq(df_, jdf)


def test_decimate_raises_when_the_qem_build_fails(sphere64, monkeypatch, tmp_path):
    """No fallback: with the compiler pointed at a missing binary, decimate
    raises where the JAX package would cluster vertices."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(OSError):
        meshops.decimate(sphere64.vertices, sphere64.faces, 600)
    # A compiler that runs and fails raises too.
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match="false failed for qem"):
        meshops.decimate(sphere64.vertices, sphere64.faces, 600)
    assert native._libs == {}
    # Under the vertex budget nothing is decimated and nothing is built.
    v, f = meshops.decimate(sphere64.vertices, sphere64.faces, len(sphere64.vertices))
    eq(v, sphere64.vertices)


def test_qem_available_matches_jax(monkeypatch, tmp_path):
    """True where the host library builds and loads (g++ here), as in the
    JAX package; False when the build fails."""
    assert native.qem_available() is jqem_available() is True
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_libs", {})
    assert native.qem_available() is False
    monkeypatch.setattr(native, "CXX", "false")
    assert native.qem_available() is False


def test_vertex_clustering_and_normals_match_jax(sphere64):
    v, f = meshops.decimate_vertex_clustering(sphere64.vertices, sphere64.faces, 500)
    jv, jf = jmeshops.decimate_vertex_clustering(sphere64.vertices, sphere64.faces, 500)
    eq(v, jv)
    eq(f, jf)
    assert len(v) < 1000 and len(f) > 100
    vn = meshops.vertex_normals(sphere64.vertices, sphere64.faces)
    eq(vn, jmeshops.vertex_normals(sphere64.vertices, sphere64.faces))
    r = sphere64.vertices / np.linalg.norm(sphere64.vertices, axis=-1, keepdims=True)
    assert np.median(np.abs(np.sum(vn * r, axis=-1))) > 0.95
    parts = [(v, f), (v + 3.0, f)]
    mv, mf = meshops.merge_meshes(parts)
    jmv, jmf = jmeshops.merge_meshes(parts)
    eq(mv, jmv)
    eq(mf, jmf)


# --- PLY -----------------------------------------------------------------


@pytest.mark.parametrize("colors", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mesh_ply_round_trip(tmp_path, writer, colors):
    g = np.random.default_rng(4)
    verts = g.normal(size=(40, 3)).astype(np.float32)
    faces = g.integers(0, 40, (70, 3))
    vc = g.uniform(0, 1, (40, 3)).astype(np.float32) if colors else None
    path = str(tmp_path / "mesh.ply")
    (ply.save_mesh_ply if writer == "port" else jply.save_mesh_ply)(path, verts, faces, vc)
    for loader in (ply.load_mesh_ply, jply.load_mesh_ply):
        v, f, c = loader(path)
        eq(v, verts)
        eq(f, faces)
        if colors:
            eq(c, (np.clip(vc, 0, 1) * 255).astype(np.uint8))
        else:
            assert c is None


def test_point_cloud_ply_loads_in_jax(tmp_path):
    g = np.random.default_rng(5)
    xyz = g.normal(size=(30, 3)).astype(np.float32)
    nrm = g.normal(size=(30, 3)).astype(np.float32)
    cols = g.uniform(0, 1, (30, 3)).astype(np.float32)
    ply.save_point_cloud_ply(str(tmp_path / "p.ply"), xyz, cols, nrm)
    jply.save_point_cloud_ply(str(tmp_path / "j.ply"), xyz, cols, nrm)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    v = jply.read_ply(str(tmp_path / "p.ply"))["vertex"]
    eq(np.stack([v["x"], v["y"], v["z"]], 1), xyz)
    eq(np.stack([v["nx"], v["ny"], v["nz"]], 1), nrm)


# --- the level set and the extraction -------------------------------------


def ring(n_cams):
    out = []
    for i in range(n_cams):
        th = 2 * np.pi * i / n_cams
        fwd = -np.array([np.cos(th), 0.2, np.sin(th)])
        fwd /= np.linalg.norm(fwd)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        rwc = np.stack([right, np.cross(fwd, right), fwd], 0)
        out.append((rwc.T, -rwc @ (-fwd * 2.5)))
    return out


def cams(device=None, n_cams=4):
    kw = dict(fov_x=0.8, fov_y=0.8, height=HW, width=HW)
    if device is None:
        return [jmake_camera(R=r, T=t, **kw) for r, t in ring(n_cams)]
    return [make_camera(R=r, T=t, device=device, **kw) for r, t in ring(n_cams)]


def scene(seed=0):
    """Raw fields of 200 flattened Gaussians tangent to a sphere of radius
    0.7 in 256 slots, SH degree 0."""
    g = np.random.default_rng(seed)
    d = g.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # Rotate z onto the radial direction: the thin axis along the normal.
    z = np.array([0.0, 0.0, 1.0])
    quats = np.concatenate([1.0 + d @ z[:, None], np.cross(z, d)], -1)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = g.uniform(0.55, 0.95, N)
    s = g.uniform(0.1, 0.16, N)
    f = dict(
        xyz=0.7 * d,
        sh_dc=(0.4 + 0.6 * np.abs(d) - 0.5) / 0.28209479177387814,
        sh_rest=np.zeros((N, 3, 0)),
        opacity_logit=np.log(opac / (1 - opac)),
        log_scales=np.log(np.stack([s, s * g.uniform(0.7, 1.0, N), s * 0.2], -1)),
        quaternions=quats,
    )
    fill = dict(opacity_logit=-10.0, log_scales=-10.0)
    for k, v in f.items():
        pad = np.full((CAPACITY - N,) + v.shape[1:], fill.get(k, 0.0))
        f[k] = np.concatenate([v, pad]).astype(np.float32)
    f["quaternions"][N:, 0] = 1.0
    return f, np.arange(CAPACITY) < N


def jmodel(f, alive):
    return jgm.GaussianModel(jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in f.items()}),
                             jnp.asarray(alive), 0)


@contextlib.contextmanager
def jax_pallas_levelset():
    """The JAX level set's depth render through its Pallas kernel in
    interpret mode (the function has no mode argument)."""
    orig = jlevelset.render_params_with_colors
    jlevelset.render_params_with_colors = functools.partial(orig, mode="pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        jlevelset.render_params_with_colors = orig


_cache = {}


def one_camera():
    if "one" not in _cache:
        f, alive = scene()
        jm = jmodel(f, alive)
        with jax_pallas_levelset():
            j = jlevelset.level_surface_points_one_camera(jm.params, jm.alive, cams()[1], **CAPS)
            j = {k: np.asarray(v) for k, v in j.items()}
        tm = model_from_numpy(f, alive, 0, device="cpu")
        t = levelset.level_surface_points_one_camera(tm.params, tm.alive, cams("cpu")[1], **CAPS)
        _cache["one"] = (j, {k: v.numpy() for k, v in t.items()})
    return _cache["one"]


def test_ray_offsets_equal_jnp_linspace():
    for r, n in ((3.0, 21), (2.0, 11), (3.0, 31), (1.5, 9)):
        want = np.asarray(jax.jit(lambda: jnp.linspace(-r, r, n))())
        got = levelset.ray_offsets(r, n).numpy()
        assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist(), (r, n)


def test_level_surface_points_one_camera_matches_jax():
    j, t = one_camera()
    eq(t["valid"], j["valid"])
    eq(t["gaussian_idx"], j["gaussian_idx"])
    np.testing.assert_allclose(t["depth"], j["depth"], atol=1e-5, rtol=0)
    v = j["valid"]
    np.testing.assert_allclose(t["points"][v], j["points"][v], atol=1e-5, rtol=0)
    np.testing.assert_allclose(t["normals"][v], j["normals"][v], atol=1e-5, rtol=0)
    has_depth = t["depth"].reshape(-1) < t["depth"].max()
    # Valid pixels, covered pixels with no crossing, and empty pixels.
    assert v.sum() > 50 and (has_depth & ~v).sum() > 0 and (~has_depth).sum() > 0
    # The depth render's counters come back beside the points: none dropped.
    assert all(int(t[k]) == 0 for k in ("bin_overflow", "cap_overflow", "tile_overflow"))


def test_level_set_points_lie_on_the_level():
    """The interpolated points sit near the 0.3 level of the field."""
    from sugar_tpu_torch.fields import density as df

    _, t = one_camera()
    f, alive = scene()
    tm = model_from_numpy(f, alive, 0, device="cpu")
    gp = df.GaussianFieldParams(tm.params.xyz, tm.scales, tm.quaternions, tm.opacities)
    pts = torch.tensor(t["points"][t["valid"]])
    from sugar_tpu_torch.fields.knn import knn

    _, idx = knn(pts, tm.params.xyz, 16, tm.alive)
    dens = df.field_values(pts, idx, gp, return_sdf=False)["density"].numpy()
    assert np.median(np.abs(dens - 0.3)) < 0.05


def collected():
    if "cloud" not in _cache:
        f, alive = scene()
        colors = np.random.default_rng(2).uniform(0, 1, (CAPACITY, 3)).astype(np.float32)
        kw = dict(total_points=4 * 60, colors_per_gaussian=colors, **CAPS)
        with jax_pallas_levelset():
            j = jlevelset.collect_surface_points(jmodel(f, alive), cams(), rng=np.random.default_rng(7),
                                                 **kw)
        t = levelset.collect_surface_points(model_from_numpy(f, alive, 0, device="cpu"),
                                            cams("cpu"), rng=np.random.default_rng(7), **kw)
        _cache["cloud"] = (j, t)
    return _cache["cloud"]


def test_collect_surface_points_matches_jax():
    j, t = collected()
    assert len(t["points"]) == len(j["points"]) == 4 * 60  # every camera subsampled
    eq(t["gaussian_idx"], j["gaussian_idx"])
    eq(t["colors"], j["colors"])
    np.testing.assert_allclose(t["points"], j["points"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(t["normals"], j["normals"], atol=1e-5, rtol=0)
    assert len(t["overflow"]) == 4 and all(o["tile_overflow"] == 0 for o in t["overflow"])


def test_extract_mesh_from_coarse_model_matches_jax(tmp_path):
    f, alive = scene()
    cfg = dict(poisson_resolution=48, total_points=100_000, decimation_target=100_000, **CAPS)
    with jax_pallas_levelset():
        jv, jf = jextract.extract_mesh_from_coarse_model(
            jmodel(f, alive), cams(), jextract.ExtractConfig(**cfg),
            output_path=str(tmp_path / "jax.ply"))
    path = str(tmp_path / "port.ply")
    tv, tf = extract.extract_mesh_from_coarse_model(
        model_from_numpy(f, alive, 0, device="cpu"), cams("cpu"), extract.ExtractConfig(**cfg),
        output_path=path)
    assert tv.shape == jv.shape and tf.shape == jf.shape
    assert len(tv) > 1000 and len(tf) > 1000
    perm = vertex_matching(tv, jv)
    eq(perm[tf], jf)
    v, fc, c = jply.load_mesh_ply(path)
    eq(v, tv)
    eq(fc, tf)
    _, _, jc = jply.load_mesh_ply(str(tmp_path / "jax.ply"))
    eq(c, jc[perm])
    assert abs(np.median(np.linalg.norm(tv, axis=1)) - 0.7) < 0.1


def vertex_matching(tv, jv, atol=1e-5):
    """The port -> JAX vertex permutation of two meshes whose vertices agree
    within ``atol`` up to order: clean_mesh orders vertices by np.unique of
    their coordinates rounded to 7 decimals, so two vertices that round
    alike in one package and not in the other may swap places."""
    from scipy.spatial import cKDTree

    _, perm = cKDTree(jv).query(tv)
    eq(np.sort(perm), np.arange(len(jv)))
    np.testing.assert_allclose(tv, jv[perm], atol=atol, rtol=0)
    return perm


def test_extract_refuses_a_device_mesh():
    """The port's device_mesh is a number of ranks; a mesh object (the JAX
    package's jax.sharding.Mesh) or a count below 1 is refused before any
    rank starts."""
    f, alive = scene()
    for bad, err in ((object(), TypeError), (0, ValueError)):
        with pytest.raises(err):
            extract.extract_mesh_from_coarse_model(model_from_numpy(f, alive, 0, device="cpu"),
                                                   cams("cpu"), device_mesh=bad)


def test_centers_ablation_matches_jax():
    pts, _ = sphere_points(n=3000)
    cols = np.random.default_rng(0).uniform(0.2, 1, (len(pts), 3)).astype(np.float32)
    jm = jgm.create_from_pcd(pts, cols, 4096, sh_degree=0, initial_opacity=0.9)
    f = {k: np.asarray(getattr(jm.params, k)) for k in ("xyz", "sh_dc", "sh_rest", "opacity_logit",
                                                         "log_scales", "quaternions")}
    tm = model_from_numpy(f, np.asarray(jm.alive), 0, device="cpu")
    kw = dict(poisson_resolution=64, decimation_target=5000)
    jv, jf = jablations.extract_mesh_from_gaussian_centers(jm, cams(n_cams=1), **kw)
    tv, tf = ablations.extract_mesh_from_gaussian_centers(tm, cams("cpu", n_cams=1), **kw)
    assert len(tv) > 100 and len(tf) > 100
    assert abs(np.median(np.linalg.norm(tv, axis=1)) - 1.0) < 0.1
    # PCA normals come from eigh on each side (sign-disambiguated alike, but
    # not bit-equal), so the Poisson inputs differ by rounding: counts agree
    # within 1%.
    assert abs(len(tv) - len(jv)) <= 0.01 * len(jv)
    assert abs(len(tf) - len(jf)) <= 0.01 * len(jf)


def test_marching_cubes_ablation_matches_jax():
    f, alive = scene()
    kw = dict(surface_level=0.3, resolution=40, chunk=8192)
    jv, jf = jablations.extract_mesh_with_marching_cubes(jmodel(f, alive), **kw)
    tv, tf = ablations.extract_mesh_with_marching_cubes(model_from_numpy(f, alive, 0, device="cpu"),
                                                        **kw)
    assert tv.shape == jv.shape and len(tv) > 500
    eq(vertex_matching(tv, jv)[tf], jf)
