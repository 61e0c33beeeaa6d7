"""The port's field modules against the JAX package: KNN (with exact
duplicates and with fewer alive references than k), the density / SDF
field (values and gradients, every beta mode), the in-Gaussian sampler
with the JAX draw injected, smallest axes, local variance, the bilinear
depth lookup, the two neighborhood regularizers and PCA normals.

Tolerances: KNN squared distances 1e-5 * (1 + |q|^2), indices equal to
JAX's; field values rtol 1e-5, atol 1e-6 (sdf_grad: atol 1e-5 *
max|sdf_grad|, see the test); gradients 2e-5 * max|g| + 1e-9
(tests/test_pallas.py:84-88); sampled points 1e-6; normals |dot| >=
1 - 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from sugar_tpu.fields import density as jdf
from sugar_tpu.fields import normals as jnormals
from sugar_tpu.fields import regularizers as jreg
from sugar_tpu.fields.knn import knn as jknn
from sugar_tpu_torch.fields import density as df
from sugar_tpu_torch.fields import normals, regularizers
from sugar_tpu_torch.fields.knn import knn

torch.set_num_threads(2)

def cloud(seed=0, n_ref=3001, n_q=517):
    g = np.random.default_rng(seed)
    refs = (g.normal(size=(n_ref, 3)) + np.array([0.0, 0.0, 3.0])).astype(np.float32)
    queries = (g.normal(size=(n_q, 3)) + np.array([0.0, 0.0, 3.0])).astype(np.float32)
    mask = g.uniform(size=n_ref) > 0.2
    return queries, refs, mask


def knn_pair(queries, refs, k, mask=None):
    """JAX (chunks 256 x 1024) and port (chunks 200 x 700) results as numpy."""
    jm = None if mask is None else jnp.asarray(mask)
    jd, ji = jknn(jnp.asarray(queries), jnp.asarray(refs), k=k, ref_mask=jm, q_chunk=256,
                  r_chunk=1024)
    tm = None if mask is None else torch.tensor(mask)
    td, ti = knn(torch.tensor(queries), torch.tensor(refs), k, tm, q_chunk=200, r_chunk=700)
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


@pytest.mark.parametrize("k", [8, 16])
def test_knn_matches_jax_and_ckdtree(k):
    queries, refs, mask = cloud()
    (jd, ji), (td, ti) = knn_pair(queries, refs, k, mask)
    tol = 1e-5 * (1.0 + (queries**2).sum(-1, keepdims=True))
    assert ti.dtype == np.int64 and td.shape == (len(queries), k)
    np.testing.assert_array_equal(ti, ji)
    assert np.all(np.abs(td - jd) <= tol)
    alive = np.nonzero(mask)[0]
    d_ref, i_ref = cKDTree(refs[alive].astype(np.float64)).query(queries.astype(np.float64), k=k)
    assert np.all(np.abs(td - d_ref**2) <= tol)
    # Against exact float64 distances, a returned neighbor may differ only
    # where the float32 formula cannot order two of them (a gap below the
    # tolerance): its exact distance is the exact j-th distance.
    exact = ((refs[ti].astype(np.float64) - queries[:, None].astype(np.float64)) ** 2).sum(-1)
    assert np.all(np.abs(exact - d_ref**2) <= tol)
    assert (ti == alive[i_ref]).mean() > 0.998
    assert np.all(np.diff(td, axis=1) >= 0)


def test_knn_exact_duplicates_list_the_lower_index_first():
    g = np.random.default_rng(1)
    base = g.normal(size=(500, 3)).astype(np.float32)
    # Clones copy xyz exactly: whole duplicate groups, some of them larger
    # than k, straddling chunk boundaries.
    pts = np.concatenate([base, base[:300], base[100:400], np.repeat(base[7:8], 20, 0)])
    (jd, ji), (td, ti) = knn_pair(pts, pts, 16)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5 * (1 + (pts**2).sum(-1).max()))
    # Within equal distances the indices ascend.
    same = td[:, 1:] == td[:, :-1]
    assert same.sum() > 1000 and np.all(ti[:, 1:][same] > ti[:, :-1][same])


def test_knn_fewer_alive_refs_than_k():
    queries, refs, _ = cloud(seed=2, n_ref=1500, n_q=300)
    mask = np.zeros(len(refs), bool)
    mask[[5, 77, 1499]] = True
    (jd, ji), (td, ti) = knn_pair(queries, refs, 8, mask)
    np.testing.assert_array_equal(ti, ji)
    assert np.all(np.isinf(td[:, 3:])) and np.all(ti[:, 3:] == 0)
    np.testing.assert_allclose(td[:, :3], jd[:, :3], rtol=1e-5)
    # Gathers of the table stay in range, as JAX's clamped gathers do.
    assert int(ti.max()) < len(refs)


def field_arrays(n=60, m=300, k=8, seed=3):
    g = np.random.default_rng(seed)
    quats = g.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    centers = g.normal(size=(n, 3)).astype(np.float32) * 0.6
    scales = np.exp(g.uniform(-2.2, -0.5, (n, 3))).astype(np.float32)
    scales[:5] = scales[:5, :1]  # isotropic: ties in min(scale)
    opac = g.uniform(0.2, 0.99, n).astype(np.float32)
    src = g.integers(0, n, m)
    x = (centers[src] + g.normal(size=(m, 3)) * 0.1).astype(np.float32)
    x[:7] += 40.0  # far from every Gaussian: zero density
    _, idx = cKDTree(centers).query(x, k=k)
    return dict(centers=centers, scales=scales, quaternions=quats, opacities=opac), x, idx


def jgp(a):
    return jdf.GaussianFieldParams(**{f: jnp.asarray(a[f]) for f in jdf.GaussianFieldParams._fields})


def tgp(a, grad=False):
    return df.GaussianFieldParams(**{f: torch.tensor(a[f], requires_grad=grad)
                                     for f in df.GaussianFieldParams._fields})


BETA_MODES = ["average", "weighted_average", "learnable"]


@pytest.mark.parametrize("beta_mode", BETA_MODES)
@pytest.mark.parametrize("sdf_grad", [False, True])
@pytest.mark.parametrize("density_factor", [1.0, 1.0 / 16.0])
def test_field_values_match_jax(beta_mode, sdf_grad, density_factor):
    a, x, idx = field_arrays()
    lb = np.float32(-2.5)
    kw = dict(density_factor=density_factor, return_sdf_grad=sdf_grad, beta_mode=beta_mode)
    j = jdf.field_values(jnp.asarray(x), jnp.asarray(idx, jnp.int32), jgp(a),
                         learnable_beta=jnp.asarray(lb), chunk=128, **kw)
    t = df.field_values(torch.tensor(x), torch.tensor(idx), tgp(a),
                        learnable_beta=torch.tensor(lb), **kw)
    assert set(t) == set(j)
    for key in j:
        ref = np.asarray(j[key])
        # Past the density ceiling sdf_grad's factor beta / (d sqrt(-2 ln d))
        # is ~2e3 and turns the last bit of exp (XLA's and torch's differ)
        # into ~1e-5 relative: its atol scales with max|sdf_grad|.
        atol = 1e-5 * float(np.abs(ref).max()) if key == "sdf_grad" else 1e-6
        np.testing.assert_allclose(t[key].numpy(), ref, rtol=1e-5, atol=atol, err_msg=key)
    dens = t["density"].numpy()
    assert np.all(dens[:7] == 0.0)
    assert dens.max() > 1.0 or density_factor < 1.0  # the soft clamp exercised


def test_field_values_return_beta_without_sdf():
    a, x, idx = field_arrays()
    t = df.field_values(torch.tensor(x), torch.tensor(idx), tgp(a), return_sdf=False,
                        return_beta=True)
    j = jdf.field_values(jnp.asarray(x), jnp.asarray(idx, jnp.int32), jgp(a), chunk=128)
    assert set(t) == {"density", "beta"}
    np.testing.assert_allclose(t["beta"].numpy(), np.asarray(j["beta"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("beta_mode", BETA_MODES)
def test_field_gradients_match_jax(beta_mode):
    a, x, idx = field_arrays()
    g = np.random.default_rng(4)
    w = [g.normal(size=x.shape[0]).astype(np.float32) for _ in range(2)]
    w3 = g.normal(size=x.shape).astype(np.float32)
    lb = np.float32(-2.5)

    def jscalar(xx, gp, beta):
        out = jdf.field_values(xx, jnp.asarray(idx, jnp.int32), gp, return_sdf_grad=True,
                               beta_mode=beta_mode, learnable_beta=beta, chunk=128)
        return (jnp.sum(w[0] * out["density"]) + jnp.sum(w[1] * out["sdf"])
                + jnp.sum(w3 * out["sdf_grad"]))

    jg = jax.grad(jscalar, argnums=(0, 1, 2))(jnp.asarray(x), jgp(a), jnp.asarray(lb))
    tx = torch.tensor(x, requires_grad=True)
    tb = torch.tensor(lb, requires_grad=True)
    gp = tgp(a, grad=True)
    out = df.field_values(tx, torch.tensor(idx), gp, return_sdf_grad=True, beta_mode=beta_mode,
                          learnable_beta=tb)
    scalar = ((torch.tensor(w[0]) * out["density"]).sum() + (torch.tensor(w[1]) * out["sdf"]).sum()
              + (torch.tensor(w3) * out["sdf_grad"]).sum())
    leaves = [tx, *gp, tb]
    tg = torch.autograd.grad(scalar, leaves, allow_unused=True)
    want = [jg[0], *jg[1], jg[2]]
    names = ["x", *df.GaussianFieldParams._fields, "learnable_beta"]
    for name, got, ref in zip(names, tg, want):
        ref = np.asarray(ref)
        got = np.zeros_like(ref) if got is None else got.numpy()
        tol = 2e-5 * float(np.abs(ref).max()) + 1e-9
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=name)


def test_sampler_with_the_jax_draw_matches():
    a, _, _ = field_arrays()
    alive = np.arange(60) % 4 != 0
    key = jax.random.PRNGKey(5)
    jpts, jidx = jdf.sample_points_in_gaussians(key, 500, jgp(a), jnp.asarray(alive),
                                                sampling_scale_factor=1.5)
    _, k_noise = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, (500, 3)))
    tpts, tidx = df.sample_points_in_gaussians(
        (torch.tensor(np.asarray(jidx)), torch.tensor(noise)), 500, tgp(a), torch.tensor(alive),
        sampling_scale_factor=1.5)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), atol=1e-6, rtol=0)
    assert alive[np.asarray(jidx)].all()


def test_sampler_draws_alive_gaussians_and_survives_none_alive():
    a, _, _ = field_arrays()
    alive = np.arange(60) % 3 == 0
    gen = torch.Generator().manual_seed(0)
    pts, idx = df.sample_points_in_gaussians(gen, 4000, tgp(a), torch.tensor(alive))
    assert alive[idx.numpy()].all() and len(np.unique(idx.numpy())) == alive.sum()
    # Volume-proportional: the largest Gaussian is drawn most often.
    vol = np.where(alive, a["scales"].prod(-1), 0)
    assert np.bincount(idx.numpy(), minlength=60).argmax() == vol.argmax()
    pts, idx = df.sample_points_in_gaussians(gen, 100, tgp(a), torch.zeros(60, dtype=torch.bool))
    assert pts.shape == (100, 3) and torch.isfinite(pts).all() and int(idx.max()) < 60
    with pytest.raises(ValueError, match="draw shapes"):
        df.sample_points_in_gaussians((idx, torch.zeros(100, 3)), 50, tgp(a),
                                      torch.zeros(60, dtype=torch.bool))


def test_smallest_axes_local_variance_and_depth_lookup_match_jax():
    a, x, idx = field_arrays()
    np.testing.assert_allclose(
        df.smallest_axes(torch.tensor(a["scales"]), torch.tensor(a["quaternions"])).numpy(),
        np.asarray(jdf.smallest_axes(jnp.asarray(a["scales"]), jnp.asarray(a["quaternions"]))),
        rtol=1e-6, atol=1e-7)
    vals = np.random.default_rng(6).normal(size=(60, 4)).astype(np.float32)
    np.testing.assert_allclose(
        df.local_variance(torch.tensor(vals), torch.tensor(idx)).numpy(),
        np.asarray(jdf.local_variance(jnp.asarray(vals), jnp.asarray(idx))), rtol=1e-5, atol=1e-7)
    g = np.random.default_rng(7)
    depth = g.uniform(1, 5, (24, 40)).astype(np.float32)
    pix = np.concatenate([g.uniform(-3, 43, (200, 1)), g.uniform(-3, 27, (200, 1))], 1)
    pix = np.concatenate([pix, [[0.0, 0.0], [39.0, 23.0], [12.0, 7.0]]]).astype(np.float32)
    w = g.normal(size=len(pix)).astype(np.float32)
    jv, (jgd, jgp_) = jax.value_and_grad(
        lambda d, p: jnp.sum(w * jdf.depth_lookup_bilinear(d, p)), argnums=(0, 1))(
            jnp.asarray(depth), jnp.asarray(pix))
    td = torch.tensor(depth, requires_grad=True)
    tp = torch.tensor(pix, requires_grad=True)
    tv = (torch.tensor(w) * df.depth_lookup_bilinear(td, tp)).sum()
    tgd, tgp_ = torch.autograd.grad(tv, [td, tp])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for got, ref in ((tgd, jgd), (tgp_, jgp_)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5 * float(np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("center_only", [True, False])
@pytest.mark.parametrize("by_normal", [False, True])
def test_regularizers_match_jax(center_only, by_normal):
    a, _, _ = field_arrays()
    _, idx = cKDTree(a["centers"]).query(a["centers"], k=6)
    key = jax.random.PRNGKey(8)
    j_over = jreg.gaussian_overlap_with_neighbors(
        jgp(a), jnp.asarray(idx), rng=key, use_gaussian_center_only=center_only, n_samples=5,
        weight_by_normal_angle=by_normal)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (60, 5, 3))))
    t_over = regularizers.gaussian_overlap_with_neighbors(
        tgp(a), torch.tensor(idx), noise=None if center_only else noise,
        use_gaussian_center_only=center_only, n_samples=5, weight_by_normal_angle=by_normal)
    np.testing.assert_allclose(t_over.numpy(), np.asarray(j_over), rtol=1e-5, atol=1e-6)
    j_al = jreg.gaussian_alignment_with_neighbors(jgp(a), jnp.asarray(idx), std_factor=1.3,
                                                  weight_by_normal_angle=by_normal)
    t_al = regularizers.gaussian_alignment_with_neighbors(tgp(a), torch.tensor(idx),
                                                          std_factor=1.3,
                                                          weight_by_normal_angle=by_normal)
    np.testing.assert_allclose(t_al.numpy(), np.asarray(j_al), rtol=1e-5, atol=1e-6)
    if not center_only:
        with pytest.raises(ValueError, match="noise"):
            regularizers.gaussian_overlap_with_neighbors(tgp(a), torch.tensor(idx),
                                                         use_gaussian_center_only=False)


def test_pointcloud_normals_match_jax():
    """A noisy bumpy sheet: each neighborhood's covariance has a clear
    smallest eigenvalue; rows with a tied majority vote are skipped."""
    g = np.random.default_rng(9)
    uv = g.uniform(-1, 1, (800, 2))
    z = 0.2 * np.sin(2 * uv[:, 0]) * np.cos(uv[:, 1]) + g.normal(0, 0.01, 800)
    pts = np.concatenate([uv, z[:, None]], 1).astype(np.float32)
    mask = g.uniform(size=800) > 0.1
    jn = np.asarray(jnormals.estimate_pointcloud_normals(jnp.asarray(pts), 16,
                                                         mask=jnp.asarray(mask)))
    tn = normals.estimate_pointcloud_normals(torch.tensor(pts), 16, mask=torch.tensor(mask)).numpy()
    _, idx = knn(torch.tensor(pts), torch.tensor(pts), 16, torch.tensor(mask))
    off = pts[idx.numpy()] - pts[:, None]
    votes = ((off * tn[:, None]).sum(-1) > 0).sum(1)
    clear = votes != 8
    assert clear.mean() > 0.8
    np.testing.assert_allclose(np.linalg.norm(tn, axis=-1), 1.0, atol=1e-6)
    assert np.all((tn * jn).sum(-1)[clear] >= 1 - 1e-5)
