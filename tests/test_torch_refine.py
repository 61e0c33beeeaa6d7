"""The port's mesh-bound refinement against the JAX package: every function
of ``refine/bound.py`` (values and gradients) on a random mesh and on the
axis-aligned planar grid of tests/test_refine.py, for 1, 3, 4 and 6
Gaussians per triangle; ``refine_loss`` and one ``make_refine_step``; a
``refined_training`` window; kill-and-resume of the port on the CPU; the
refined PLY both ways; ``load_refined_state`` on the pickle that
``sugar_tpu/pipeline.py`` writes.

Both packages get the same numpy state (carried across by
``interop.bound_from_numpy``). The JAX renders run ``mode="pallas"`` with
the Pallas kernels in interpret mode.

Tolerances: values 1e-6 (1e-5 for the loss and the image), quaternions
up to sign (q and -q are one rotation); the adjacency tables and face
pairs exactly equal; gradients within 2e-5 *
max|g| + 1e-9 (tests/test_pallas.py:84-88). After a step, params where
|g| is within that tolerance of 0 are held to 2 * lr (Adam with eps 1e-15
moves them by ~lr * sign(g)), as in tests/test_torch_coarse.py.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_io import one_thread  # noqa: F401  (fixture)
from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.io import ply as jply
from sugar_tpu.raster import adaptive as jadaptive
from sugar_tpu.refine import bound as JB
from sugar_tpu.refine import trainer as jtrainer
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.interop import bound_adam_from_numpy, bound_from_numpy
from sugar_tpu_torch.io import ply
from sugar_tpu_torch.models.gaussians import load_ply
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.refine import bound as B
from sugar_tpu_torch.refine import trainer

torch.set_num_threads(2)

FIELDS = B.BOUND_FIELDS
HW = 32
SH_DEGREE = 1
CAPS = dict(tile_cap=16, k_max=256)


def grid_mesh(n=5, bumpy=False, seed=0):
    """tests/test_refine.py's planar grid at z = 2 (axis-aligned edges and
    normals), or the same grid with every vertex jittered in 3D."""
    xs = np.linspace(-0.8, 0.8, n)
    verts = np.array([[x, y, 2.0] for x in xs for y in xs], np.float64)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    if bumpy:
        g = np.random.default_rng(seed)
        verts += g.uniform(-0.08, 0.08, verts.shape) * np.array([1.0, 1.0, 3.0])
    return verts.astype(np.float32), np.array(faces, np.int64)


MESHES = {"random": grid_mesh(bumpy=True), "planar": grid_mesh()}


def state_np(mesh, gpt, perturb=True, seed=1):
    """The JAX package's init_bound_params for the mesh, as numpy fields;
    with ``perturb``, random scales, rotations, opacities and SH."""
    verts, faces = MESHES[mesh]
    colors = np.random.default_rng(seed + 10).uniform(0, 1, (len(verts), 3)).astype(np.float32)
    p, bm = JB.init_bound_params(verts, faces, colors, gpt, extent=2.0, sh_degree=SH_DEGREE)
    d = {f: np.array(getattr(p, f)) for f in FIELDS}
    if perturb:
        g = np.random.default_rng(seed)
        n = d["opacity_logit"].shape[0]
        d["log_scales"] += g.normal(0, 0.3, d["log_scales"].shape).astype(np.float32)
        ang, mag = g.uniform(0, 2 * np.pi, n), g.uniform(0.5, 1.5, n)
        d["complex_rot"] = np.stack([mag * np.cos(ang), mag * np.sin(ang)], -1).astype(np.float32)
        d["opacity_logit"] = g.normal(0, 1, n).astype(np.float32)
        d["sh_dc"] += g.normal(0, 0.3, d["sh_dc"].shape).astype(np.float32)
        d["sh_rest"] = g.normal(0, 0.1, d["sh_rest"].shape).astype(np.float32)
    return d, np.asarray(bm.faces), float(bm.thickness)


def both(mesh, gpt, perturb=True):
    """(JAX (params, bm), port (params, bm)) of one state."""
    d, faces, th = state_np(mesh, gpt, perturb)
    jp = JB.BoundParams(**{f: jnp.asarray(v) for f, v in d.items()})
    _, bary = JB.BARY_TABLES[gpt]
    jbm = JB.BoundMesh(faces=jnp.asarray(faces), bary=jnp.asarray(bary.astype(np.float32)),
                       thickness=jnp.asarray(th, jnp.float32), n_per_triangle=gpt)
    return (jp, jbm), bound_from_numpy(d, faces, gpt, th, device="cpu")


def close(t, j, atol=1e-6, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0, err_msg=what)


def close_quat(t, j, what=""):
    """Quaternions within 1e-6 up to sign: where two pivots of
    matrix_to_quaternion tie exactly in one package, an ulp decides in the
    other, and it returns -q, the same rotation."""
    t, j = t.detach().numpy(), np.asarray(j)
    sign = np.where((t * j).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(t * sign, j, atol=1e-6, rtol=0, err_msg=what)


CASES = [(m, g) for m in MESHES for g in (1, 3, 4, 6)] + [("planar-init", 1), ("planar-init", 3)]


def case(mesh, gpt):
    if mesh == "planar-init":  # exactly init_bound_params: identity rotations, equal scales
        return both("planar", gpt, perturb=False)
    return both(mesh, gpt)


def reference_vertices(v):
    """A deformed reference mesh for edited_quaternions_and_scales."""
    return v + 0.05 * np.sin(3.0 * v)


_jax_cases = {}


def jax_case(mesh, gpt):
    """The JAX functions of one case in one jit: face geometry, the
    Gaussian arrays, the edited quaternions and scales, and the gradients
    of sum(w * to_gaussian_arrays) with fixed random weights."""
    key = (mesh, gpt)
    if key not in _jax_cases:
        (jp, jbm), _ = case(mesh, gpt)
        w = scalar_weights(JB.to_gaussian_arrays(jp, jbm))
        ref = jnp.asarray(reference_vertices(np.asarray(jp.vertices)))

        def scalar(p):
            a = JB.to_gaussian_arrays(p, jbm)
            return sum(jnp.sum(a[k] * w[k]) for k in a), a

        def run(p):
            (_, out), g = jax.value_and_grad(scalar, has_aux=True)(p)
            out = dict(out)
            out["fv"], out["n"] = JB.face_geometry(p.vertices, jbm.faces)
            out["edited_q"], out["edited_s"] = JB.edited_quaternions_and_scales(p, jbm, ref)
            return out, g

        out, g = jax.jit(run)(jp)
        _jax_cases[key] = ({k: np.asarray(v) for k, v in out.items()},
                           {f: np.asarray(getattr(g, f)) for f in FIELDS}, w)
    return _jax_cases[key]


@pytest.mark.parametrize("mesh,gpt", CASES)
def test_init_bound_params_matches_jax(mesh, gpt):
    verts, faces = MESHES[mesh.split("-")[0]]
    colors = np.random.default_rng(3).uniform(0, 1, (len(verts), 3)).astype(np.float32)
    jp, jbm = JB.init_bound_params(verts, faces, colors, gpt, extent=2.0, sh_degree=SH_DEGREE)
    tp, tbm = B.init_bound_params(verts, faces, colors, gpt, extent=2.0, sh_degree=SH_DEGREE,
                                  device="cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f))), f
    assert tbm.faces.dtype == torch.int64 and np.array_equal(tbm.faces.numpy(), np.asarray(jbm.faces))
    assert np.array_equal(tbm.bary.numpy(), np.asarray(jbm.bary))
    assert float(tbm.thickness) == float(jbm.thickness) and tbm.n_per_triangle == gpt


@pytest.mark.parametrize("mesh,gpt", CASES)
def test_bound_functions_match_jax(mesh, gpt):
    j, _, _ = jax_case(mesh, gpt)
    _, (tp, tbm) = case(mesh, gpt)
    fv, n = B.face_geometry(tp.vertices, tbm.faces)
    close(fv, j["fv"])
    close(n, j["n"])
    arrs = B.to_gaussian_arrays(tp, tbm)
    for k in ("centers", "scales", "opacities", "sh"):
        close(arrs[k], j[k], what=k)
    close_quat(arrs["quaternions"], j["quaternions"])
    close(B.gaussian_centers(tp, tbm), j["centers"])
    close(B.gaussian_scales(tp, tbm), j["scales"])
    close_quat(B.gaussian_quaternions(tp, tbm), j["quaternions"])
    close(B.bound_sh(tp), j["sh"])
    q, s = B.edited_quaternions_and_scales(
        tp, tbm, torch.as_tensor(reference_vertices(tp.vertices.numpy())))
    close_quat(q, j["edited_q"], "edited quaternions")
    close(s, j["edited_s"], what="edited scales")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_losses_and_tables_match_jax(mesh):
    (jp, jbm), (tp, tbm) = both(mesh, 1)
    faces = MESHES[mesh][1]
    pairs = B.normal_consistency_pairs(faces)
    np.testing.assert_array_equal(pairs, JB.normal_consistency_pairs(faces))
    assert pairs.dtype == np.int32 and len(pairs) > len(faces)
    idx, mask = B.vertex_adjacency(faces, len(MESHES[mesh][0]))
    jidx, jmask = JB.vertex_adjacency(faces, len(MESHES[mesh][0]))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(mask, jmask)
    tv = tp.vertices.clone().requires_grad_(True)
    tpairs = torch.as_tensor(pairs.astype(np.int64))
    nc = B.normal_consistency_loss(tv, tbm.faces, tpairs)
    lap = B.laplacian_uniform_loss(tv, torch.as_tensor(idx.astype(np.int64)), torch.as_tensor(mask))
    jnc, jgnc = jax.jit(jax.value_and_grad(JB.normal_consistency_loss))(
        jp.vertices, jbm.faces, jnp.asarray(pairs))
    jlap, jglap = jax.jit(jax.value_and_grad(JB.laplacian_uniform_loss))(
        jp.vertices, jnp.asarray(idx), jnp.asarray(mask))
    close(nc, jnc)
    close(lap, jlap)
    g = torch.autograd.grad(lap, tv)[0].numpy()
    jglap = np.asarray(jglap)
    # JAX's gradient is NaN at a vertex that sits exactly at its neighbors'
    # mean (the norm's gradient at 0; the interior of the planar grid); the
    # port's is finite there (ROADMAP.md, queue 3).
    nan_rows = np.isnan(jglap).any(-1)
    assert np.isfinite(g).all() and (nan_rows.any() == (mesh == "planar"))
    np.testing.assert_allclose(g[~nan_rows], jglap[~nan_rows],
                               atol=2e-5 * float(np.abs(jglap[~nan_rows]).max()) + 1e-9, rtol=0)
    g = torch.autograd.grad(nc, tv)[0].numpy()
    if mesh == "planar":
        # Flat: the loss is at its minimum, and both gradients are rounding.
        assert float(nc) < 1e-6 and np.abs(g).max() < 1e-6 and np.abs(jgnc).max() < 1e-6
    else:
        np.testing.assert_allclose(g, np.asarray(jgnc), atol=2e-5 * float(np.abs(jgnc).max()),
                                   rtol=0)


def scalar_weights(arrs, seed=5):
    g = np.random.default_rng(seed)
    return {k: g.normal(size=np.shape(v)).astype(np.float32) for k, v in arrs.items()}


@pytest.mark.parametrize("mesh,gpt", CASES)
def test_to_gaussian_arrays_gradients_match_jax(mesh, gpt):
    """Gradients of sum(w * to_gaussian_arrays(...)) with fixed random
    weights: vertices (through the barycentric gathers, the face normals
    and matrix_to_quaternion), scales, rotations, opacities and SH. The
    axis-aligned planar grids put pivots of matrix_to_quaternion exactly
    at 0 and exactly tied (tests/test_refine.py:103-117)."""
    _, jg, w = jax_case(mesh, gpt)
    _, (tp, tbm) = case(mesh, gpt)
    leaves = [getattr(tp, f).clone().requires_grad_(True) for f in FIELDS]
    a = B.to_gaussian_arrays(B.BoundParams(**dict(zip(FIELDS, leaves))), tbm)
    tg = torch.autograd.grad(sum((a[k] * torch.as_tensor(w[k])).sum() for k in a), leaves)
    for f, g in zip(FIELDS, tg):
        tol = 2e-5 * float(np.abs(jg[f]).max()) + 1e-9
        np.testing.assert_allclose(g.numpy(), jg[f], atol=tol, rtol=0, err_msg=f)
        assert float(np.abs(jg[f]).max()) > 0, f


@pytest.mark.parametrize("gpt", [1, 3])
def test_edited_quaternions_and_scales_gradients_match_jax(gpt):
    (jp, jbm), (tp, tbm) = both("random", gpt)
    ref = MESHES["planar"][0]
    w = np.random.default_rng(6).normal(size=(len(jp.opacity_logit), 7)).astype(np.float32)

    def jscalar(p):
        q, s = JB.edited_quaternions_and_scales(p, jbm, jnp.asarray(ref))
        return jnp.sum(jnp.concatenate([q, s], -1) * w)

    jg = jax.jit(jax.grad(jscalar))(jp)
    leaves = [getattr(tp, f).clone().requires_grad_(True) for f in ("vertices", "log_scales",
                                                                     "complex_rot")]
    p = dataclasses.replace(tp, **dict(zip(("vertices", "log_scales", "complex_rot"), leaves)))
    q, s = B.edited_quaternions_and_scales(p, tbm, torch.as_tensor(ref))
    tg = torch.autograd.grad((torch.cat([q, s], -1) * torch.as_tensor(w)).sum(), leaves)
    for f, g in zip(("vertices", "log_scales", "complex_rot"), tg):
        want = np.asarray(getattr(jg, f))
        np.testing.assert_allclose(g.numpy(), want, atol=2e-5 * float(np.abs(want).max()) + 1e-9,
                                   rtol=0, err_msg=f)


# --- the loss, the step, the trainer --------------------------------------


def camera(device=None):
    kw = dict(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.2, height=HW, width=HW)
    return jmake_camera(**kw) if device is None else make_camera(device=device, **kw)


def targets(n=2, seed=7):
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HW, 0:HW] / HW
    base = np.stack([0.3 + 0.5 * xx, 0.6 - 0.3 * yy, 0.5 + 0.2 * xx * yy], -1)
    return [np.clip(base + g.normal(0, 0.05, base.shape), 0, 1).astype(np.float32)
            for _ in range(n)]


_cache = {}


def loss_pair():
    """(JAX, port) refine_loss value, aux and gradients at one state."""
    if "loss" not in _cache:
        (jp, jbm), (tp, tbm) = both("random", 3)
        faces = MESHES["random"][1]
        pairs = B.normal_consistency_pairs(faces)
        gt = targets()[0]
        dup = 8 * len(faces) * 3
        jcfg = jtrainer.RefineConfig(render_mode="pallas", sh_degree=SH_DEGREE, k_max=256)

        def jloss(p):
            return jtrainer.refine_loss(jcfg, p, jbm, jnp.asarray(pairs), camera(), jnp.asarray(gt),
                                        SH_DEGREE, dup, **CAPS)

        with pltpu.force_tpu_interpret_mode():
            (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
            jax.block_until_ready(jg)
        leaves = [getattr(tp, f).clone().requires_grad_(True) for f in FIELDS]
        tl, taux = trainer.refine_loss(
            trainer.RefineConfig(sh_degree=SH_DEGREE), B.BoundParams(**dict(zip(FIELDS, leaves))),
            tbm, torch.as_tensor(pairs.astype(np.int64)), camera("cpu"), torch.as_tensor(gt),
            SH_DEGREE, dup, **CAPS)
        tg = torch.autograd.grad(tl, leaves, allow_unused=True)
        _cache["loss"] = (float(jl), jaux, {f: np.asarray(getattr(jg, f)) for f in FIELDS},
                          float(tl.detach()), taux, {f: g.numpy() for f, g in zip(FIELDS, tg)})
    return _cache["loss"]


def test_refine_loss_matches_jax():
    jl, jaux, _, tl, taux, _ = loss_pair()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(float(taux["psnr"]), float(jaux["psnr"]), rtol=1e-5)
    assert adaptive.read_overflow(taux) == jadaptive.read_overflow(jaux)
    assert adaptive.read_overflow(taux)["tile_overflow"] == 0


@pytest.mark.parametrize("field", FIELDS)
def test_refine_loss_gradients_match_jax(field):
    _, _, jg, _, _, tg = loss_pair()
    tol = 2e-5 * float(np.abs(jg[field]).max()) + 1e-9
    np.testing.assert_allclose(tg[field], jg[field], atol=tol, rtol=0)
    assert float(np.abs(jg[field]).max()) > 0


def step_pair():
    """One make_refine_step of each package from the same state, Adam from
    zero moments, at iteration 5."""
    if "step" not in _cache:
        (jp, jbm), (tp, tbm) = both("random", 3)
        faces = MESHES["random"][1]
        pairs = B.normal_consistency_pairs(faces)
        gt = targets()[1]
        caps = dict(dup_capacity=8 * len(faces) * 3, **CAPS)
        jcfg = jtrainer.RefineConfig(render_mode="pallas", sh_degree=SH_DEGREE)
        jstep = jtrainer.make_refine_step(jcfg, jbm, jnp.asarray(pairs),
                                          jtrainer.bound_lrs(jcfg, 0.5), SH_DEGREE,
                                          jadaptive.RasterCaps(**caps))
        with pltpu.force_tpu_interpret_mode():
            out = jstep(jp, jtrainer.init_bound_adam(jp), camera(), jnp.asarray(gt),
                        jnp.asarray(5, jnp.int32))
            jax.block_until_ready(out)
        tcfg = trainer.RefineConfig(sh_degree=SH_DEGREE)
        lrs = trainer.bound_lrs(tcfg, 0.5)
        tstep = trainer.make_refine_step(tcfg, tbm, torch.as_tensor(pairs.astype(np.int64)), lrs,
                                         SH_DEGREE, adaptive.RasterCaps(**caps))
        tout = tstep(tp, trainer.init_bound_adam(tp), camera("cpu"), torch.as_tensor(gt), 5)
        _cache["step"] = dict(jax=out, port=tout, lrs=lrs)
    return _cache["step"]


@pytest.mark.parametrize("field", FIELDS)
def test_refine_step_matches_jax(field):
    s = step_pair()
    jp, jadam, jaux = s["jax"]
    tp, tadam, taux = s["port"]
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
    assert int(tadam.count) == int(jadam.count) == 1
    jg = np.asarray(getattr(jadam.mu, field)) / 0.1  # mu = 0.1 g after one step
    tg = getattr(tadam.mu, field).numpy() / 0.1
    tol = 2e-5 * max(float(np.abs(jg).max()), 1e-8) + 1e-9
    np.testing.assert_allclose(tg, jg, atol=tol, rtol=0)
    lr = float(s["lrs"][field](5))
    jv, tv = np.asarray(getattr(jp, field)), getattr(tp, field).numpy()
    near_zero = np.abs(jg) <= tol
    np.testing.assert_allclose(tv[~near_zero], jv[~near_zero], rtol=1e-6, atol=1e-3 * lr)
    assert np.all(np.abs(tv[near_zero] - jv[near_zero]) <= 2 * lr * (1 + 1e-5))


WINDOW = dict(num_iterations=5, n_gaussians_per_triangle=3, sh_degree=SH_DEGREE,
              sh_warmup_every=1000, dup_capacity_mult=8, log_every=1, k_max=256)


def unequal_scales(init, to_array):
    """``init_bound_params`` with the same random offsets added to every
    log scale in both packages: init gives equal in-plane scales, about
    which the in-plane rotation is a symmetry, and complex_rot's gradient
    would be rounding."""
    def wrapped(*args, **kwargs):
        p, bm = init(*args, **kwargs)
        noise = np.random.default_rng(4).normal(0, 0.3, tuple(p.log_scales.shape))
        return dataclasses.replace(p, log_scales=p.log_scales + to_array(noise.astype(np.float32))), bm
    return wrapped


def window_runs():
    """refined_training over 5 iterations (SH degree 0: the warmup raises it
    at 1000), both packages, from the jittered grid with vertex colors and
    unequal in-plane scales."""
    if "window" not in _cache:
        verts, faces = MESHES["random"]
        vc = np.random.default_rng(8).uniform(0, 1, (len(verts), 3)).astype(np.float32)
        imgs = targets(3)
        jlogs, tlogs = [], []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JB, "init_bound_params", unequal_scales(JB.init_bound_params, jnp.asarray))
            mp.setattr(B, "init_bound_params", unequal_scales(B.init_bound_params, torch.as_tensor))
            with pltpu.force_tpu_interpret_mode():
                jp, _ = jtrainer.refined_training(
                    verts, faces, vc, [camera()] * 3, imgs, 2.0,
                    jtrainer.RefineConfig(render_mode="pallas", **WINDOW), seed=2,
                    log_fn=jlogs.append)
            tp, tbm = trainer.refined_training(verts, faces, vc, [camera("cpu")] * 3, imgs, 2.0,
                                               trainer.RefineConfig(**WINDOW), seed=2,
                                               log_fn=tlogs.append, device="cpu")
        _cache["window"] = (jp, jlogs, tp, tlogs)
    return _cache["window"]


def test_refined_training_window_matches_jax():
    jp, jlogs, tp, tlogs = window_runs()
    jl = [r["loss"] for r in jlogs if "loss" in r]
    tl = [r["loss"] for r in tlogs if "loss" in r]
    assert len(tl) == len(jl) == 5
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    assert not any(r.get("event") == "cap_grow" for r in tlogs + jlogs)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), rtol=0,
                                   atol=1e-4, err_msg=f)


def refine_run(iters, ckpt_dir=None, milestones=()):
    verts, faces = MESHES["random"]
    cfg = trainer.RefineConfig(**dict(WINDOW, num_iterations=iters,
                                      checkpoint_iterations=milestones))
    return trainer.refined_training(verts, faces, None, [camera("cpu")] * 3, targets(3), 2.0, cfg,
                                    seed=1, checkpoint_dir=ckpt_dir, device="cpu")


def test_refine_kill_and_resume_bit_exact_on_cpu(tmp_path, one_thread):
    """tests/test_checkpoint.py:133-170 for the port: a run killed at the
    milestone and resumed from it ends bit-equal to the uninterrupted one."""
    full, _ = refine_run(6)
    ckpt_dir = str(tmp_path / "refine")
    refine_run(3, ckpt_dir=ckpt_dir, milestones=(3,))
    logs = []
    verts, faces = MESHES["random"]
    resumed, _ = trainer.refined_training(
        verts, faces, None, [camera("cpu")] * 3, targets(3), 2.0,
        trainer.RefineConfig(**dict(WINDOW, num_iterations=6, checkpoint_iterations=(3,))),
        seed=1, checkpoint_dir=ckpt_dir, log_fn=logs.append, device="cpu")
    assert logs[0] == {"event": "resume", "iteration": 3}
    assert [r["iter"] for r in logs if "loss" in r] == [4, 5, 6]
    for f in FIELDS:
        assert torch.equal(getattr(full, f), getattr(resumed, f)), f
    assert not torch.equal(full.vertices, torch.as_tensor(verts))  # the run moved the mesh


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_refined_ply_round_trip(tmp_path, writer):
    (jp, jbm), (tp, tbm) = both("random", 3)
    path = str(tmp_path / "refined.ply")
    if writer == "port":
        trainer.export_refined_ply(tp, tbm, path)
    else:
        jtrainer.export_refined_ply(jp, jbm, path)
    jd, td = jply.load_gaussian_ply(path), ply.load_gaussian_ply(path)
    for k in jd:
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    # What was written is the writer's to_gaussian_arrays; the two packages'
    # arrays agree within 1e-6 (log-scales 1e-5: the log of 2e-6 thickness).
    arrs = JB.to_gaussian_arrays(jp, jbm)
    np.testing.assert_allclose(td["xyz"], np.asarray(arrs["centers"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(td["quaternions"], np.asarray(arrs["quaternions"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(td["log_scales"],
                               np.log(np.maximum(np.asarray(arrs["scales"]), 1e-10)), atol=1e-5,
                               rtol=0)
    assert td["sh_rest"].shape == (len(jp.opacity_logit), 3, 3)
    model = load_ply(path, device="cpu")
    assert int(model.alive.sum()) == len(jp.opacity_logit) and model.sh_degree == SH_DEGREE


def test_load_refined_state_renders_as_jax(tmp_path):
    """The pickle sugar_tpu/pipeline.py:295-312 writes (numpy arrays, an
    int and a float) loads into the port and renders JAX's image."""
    (jp, jbm), _ = both("random", 4)
    path = str(tmp_path / "refined_state.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(vertices=np.asarray(jp.vertices), faces=np.asarray(jbm.faces),
                         log_scales=np.asarray(jp.log_scales),
                         complex_rot=np.asarray(jp.complex_rot),
                         opacity_logit=np.asarray(jp.opacity_logit), sh_dc=np.asarray(jp.sh_dc),
                         sh_rest=np.asarray(jp.sh_rest), n_per_triangle=jbm.n_per_triangle,
                         thickness=float(jbm.thickness)), f)
    tp, tbm = trainer.load_refined_state(path, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    assert tbm.n_per_triangle == 4 and tbm.faces.dtype == torch.int64
    dup = 8 * len(jbm.faces) * 4
    with pltpu.force_tpu_interpret_mode():
        jimg = jax.jit(lambda p: jtrainer.render_bound(p, jbm, camera(), SH_DEGREE, jnp.zeros(3),
                                                       dup, mode="pallas", **CAPS)["image"])(jp)
    timg = trainer.render_bound(tp, tbm, camera("cpu"), SH_DEGREE, torch.zeros(3), dup,
                                **CAPS)["image"]
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=1e-5, rtol=0)
    assert float(timg.max()) > 0.1


def test_bound_adam_from_numpy():
    d, _, _ = state_np("random", 1)
    st = bound_adam_from_numpy(d, {k: v * 2 for k, v in d.items()}, 7, device="cpu")
    assert int(st.count) == 7 and st.count.dtype == torch.int32
    np.testing.assert_array_equal(st.nu.vertices.numpy(), 2 * d["vertices"])
    with pytest.raises(KeyError):
        bound_from_numpy({k: v for k, v in d.items() if k != "sh_dc"}, np.zeros((1, 3)), 1, 1e-6,
                         device="cpu")
