"""The port's coarse SuGaR stage against the JAX package: ``coarse_loss``
in each phase (entropy only, SDF in 'sdf' mode, 'density' mode), one
``make_coarse_step`` with Adam, a ``train_coarse`` run over the entropy ->
prune -> KNN-refresh window (loss trajectory rtol 2e-5, final params rtol
1e-5 / atol 1e-6), and kill-and-resume of the port on the CPU.

Both packages get the same numpy inputs: a 64-Gaussian sphere in 128 slots,
32x32 ring cameras, the JAX package's KNN table and the JAX package's
sample draw (its categorical idx, recorded with ``jax.debug.callback``,
and its normal noise, redrawn from the same key), fed to the port as
``(idx, noise)``. The JAX renders run ``render_mode="pallas"`` with the
Pallas kernels in interpret mode.

The JAX ``coarse_loss`` in 'density' mode raises KeyError('beta'): it calls
``field_values(return_sdf=False)``, which computes no beta (ROADMAP.md,
queue 3). The port asks for beta (``return_beta=True``, as SuGaR's
coarse_density.py does); the comparison runs the JAX loss with its
``field_values`` patched to compute the sdf as well, which the density
branch does not read.

Tolerances: loss and PSNR rtol 1e-5; gradients 2e-5 * max|g| + 1e-9
(tests/test_pallas.py:84-88); sampling masks, visible counts, overflow
counters and alive masks exactly equal. After a step, params where |g| is
within the gradient tolerance of 0 are held to 2 * lr (Adam with eps
1e-15 moves them by ~lr * sign(g)), as in tests/test_torch_train.py.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_io import one_thread  # noqa: F401  (fixture)
from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.fields import density as jdf
from sugar_tpu.fields.knn import knn as jknn
from sugar_tpu.models import gaussians as jgm
from sugar_tpu.raster import adaptive as jadaptive
from sugar_tpu.trainers import coarse as jcoarse
from sugar_tpu.trainers import optimizer as jopt
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.fields import density as df
from sugar_tpu_torch.interop import knn_table_from_numpy, model_from_numpy, params_from_numpy
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.trainers import coarse
from sugar_tpu_torch.trainers import optimizer as opt

torch.set_num_threads(2)

HW = 32
N, CAPACITY, K = 64, 128, 16
N_SAMPLES = 2000
EXTENT = 2.0
CAPS = dict(tile_cap=16, dup_capacity=4096, k_max=256)


def ring(n_cams=5):
    """(R, T) of cameras on a ring around the origin, looking at it."""
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


def cams(device=None):
    kw = dict(fov_x=0.8, fov_y=0.8, height=HW, width=HW)
    if device is None:
        return [jmake_camera(R=r, T=t, **kw) for r, t in ring()]
    return [make_camera(R=r, T=t, device=device, **kw) for r, t in ring()]


def scene(seed=0):
    """Raw fields of a 64-Gaussian sphere of flattened Gaussians in 128
    slots (JAX padding), SH degree 0; opacities 0.1-0.35 or 0.65-0.95 (the
    prune at 0.5 has a clear margin); and the target images."""
    g = np.random.default_rng(seed)
    d = g.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    quats = g.normal(size=(N, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = np.where(g.uniform(size=N) < 0.3, g.uniform(0.1, 0.35, N), g.uniform(0.65, 0.95, N))
    s = g.uniform(0.06, 0.12, N)
    f = dict(
        xyz=0.7 * d,
        sh_dc=(0.4 + 0.6 * np.abs(d) - 0.5) / 0.28209479177387814,
        sh_rest=np.zeros((N, 3, 0)),
        opacity_logit=np.log(opac / (1 - opac)),
        log_scales=np.log(np.stack([s, s * g.uniform(0.6, 1.0, N), s * 0.15], -1)),
        quaternions=quats,
    )
    fill = dict(opacity_logit=-10.0, log_scales=-10.0)
    for k, v in f.items():
        pad = np.full((CAPACITY - N,) + v.shape[1:], fill.get(k, 0.0))
        f[k] = np.concatenate([v, pad]).astype(np.float32)
    f["quaternions"][N:, 0] = 1.0
    alive = np.arange(CAPACITY) < N
    imgs = [g.uniform(0, 1, (HW, HW, 3)).astype(np.float32) for _ in range(5)]
    return f, alive, imgs


def jparams(f):
    return jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in f.items()})


@contextlib.contextmanager
def patched(module, name, fn):
    orig = getattr(module, name)
    setattr(module, name, fn(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def jax_density_beta(orig):
    """The JAX field_values with the sdf (and so beta) always computed."""
    return lambda *a, **kw: orig(*a, **dict(kw, return_sdf=True))


_cache = {}


def loss_pair(phase):
    """(JAX, port) coarse_loss values, aux and gradients for one phase,
    with the recorded sampling masks and the JAX draw."""
    if phase in _cache:
        return _cache[phase]
    f, alive, imgs = scene()
    mode = "density" if phase == "density" else "sdf"
    with_entropy, with_sdf = phase == "entropy", phase != "entropy"
    cfg = dict(mode=mode, n_samples_for_sdf_regularization=N_SAMPLES, sh_degree=0,
               k_max=CAPS["k_max"])
    _, jidx = jknn(jnp.asarray(f["xyz"]), jnp.asarray(f["xyz"]), k=K, ref_mask=jnp.asarray(alive))
    key = jax.random.PRNGKey(11)
    rec = {}

    def record_jax(orig):
        def sampler(rng, num, gp, mask, **kw):
            pts, idx = orig(rng, num, gp, mask, **kw)
            jax.debug.callback(lambda i, m: rec.update(idx=np.asarray(i), jmask=np.asarray(m)),
                               idx, mask)
            return pts, idx
        return sampler

    jcfg = jcoarse.CoarseConfig(**cfg)

    def jloss(p):
        return jcoarse.coarse_loss(jcfg, p, jnp.asarray(alive), jidx, cams()[1],
                                   jnp.asarray(imgs[1]), key, EXTENT, CAPS["dup_capacity"],
                                   with_entropy, with_sdf, render_mode="pallas",
                                   k_max=CAPS["k_max"], tile_cap=CAPS["tile_cap"])

    density_patch = (patched(jdf, "field_values", jax_density_beta) if mode == "density"
                     else contextlib.nullcontext())
    with patched(jdf, "sample_points_in_gaussians", record_jax), density_patch, \
            pltpu.force_tpu_interpret_mode():
        (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams(f))
        jax.block_until_ready(jg)

    draw = None
    if with_sdf:
        noise = np.asarray(jax.random.normal(jax.random.split(key)[1], (N_SAMPLES, 3)))
        draw = (torch.tensor(rec["idx"]), torch.tensor(noise))

    def record_port(orig):
        def sampler(d, num, gp, mask, **kw):
            rec["tmask"] = mask.numpy().copy()
            return orig(d, num, gp, mask, **kw)
        return sampler

    tp = params_from_numpy(f, device="cpu")
    leaves = [getattr(tp, k).requires_grad_(True) for k in PARAM_FIELDS]
    with patched(df, "sample_points_in_gaussians", record_port):
        tl, taux = coarse.coarse_loss(
            coarse.CoarseConfig(**cfg), tp, torch.tensor(alive),
            knn_table_from_numpy(np.asarray(jidx), device="cpu"), cams("cpu")[1],
            torch.tensor(imgs[1]), draw, EXTENT, CAPS["dup_capacity"], with_entropy, with_sdf,
            k_max=CAPS["k_max"], tile_cap=CAPS["tile_cap"])
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    _cache[phase] = dict(
        jax=(float(jl), jaux, {k: np.asarray(getattr(jg, k)) for k in PARAM_FIELDS}),
        port=(float(tl.detach()), taux, {k: np.zeros_like(f[k]) if g is None else g.numpy()
                                for k, g in zip(PARAM_FIELDS, tg)}),
        rec=rec,
    )
    return _cache[phase]


PHASES = ["entropy", "sdf", "density"]


@pytest.mark.parametrize("phase", PHASES)
def test_coarse_loss_matches_jax(phase):
    s = loss_pair(phase)
    (jl, jaux, _), (tl, taux, _) = s["jax"], s["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(float(taux["psnr"]), float(jaux["psnr"]), rtol=1e-5)
    assert int(taux["n_visible"]) == int(jaux["n_visible"]) > 0
    assert adaptive.read_overflow(taux) == jadaptive.read_overflow(jaux)
    if phase != "entropy":
        rec = s["rec"]
        np.testing.assert_array_equal(rec["tmask"], rec["jmask"])
        n_mask = int(rec["jmask"].sum())
        assert 0 < n_mask < N if phase == "sdf" else n_mask > 0  # 'sdf' masks to the surface
        assert rec["jmask"][rec["idx"]].all()


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("field", [f for f in PARAM_FIELDS if f != "sh_rest"])
def test_coarse_loss_gradients_match_jax(phase, field):
    s = loss_pair(phase)
    jg, tg = s["jax"][2][field], s["port"][2][field]
    tol = 2e-5 * float(np.abs(jg).max()) + 1e-9
    np.testing.assert_allclose(tg, jg, atol=tol, rtol=0)
    assert float(np.abs(jg).max()) > 0
    assert np.all(tg[N:] == 0)  # dead slots get no gradient


def test_jax_density_mode_computes_no_beta():
    """The fault the density comparison patches around (ROADMAP.md, queue 3)."""
    f, alive, _ = scene()
    gp = jdf.GaussianFieldParams(jnp.asarray(f["xyz"]), jnp.exp(jnp.asarray(f["log_scales"])),
                                 jnp.asarray(f["quaternions"]), jnp.full((CAPACITY,), 0.5))
    idx = jnp.zeros((4, K), jnp.int32)
    out = jdf.field_values(jnp.asarray(f["xyz"][:4]), idx, gp, return_sdf=False, chunk=8)
    assert "beta" not in out
    t = df.field_values(torch.tensor(f["xyz"][:4]), torch.zeros((4, K), dtype=torch.int64),
                        df.GaussianFieldParams(*(torch.tensor(np.asarray(x)) for x in gp)),
                        return_sdf=False, return_beta=True)
    assert "beta" in t


_step = {}


def step_pair():
    """One coarse step (entropy phase, Adam from zero moments) of each
    package from the same state at iteration 7005."""
    if not _step:
        f, alive, imgs = scene()
        jcfg = jcoarse.CoarseConfig(sh_degree=0, render_mode="pallas")
        jstep = jcoarse.make_coarse_step(jcfg, jopt.group_lrs(jcfg.optim, EXTENT), EXTENT,
                                         CAPACITY, True, False, jadaptive.RasterCaps(**CAPS))
        jp = jparams(f)
        with pltpu.force_tpu_interpret_mode():
            out = jstep(jp, jnp.asarray(alive), jopt.init_adam(jp),
                        jnp.zeros((CAPACITY, K), jnp.int32), cams()[2], jnp.asarray(imgs[2]),
                        jnp.asarray(7005, jnp.int32), jax.random.PRNGKey(0))
        jax.block_until_ready(out)
        tcfg = coarse.CoarseConfig(sh_degree=0)
        lrs = opt.group_lrs(tcfg.optim, EXTENT)
        tstep = coarse.make_coarse_step(tcfg, lrs, EXTENT, CAPACITY, True, False,
                                        adaptive.RasterCaps(**CAPS))
        tp = params_from_numpy(f, device="cpu")
        tout = tstep(tp, torch.tensor(alive), opt.init_adam(tp),
                     torch.zeros((CAPACITY, K), dtype=torch.int64), cams("cpu")[2],
                     torch.tensor(imgs[2]), 7005, None)
        _step.update(jax=out, port=tout, params=f, alive=alive, lrs=lrs)
    return _step


@pytest.mark.parametrize("field", [f for f in PARAM_FIELDS if f != "sh_rest"])
def test_coarse_step_matches_jax(field):
    s = step_pair()
    jp, jadam, jaux = s["jax"]
    tp, tadam, taux = s["port"]
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
    jg = np.asarray(getattr(jadam.mu, field)) / 0.1  # mu = 0.1 g after one step
    tg = getattr(tadam.mu, field).numpy() / 0.1
    tol = 2e-5 * max(float(np.abs(jg).max()), 1e-8) + 1e-9
    np.testing.assert_allclose(tg, jg, atol=tol, rtol=0)
    assert int(tadam.count) == int(jadam.count) == 1
    lr = float(s["lrs"][field](7005))
    jv, tv = np.asarray(getattr(jp, field)), getattr(tp, field).numpy()
    near_zero = np.abs(jg) <= tol
    np.testing.assert_allclose(tv[~near_zero], jv[~near_zero], rtol=1e-6, atol=1e-3 * lr)
    assert np.all(np.abs(tv[near_zero] - jv[near_zero]) <= 2 * lr * (1 + 1e-5))
    assert np.array_equal(tv[~s["alive"]], s["params"][field][~s["alive"]])


WINDOW = dict(start_iteration=0, num_iterations=8, entropy_start=0, entropy_end=5,
              prune_at=(5,), regularize_from=1, reset_neighbors_every=3,
              start_sdf_estimation_from=100, sh_degree=0, k_max=CAPS["k_max"],
              dup_capacity_mult=32, log_every=1)


def window_runs():
    """train_coarse over the entropy -> prune -> KNN window, both packages."""
    if "window" not in _cache:
        f, alive, imgs = scene()
        jlogs, tlogs = [], []
        with pltpu.force_tpu_interpret_mode():
            jm = jcoarse.train_coarse(
                jgm.GaussianModel(jparams(f), jnp.asarray(alive), 0), cams(), imgs, EXTENT,
                jcoarse.CoarseConfig(render_mode="pallas", **WINDOW), seed=3,
                log_fn=jlogs.append)
        tm = coarse.train_coarse(model_from_numpy(f, alive, 0, device="cpu"), cams("cpu"), imgs,
                                 EXTENT, coarse.CoarseConfig(**WINDOW), seed=3,
                                 log_fn=tlogs.append)
        _cache["window"] = (jm, jlogs, tm, tlogs, f, alive)
    return _cache["window"]


def test_train_coarse_window_matches_jax():
    jm, jlogs, tm, tlogs, f, alive = window_runs()
    jl = [r["loss"] for r in jlogs if "loss" in r]
    tl = [r["loss"] for r in tlogs if "loss" in r]
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    assert [r["n_alive"] for r in tlogs if "loss" in r] == [r["n_alive"] for r in jlogs
                                                             if "loss" in r]
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(jm.alive))
    assert N > int(tm.alive.sum()) > 0  # the prune removed some, not all
    # Three KNN builds: iterations 3 and 6 (every 3rd), and after the prune.
    assert [r["iter"] for r in tlogs if r.get("event") == "knn"] == [3, 5, 6]
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(tm.params, k).numpy(), np.asarray(getattr(jm.params, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def coarse_run(imgs, model, iters, ckpt_dir=None, milestones=()):
    cfg = coarse.CoarseConfig(
        mode="sdf", start_iteration=0, num_iterations=iters, entropy_start=1, entropy_end=5,
        start_sdf_estimation_from=5, regularize_from=2, prune_at=(), sh_degree=0,
        reset_neighbors_every=4, n_samples_for_sdf_regularization=N_SAMPLES,
        k_max=CAPS["k_max"], dup_capacity_mult=16, checkpoint_iterations=milestones)
    return coarse.train_coarse(model, cams("cpu"), imgs, EXTENT, cfg, seed=0,
                               checkpoint_dir=ckpt_dir)


def test_coarse_kill_and_resume_bit_exact_on_cpu(tmp_path, one_thread):
    """tests/test_checkpoint.py:99-131 for the port: a run killed at the
    milestone and resumed from it ends bit-equal to the uninterrupted one;
    its SDF steps draw from iteration_generator."""
    f, alive, imgs = scene()
    model = model_from_numpy(f, alive, 0, device="cpu")
    full = coarse_run(imgs, model, 12)
    ckpt_dir = str(tmp_path / "coarse")
    coarse_run(imgs, model, 6, ckpt_dir=ckpt_dir, milestones=(6,))
    resumed = coarse_run(imgs, model, 12, ckpt_dir=ckpt_dir, milestones=(6,))
    for k in PARAM_FIELDS:
        assert torch.equal(getattr(full.params, k), getattr(resumed.params, k)), k
    assert torch.equal(full.alive, resumed.alive)
    assert not torch.equal(full.params.xyz, model.params.xyz)  # the run moved the model
    assert dataclasses.is_dataclass(resumed)
