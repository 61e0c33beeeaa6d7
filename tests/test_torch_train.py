"""The port's training modules against the JAX package: LR schedule, Adam,
camera schedule, densify statistics, point-cloud init, densify and prune
(with the JAX split noise injected), opacity reset, and one whole train
step (render_mode="pallas", Pallas kernels in interpret mode on the CPU).

Tolerances: float32 elementwise results rtol 1e-6; gradients 2e-5 *
max|g| + 1e-9 (tests/test_pallas.py:84-88); masks, counts, camera order
exactly equal. Adam with eps 1e-15 moves a parameter by about lr * sign(g)
on a first step, so where |g| is within the gradient tolerance of 0 the
two packages may step in opposite directions: there the new params are
held to 2 * lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_render import CAM, model_arrays
from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.models import densifier as jdens
from sugar_tpu.models import gaussians as jgm
from sugar_tpu.raster import adaptive as jadaptive
from sugar_tpu.trainers import optimizer as jopt
from sugar_tpu.trainers import schedule as jsched
from sugar_tpu.trainers import vanilla as jvan
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.interop import adam_from_numpy, model_from_numpy, params_from_numpy
from sugar_tpu_torch.interop import stats_from_numpy
from sugar_tpu_torch.models import densifier as dens
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS, create_from_pcd
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.trainers import vanilla
from sugar_tpu_torch.trainers.schedule import CameraSchedule, iteration_generator

torch.set_num_threads(2)


def np_fields(p):
    return {f: np.asarray(getattr(p, f)) for f in PARAM_FIELDS}


def t_fields(p):
    return {f: getattr(p, f).detach().numpy() for f in PARAM_FIELDS}


@pytest.mark.parametrize("delay", [0, 100])
def test_expon_lr_schedule_matches_jax(delay):
    j = jopt.expon_lr_schedule(1.6e-4, 1.6e-6, 3000, lr_delay_steps=delay, lr_delay_mult=0.01)
    t = opt.expon_lr_schedule(1.6e-4, 1.6e-6, 3000, lr_delay_steps=delay, lr_delay_mult=0.01)
    for step in (0, 1, 50, 100, 1500, 2999, 3000, 5000):
        np.testing.assert_allclose(float(t(step)), float(j(step)), rtol=1e-6)
    assert float(opt.expon_lr_schedule(0.0, 0.0, 10)(3)) == 0.0


def test_group_lrs_match_jax():
    cfg = opt.OptimConfig()
    j = jopt.group_lrs(jopt.OptimConfig(), spatial_lr_scale=2.5)
    t = opt.group_lrs(cfg, spatial_lr_scale=2.5)
    assert set(t) == set(j) == set(PARAM_FIELDS)
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(float(t[k](700)), float(j[k](700)), rtol=1e-6)


def test_adam_three_steps_match_jax():
    d, _ = model_arrays(n=40, capacity=48)
    g = np.random.default_rng(2)
    grads = {k: g.normal(0, 0.1, v.shape).astype(np.float32) for k, v in d.items()}
    jl = jopt.group_lrs(jopt.OptimConfig(), 1.0)
    tl = opt.group_lrs(opt.OptimConfig(), 1.0)
    jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})
    js = jopt.init_adam(jp)
    tp = params_from_numpy(d, device="cpu")
    ts = opt.init_adam(tp)
    jg = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in grads.items()})
    tg = params_from_numpy(grads, device="cpu")
    for it in range(3):
        jp, js = jopt.adam_step(jp, jg, js, jnp.asarray(it), jl, jopt.OptimConfig())
        tp, ts = opt.adam_step(tp, tg, ts, it, tl, opt.OptimConfig())
    assert int(ts.count) == int(js.count) == 3
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(t_fields(tp)[k], np_fields(jp)[k], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(t_fields(ts.mu)[k], np_fields(js.mu)[k], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(t_fields(ts.nu)[k], np_fields(js.nu)[k], rtol=1e-6, atol=1e-12)


def test_camera_schedule_matches_jax():
    j, t = jsched.CameraSchedule(7, 6), CameraSchedule(7, 6)
    order = [t.index(i) for i in range(50)]
    assert order == [j.index(i) for i in range(50)]
    assert t.index(3) == order[3]  # replaying an earlier epoch


def test_iteration_generator_is_pure():
    a = torch.randn(5, generator=iteration_generator(3, 100, "cpu"))
    b = torch.randn(5, generator=iteration_generator(3, 100, "cpu"))
    c = torch.randn(5, generator=iteration_generator(3, 101, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_update_stats_matches_jax():
    g = np.random.default_rng(3)
    n = 64
    base = [g.uniform(0, 1, n).astype(np.float32) for _ in range(3)]
    ndc = g.normal(0, 1e-3, (n, 2)).astype(np.float32)
    radii = g.integers(0, 30, n).astype(np.int32)
    js = jdens.update_stats(jdens.DensifyStats(*map(jnp.asarray, base)), jnp.asarray(ndc),
                            jnp.asarray(radii))
    ts = dens.update_stats(stats_from_numpy(*base, device="cpu"), torch.tensor(ndc),
                           torch.tensor(radii))
    np.testing.assert_allclose(ts.grad_accum.numpy(), np.asarray(js.grad_accum), rtol=1e-6)
    np.testing.assert_array_equal(ts.denom.numpy(), np.asarray(js.denom))
    np.testing.assert_array_equal(ts.max_radii.numpy(), np.asarray(js.max_radii))


def test_create_from_pcd_matches_jax():
    g = np.random.default_rng(4)
    pts = g.normal(size=(90, 3)).astype(np.float32)
    cols = g.uniform(0, 1, (90, 3)).astype(np.float32)
    j = jgm.create_from_pcd(pts, cols, 128, sh_degree=2)
    t = create_from_pcd(pts, cols, 128, sh_degree=2, device="cpu")
    assert t.sh_degree == 2 and t.capacity == 128
    np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(t_fields(t.params)[k], np_fields(j.params)[k], rtol=1e-6)
    with pytest.raises(ValueError):
        create_from_pcd(pts, cols, 64, device="cpu")


def densify_scene(capacity, n_alive, seed):
    """A model with clone and split candidates, low-opacity and oversized
    Gaussians, random Adam moments and random stats."""
    g = np.random.default_rng(seed)
    d, alive = model_arrays(n=n_alive, capacity=capacity, seed=seed)
    d["log_scales"][:n_alive] = np.log(g.uniform(0.003, 0.035, (n_alive, 3))).astype(np.float32)
    d["log_scales"][:3] = np.log(0.3)  # world-size prune
    d["opacity_logit"][3:6] = -6.0  # opacity prune
    mu = {k: g.normal(0, 1e-3, v.shape).astype(np.float32) for k, v in d.items()}
    nu = {k: g.uniform(1e-6, 1e-5, v.shape).astype(np.float32) for k, v in d.items()}
    stats = (np.where(alive, g.uniform(0, 8e-3, capacity), 0).astype(np.float32),
             np.where(alive, g.integers(1, 20, capacity), 0).astype(np.float32),
             np.where(alive, g.uniform(0, 40, capacity), 0).astype(np.float32))
    return d, alive, mu, nu, stats


@pytest.mark.parametrize("case", ["roomy", "full"])
def test_densify_and_prune_matches_jax(case):
    capacity, n_alive = (96, 40) if case == "roomy" else (48, 40)
    d, alive, mu, nu, stats = densify_scene(capacity, n_alive, seed=5)
    kw = dict(grad_threshold=2e-4, min_opacity=0.005, max_screen_size=20.0, percent_dense=0.01)
    jm = jgm.GaussianModel(jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()}),
                           jnp.asarray(alive), 3)
    ja = jopt.AdamState(mu=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
                        nu=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in nu.items()}),
                        count=jnp.asarray(7, jnp.int32))
    key = jsched.iteration_key(0, 100)
    jm2, ja2, js2, jinfo = jdens.densify_and_prune(
        jm, ja, jdens.DensifyStats(*map(jnp.asarray, stats)), key, 2.0, **kw)
    # The JAX draw, rebuilt as densify_and_prune makes it.
    draws, rng = [], key
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        draws.append(np.asarray(jax.random.normal(sub, (capacity, 3))))
    tm2, ta2, ts2, tinfo = dens.densify_and_prune(
        model_from_numpy(d, alive, 3, device="cpu"), adam_from_numpy(mu, nu, 7, device="cpu"),
        stats_from_numpy(*stats, device="cpu"), torch.tensor(np.stack(draws)), 2.0, **kw)

    info = {k: int(v) for k, v in tinfo.items()}
    assert info == {k: int(v) for k, v in jinfo.items()}
    assert info["n_cloned"] > 0 and info["n_split"] > 0 and info["n_pruned"] > info["n_split"]
    assert (info["n_dropped"] > 0) == (case == "full")
    np.testing.assert_array_equal(tm2.alive.numpy(), np.asarray(jm2.alive))
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(t_fields(tm2.params)[k], np_fields(jm2.params)[k],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(t_fields(ta2.mu)[k], np_fields(ja2.mu)[k])
        np.testing.assert_array_equal(t_fields(ta2.nu)[k], np_fields(ja2.nu)[k])
    assert float(ts2.grad_accum.abs().max()) == 0.0 and int(ta2.count) == 7


def test_densify_refuses_wrong_noise():
    d, alive, mu, nu, stats = densify_scene(48, 40, seed=6)
    with pytest.raises(ValueError, match="noise"):
        dens.densify_and_prune(model_from_numpy(d, alive, 3, device="cpu"),
                               adam_from_numpy(mu, nu, 1, device="cpu"),
                               stats_from_numpy(*stats, device="cpu"),
                               torch.zeros((2, 10, 3)), 2.0)


def test_reset_opacity_and_prune_match_jax():
    d, alive, mu, nu, _ = densify_scene(48, 40, seed=7)
    jm = jgm.GaussianModel(jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()}),
                           jnp.asarray(alive), 3)
    ja = jopt.AdamState(mu=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
                        nu=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in nu.items()}),
                        count=jnp.asarray(3, jnp.int32))
    jm2, ja2 = jdens.reset_opacity(jm, ja)
    tm2, ta2 = dens.reset_opacity(model_from_numpy(d, alive, 3, device="cpu"),
                                  adam_from_numpy(mu, nu, 3, device="cpu"))
    np.testing.assert_allclose(tm2.params.opacity_logit.numpy(),
                               np.asarray(jm2.params.opacity_logit), rtol=1e-6)
    assert float(ta2.mu.opacity_logit.abs().max()) == 0.0
    np.testing.assert_array_equal(ta2.nu.xyz.numpy(), np.asarray(ja2.nu.xyz))
    tp = dens.prune_low_opacity(tm2, 0.5)
    jp = jdens.prune_low_opacity(jm2, 0.5)
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive))


_step = {}


def train_step_pair():
    """One train step of each package from the same state (fresh Adam,
    zero stats) on the padded SH-3 model, at iteration 5."""
    if not _step:
        d, alive = model_arrays()
        n = alive.shape[0]
        gt = np.random.default_rng(8).uniform(0, 1, (CAM["height"], CAM["width"], 3))
        gt = gt.astype(np.float32)
        caps = dict(tile_cap=16, dup_capacity=8192, k_max=512)
        jcfg = jvan.TrainConfig(sh_degree=3, capacity=n, render_mode="pallas")
        jstep = jvan.make_train_step(jcfg, jopt.group_lrs(jcfg.optim, 2.0), 3,
                                     jadaptive.RasterCaps(**caps))
        jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})
        with pltpu.force_tpu_interpret_mode():
            out = jstep(jp, jnp.asarray(alive), jopt.init_adam(jp), jdens.DensifyStats.zeros(n),
                        jmake_camera(**CAM), jnp.asarray(gt), jnp.asarray(5, jnp.int32))
        jax.block_until_ready(out)

        tcfg = vanilla.TrainConfig(sh_degree=3, capacity=n)
        tstep = vanilla.make_train_step(tcfg, opt.group_lrs(tcfg.optim, 2.0), 3,
                                        adaptive.RasterCaps(**caps))
        tp = params_from_numpy(d, device="cpu")
        tout = tstep(tp, torch.tensor(alive), opt.init_adam(tp), dens.DensifyStats.zeros(n, "cpu"),
                     make_camera(**CAM, device="cpu"), torch.tensor(gt), 5)
        _step.update(jax=out, port=tout, params=d, alive=alive, lrs=opt.group_lrs(tcfg.optim, 2.0))
    return _step


def test_train_step_loss_and_aux_match_jax():
    s = train_step_pair()
    jaux, taux = s["jax"][3], s["port"][3]
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(taux["psnr"]), float(jaux["psnr"]), rtol=1e-5)
    np.testing.assert_array_equal(taux["radii"].numpy(), np.asarray(jaux["radii"]))
    assert adaptive.read_overflow(taux) == jadaptive.read_overflow(jaux)


@pytest.mark.parametrize("field", PARAM_FIELDS)
def test_train_step_gradients_and_adam_match_jax(field):
    s = train_step_pair()
    jadam, tadam = s["jax"][1], s["port"][1]
    # After one step from zero moments, mu = 0.1 g and nu = 0.001 g^2.
    jg = np.asarray(getattr(jadam.mu, field)) / 0.1
    tg = getattr(tadam.mu, field).numpy() / 0.1
    tol = 2e-5 * max(float(np.abs(jg).max()), 1e-8) + 1e-9
    np.testing.assert_allclose(tg, jg, atol=tol, rtol=0)
    jnu = np.asarray(getattr(jadam.nu, field))
    np.testing.assert_allclose(getattr(tadam.nu, field).numpy(), jnu,
                               atol=2 * tol * 1e-3 * float(np.abs(jg).max()) + 1e-18, rtol=0)
    assert int(tadam.count) == int(jadam.count) == 1

    lr = float(s["lrs"][field](5))
    jp = np.asarray(getattr(s["jax"][0], field))
    tp = getattr(s["port"][0], field).numpy()
    near_zero = np.abs(jg) <= tol
    np.testing.assert_allclose(tp[~near_zero], jp[~near_zero], rtol=1e-6, atol=1e-3 * lr)
    assert np.all(np.abs(tp[near_zero] - jp[near_zero]) <= 2 * lr * (1 + 1e-5))
    assert np.array_equal(tp[~s["alive"]], s["params"][field][~s["alive"]])  # dead slots stay


def test_train_step_stats_match_jax():
    s = train_step_pair()
    js, ts = s["jax"][2], s["port"][2]
    g = np.asarray(js.grad_accum)
    np.testing.assert_allclose(ts.grad_accum.numpy(), g, atol=2e-5 * float(g.max()) + 1e-9, rtol=0)
    np.testing.assert_array_equal(ts.denom.numpy(), np.asarray(js.denom))
    np.testing.assert_array_equal(ts.max_radii.numpy(), np.asarray(js.max_radii))
    assert float(g.max()) > 0.0


def test_trainer_refuses_unported_options():
    """The name dates from when the port refused render_mode="tiled"; it
    is kept so that the test's history reads on. Nothing is refused any
    more: the tiled mode trains. One step matches the JAX package's tiled
    step (loss, radii, counters, the gradients of every field), and the
    trainer's loop runs two iterations in it."""
    d, alive = model_arrays()
    n = alive.shape[0]
    gt = np.random.default_rng(9).uniform(0, 1, (CAM["height"], CAM["width"], 3))
    gt = gt.astype(np.float32)
    caps = dict(tile_cap=16, dup_capacity=8192, k_max=512)
    jcfg = jvan.TrainConfig(sh_degree=3, capacity=n, render_mode="tiled")
    jstep = jvan.make_train_step(jcfg, jopt.group_lrs(jcfg.optim, 2.0), 3,
                                 jadaptive.RasterCaps(**caps))
    jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})
    jout = jstep(jp, jnp.asarray(alive), jopt.init_adam(jp), jdens.DensifyStats.zeros(n),
                 jmake_camera(**CAM), jnp.asarray(gt), jnp.asarray(5, jnp.int32))
    tcfg = vanilla.TrainConfig(sh_degree=3, capacity=n, render_mode="tiled")
    tstep = vanilla.make_train_step(tcfg, opt.group_lrs(tcfg.optim, 2.0), 3,
                                    adaptive.RasterCaps(**caps))
    tp = params_from_numpy(d, device="cpu")
    tout = tstep(tp, torch.tensor(alive), opt.init_adam(tp), dens.DensifyStats.zeros(n, "cpu"),
                 make_camera(**CAM, device="cpu"), torch.tensor(gt), 5)
    jaux, taux = jout[3], tout[3]
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(taux["radii"].numpy(), np.asarray(jaux["radii"]))
    assert adaptive.read_overflow(taux) == jadaptive.read_overflow(jaux)
    for field in PARAM_FIELDS:
        jg = np.asarray(getattr(jout[1].mu, field)) / 0.1
        tg = getattr(tout[1].mu, field).numpy() / 0.1
        np.testing.assert_allclose(tg, jg, atol=2e-5 * max(float(np.abs(jg).max()), 1e-8) + 1e-9,
                                   rtol=0, err_msg=field)

    cfg = vanilla.TrainConfig(iterations=2, capacity=64, sh_degree=0, render_mode="tiled",
                              k_max=64, log_every=1)
    pts = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32) + [0, 0, 3]
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, 16, 16, device="cpu")
    logs = []
    vanilla.train_vanilla_3dgs([cam], [np.zeros((16, 16, 3), np.float32)], pts,
                               np.zeros((4, 3), np.float32), 1.0, cfg, log_fn=logs.append,
                               device="cpu")
    losses = [e["loss"] for e in logs if "loss" in e]
    assert len(losses) == 2 and all(np.isfinite(losses))


def _cap_grow_records(logs):
    """(iteration checked, old caps, new caps, counters read) of each
    ``cap_grow`` record; with ``log_every=1`` the record of iteration ``it``
    follows the log line of ``iter == it``."""
    out, it = [], None
    for e in logs:
        it = e.get("iter", it)
        if e.get("event") == "cap_grow":
            out.append((it, e["old"], e["new"], e["overflow"]))
    return out


def test_trainer_cap_growth_matches_jax():
    """Both packages' vanilla loops, in the tiled mode, from iteration 5 on
    80 cameras at a 64-slot duplication capacity: the lagged check grows the
    caps at the same iterations to the same caps. With every learning rate 0
    the counters depend on the camera alone. The far cameras overflow from
    the start: step 5 is read at 6 and step 6, still at the old caps, at 7,
    so the caps grow twice (the JAX package's double growth). The near
    cameras come at steps 63 and 69, after the 50 hot iterations: step 63's
    overflow falls between the every-10th checks and is missed, step 69's is
    read at 70."""
    seed, start, stop, hw = 0, 5, 85, 64
    sched = CameraSchedule(seed, 80)
    near = {sched.index(63), sched.index(69)}
    g = np.random.default_rng(9)
    pts = (g.normal(size=(60, 3)) * 0.5).astype(np.float32)
    cols = g.uniform(0.2, 1.0, (60, 3)).astype(np.float32)
    poses = [(np.eye(3), np.array([0.0, 0.0, 3.0 if i in near else 12.0]),
              *((0.5, 0.5) if i in near else (1.2, 1.2)), hw, hw) for i in range(80)]
    gts = [np.zeros((hw, hw, 3), np.float32)] * 80
    zero = dict(position_lr_init=0.0, position_lr_final=0.0, feature_lr=0.0, opacity_lr=0.0,
                scaling_lr=0.0, rotation_lr=0.0)
    cfg = dict(iterations=stop, capacity=64, sh_degree=0, dup_capacity_mult=1, k_max=64,
               log_every=1, render_mode="tiled")
    jlogs, tlogs = [], []
    jvan.train_vanilla_3dgs([jmake_camera(*p) for p in poses], gts, pts, cols, 2.0,
                            jvan.TrainConfig(**cfg, optim=jopt.OptimConfig(**zero)),
                            seed=seed, log_fn=jlogs.append, start_iteration=start)
    vanilla.train_vanilla_3dgs([make_camera(*p, device="cpu") for p in poses], gts, pts, cols,
                               2.0, vanilla.TrainConfig(**cfg, optim=opt.OptimConfig(**zero)),
                               seed=seed, log_fn=tlogs.append, start_iteration=start,
                               device="cpu")

    got, want = _cap_grow_records(tlogs), _cap_grow_records(jlogs)
    assert got == want
    assert [(it, old["dup_capacity"], new["dup_capacity"]) for it, old, new, _ in got] == [
        (6, 64, 512), (7, 512, 768), (70, 768, 1280)]

    def overflowing(logs):
        return [(e["iter"], e["bin_overflow"], e["tile_overflow"])
                for e in logs if "iter" in e and e["bin_overflow"]]

    assert overflowing(tlogs) == overflowing(jlogs)
    assert [it for it, _, _ in overflowing(tlogs)] == [6, 7, 64, 70]


def test_train_vanilla_3dgs_on_cpu_fits_and_densifies():
    """A short CPU run through the whole loop: densify and reset each run,
    the loss falls before the reset, every output is finite."""
    g = np.random.default_rng(9)
    pts = (g.normal(size=(60, 3)) * 0.5).astype(np.float32)
    cols = g.uniform(0.2, 1.0, (60, 3)).astype(np.float32)
    cams = []
    for i in range(3):
        th = 2 * np.pi * i / 3
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        T = -R.T @ (-R @ np.array([0.0, 0.0, 4.0]))
        cams.append(make_camera(R, T, 1.0, 1.0, 32, 32, device="cpu"))
    target = create_from_pcd(pts, cols, 128, sh_degree=0, initial_opacity=0.9, device="cpu")
    from sugar_tpu_torch.models.render import render_model

    gts = [torch.clamp(render_model(target, c, dup_capacity=4096, k_max=256)["image"], 0, 1)
           for c in cams]
    cfg = vanilla.TrainConfig(
        iterations=24, capacity=128, sh_degree=0, densify_from=8, densify_every=8,
        opacity_reset_every=16, dup_capacity_mult=16, k_max=256, log_every=4,
        optim=opt.OptimConfig(feature_lr=0.05, opacity_lr=0.1),
    )
    logs = []
    st = vanilla.train_vanilla_3dgs(cams, gts, pts, np.full((60, 3), 0.5, np.float32), 2.0, cfg,
                                    log_fn=logs.append, device="cpu")
    losses = [r["loss"] for r in logs if "loss" in r]
    assert losses[3] < losses[0]  # iterations 4 -> 16, before the reset
    assert any("n_split" in r for r in logs) and any(r.get("event") == "opacity_reset" for r in logs)
    assert all(r.get("bin_overflow", 0) == 0 for r in logs)
    for f in PARAM_FIELDS:
        assert torch.isfinite(getattr(st.model.params, f)).all()
    assert st.iteration == 24 and dataclasses.is_dataclass(st.adam)
