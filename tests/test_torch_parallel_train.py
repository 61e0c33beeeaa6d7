"""The port's sharded vanilla steps and loop (``parallel/{train,trainer}.py``)
against the JAX package's, on the CPU (the coarse and refine steps:
tests/test_torch_parallel_coarse.py).

The port's cases run in four ``gloo`` ranks (``parallel.launch.run_ranks``
on the CPU, one intra-op thread each), started once for the module by the
``port`` fixture; the JAX side runs each step jitted on 4 of the virtual
CPU devices of tests/conftest.py, from the same numpy state. This module
imports JAX only inside its fixtures and tests, so the ranks, which import
it to find ``rank_cases``, never do.

- The (data 2, gauss 2) vanilla step and the world-4 tile-sharded step
  (JAX: ``use_kernel=False``, its pure-JAX compositor).
- ``train_vanilla_sharded`` for 12 steps of 2 views with one densify pass,
  fed the JAX loop's split noise; the loss must fall, as
  tests/test_parallel.py's ``test_sharded_loop_descends`` requires.
- The pipeline with devices=4 (``slow``, as the JAX package's multichip
  pipeline test is).

Tolerances: losses within 1e-5 x max(1, |loss|); parameters, Adam moments
and densify statistics rtol 2e-3, atol 2e-5 (tests/test_parallel.py's
1-vs-8 device tolerance).
"""

import numpy as np
import pytest
import torch

from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.interop import params_from_numpy
from sugar_tpu_torch.models import densifier as dens
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS
from sugar_tpu_torch.parallel.launch import run_ranks
from sugar_tpu_torch.parallel.mesh import make_mesh, shard_params, world_axis
from sugar_tpu_torch.trainers import optimizer as opt

torch.set_num_threads(2)

WORLD = 4
RTOL, ATOL = 2e-3, 2e-5
STEP_IT = 100
STEP_HW = 64
STEP_KW = dict(dup_capacity=2048, k_max=256)
LOOP_CFG = dict(iterations=24, capacity=64, sh_degree=0, sh_warmup_every=1, densify_from=10,
                densify_until=16, densify_every=10, densify_grad_threshold=5e-5,
                dup_capacity_mult=32, k_max=64, log_every=4)
LOOP_OPTIM = dict(feature_lr=0.05, opacity_lr=0.1)
LOOP_DENSIFY_AT = 12  # the one densify pass: after step 5 of 2 views


def ring_poses(n, hw, tilt=0.1):
    out = []
    for i in range(n):
        th = 2 * np.pi * i / n
        fwd = -np.array([np.cos(th), tilt, np.sin(th)])
        fwd /= np.linalg.norm(fwd)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        rwc = np.stack([right, np.cross(fwd, right), fwd], 0)
        out.append(dict(R=rwc.T, T=-rwc @ (-fwd * 3), fov_x=1.0, fov_y=1.0, height=hw, width=hw))
    return out


def cams(poses, device="cpu"):
    return [make_camera(device=device, **p) for p in poses]


def gather_all(tree, axis):
    from sugar_tpu_torch.parallel.mesh import gather_params

    return gather_params(tree, axis)


def _vanilla_steps(dev, s):
    from sugar_tpu_torch.parallel.train import (
        make_sharded_train_step,
        make_tile_sharded_train_step,
    )

    whole = params_from_numpy(s["fields"], dev)
    alive = torch.tensor(s["alive"], device=dev)
    lrs = opt.group_lrs(opt.OptimConfig(), spatial_lr_scale=s["extent"])
    c = cams(s["poses"], dev)
    gts = [torch.tensor(x, device=dev) for x in s["gts"]]
    out = {}
    mesh = make_mesh(2, 2, device=dev)
    step = make_sharded_train_step(mesh, lrs, opt.OptimConfig(), 1, **STEP_KW)
    p, a, st, aux = step(shard_params(whole, mesh.gauss), shard_params(alive, mesh.gauss),
                         shard_params(opt.init_adam(whole), mesh.gauss),
                         shard_params(dens.DensifyStats.zeros(64, device=dev), mesh.gauss),
                         c[:2], gts[:2], STEP_IT)
    out["2x2"] = (gather_all(p, mesh.gauss), gather_all(a, mesh.gauss),
                  gather_all(st, mesh.gauss), float(aux["loss"]))
    axis = world_axis()
    step = make_tile_sharded_train_step(axis, lrs, opt.OptimConfig(), 1, tile_cap=16,
                                        k_max=STEP_KW["k_max"])
    p, a, st, aux = step(shard_params(whole, axis), shard_params(alive, axis),
                         shard_params(opt.init_adam(whole), axis),
                         shard_params(dens.DensifyStats.zeros(64, device=dev), axis),
                         c[0], gts[0], STEP_IT)
    out["tile"] = (gather_all(p, axis), gather_all(a, axis), gather_all(st, axis),
                   float(aux["loss"]), {k: int(aux[k]) for k in
                                        ("route_overflow", "tile_overflow", "kmax_overflow")})
    return out


def _loop(dev, s):
    from sugar_tpu_torch.parallel.trainer import train_vanilla_sharded
    from sugar_tpu_torch.trainers.vanilla import TrainConfig

    logs = []
    noise = {it: torch.tensor(x, device=dev) for it, x in s["noise"].items()}
    cfg = TrainConfig(**LOOP_CFG, optim=opt.OptimConfig(**LOOP_OPTIM))
    model = train_vanilla_sharded(cams(s["poses"], dev), s["gts"], s["pts"], s["cols"], 1.5, cfg,
                                  n_data=2, n_gauss=2, log_fn=logs.append,
                                  split_noise=noise.__getitem__, device=dev)
    return model, logs


def rank_cases(dev, scenes):
    """Every port case of this module, in one rank (run_ranks entry)."""
    return dict(vanilla=_vanilla_steps(dev, scenes["vanilla"]), loop=_loop(dev, scenes["loop"]))


# --- the scenes and the JAX side ---------------------------------------------


def np_fields(p):
    return {k: np.asarray(getattr(p, k)) for k in p.__dataclass_fields__}


def vanilla_scene():
    """60 Gaussians in 64 slots, SH degree 1, anisotropic scales and random
    rotations (an isotropic start leaves the rotation gradients at float
    noise, whose sign Adam's first step amplifies), 4 ring views at 64x64
    of random targets."""
    from sugar_tpu.models.gaussians import create_from_pcd as jcreate

    g = np.random.default_rng(0)
    pts = (g.normal(size=(60, 3)) * 0.4).astype(np.float32)
    cols = g.uniform(0.3, 1.0, (60, 3)).astype(np.float32)
    f = np_fields(jcreate(pts, cols, 64, sh_degree=1, initial_opacity=0.6).params)
    f = {k: v.copy() for k, v in f.items()}
    f["log_scales"][:60] += g.uniform(-0.5, 0.5, (60, 3)).astype(np.float32)
    q = g.normal(size=(60, 4)).astype(np.float32)
    f["quaternions"][:60] = q / np.linalg.norm(q, axis=1, keepdims=True)
    f["sh_rest"][:60] = g.normal(0, 0.1, (60, 3, 3)).astype(np.float32)
    alive = np.arange(64) < 60
    gts = [g.uniform(0, 1, (STEP_HW, STEP_HW, 3)).astype(np.float32) for _ in range(4)]
    return dict(fields=f, alive=alive, poses=ring_poses(4, STEP_HW), gts=gts, extent=1.5)


def loop_scene():
    """tests/test_parallel.py's test_sharded_loop_descends scene (the
    targets rendered by the port), and the JAX loop's split noise for its
    one densify pass."""
    import jax

    from sugar_tpu_torch.models.gaussians import create_from_pcd
    from sugar_tpu_torch.models.render import render_model

    g = np.random.default_rng(0)
    pts = g.normal(size=(60, 3)).astype(np.float32) * 0.4
    cols = g.uniform(0.3, 1.0, (60, 3)).astype(np.float32)
    target = create_from_pcd(pts, cols, 64, sh_degree=0, initial_opacity=0.9, device="cpu")
    poses = ring_poses(8, 32)
    gts = [torch.clamp(render_model(target, c, dup_capacity=2048, k_max=64)["image"], 0,
                       1).numpy() for c in cams(poses)]
    _, sub = jax.random.split(jax.random.PRNGKey(0))  # the loop's first densify key
    draws, rng = [], sub
    for _ in range(2):
        rng, k = jax.random.split(rng)
        draws.append(np.asarray(jax.random.normal(k, (64, 3))))
    return dict(pts=pts, cols=np.full_like(cols, 0.5), poses=poses, gts=gts,
                noise={LOOP_DENSIFY_AT: np.stack(draws)})


@pytest.fixture(scope="module")
def scenes():
    return dict(vanilla=vanilla_scene(), loop=loop_scene())


@pytest.fixture(scope="module")
def port(scenes):
    return run_ranks(rank_cases, WORLD, device="cpu", args=(scenes,), threads=1)


def close(t, j, what):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL, atol=ATOL, err_msg=what)


def loss_close(t, j):
    assert np.isfinite(j) and abs(t - j) <= 1e-5 * max(1.0, abs(j)), (t, j)


@pytest.fixture(scope="module")
def jax_vanilla(scenes):
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sugar_tpu.core.cameras import Cameras, make_camera as jmake_camera
    from sugar_tpu.models import densifier as jdens
    from sugar_tpu.models.gaussians import GaussianParams as JParams
    from sugar_tpu.parallel.mesh import make_mesh as jmake_mesh, shard_params as jshard
    from sugar_tpu.parallel.train import make_sharded_train_step, make_tile_sharded_train_step
    from sugar_tpu.trainers import optimizer as jopt

    s = scenes["vanilla"]
    lrs = jopt.group_lrs(jopt.OptimConfig(), spatial_lr_scale=s["extent"])
    jc = [jmake_camera(**p) for p in s["poses"]]
    it = jnp.asarray(STEP_IT, jnp.int32)

    def state(place):
        p = JParams(**{k: jnp.asarray(v) for k, v in s["fields"].items()})
        adam = jopt.init_adam(p)
        return (place(p), place(jnp.asarray(s["alive"])),
                dataclasses.replace(place(dataclasses.replace(adam, count=None)),
                                    count=adam.count),
                place(jdens.DensifyStats.zeros(64)))

    mesh = jmake_mesh(n_data=2, n_gauss=2, devices=jax.devices()[:WORLD])
    step = make_sharded_train_step(mesh, lrs, jopt.OptimConfig(), 1, **STEP_KW)
    out22 = step(*state(lambda t: jshard(t, mesh)), Cameras.stack(jc[:2]),
                 jnp.asarray(np.stack(s["gts"][:2])), it)
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices()[:WORLD]), ("shard",))
    sh1 = NamedSharding(mesh1, P("shard"))
    step = make_tile_sharded_train_step(mesh1, "shard", lrs, jopt.OptimConfig(), 1, tile_cap=16,
                                        k_max=STEP_KW["k_max"], use_kernel=False)
    out_tile = step(*state(lambda t: jax.device_put(t, sh1)), jc[0], jnp.asarray(s["gts"][0]), it)
    return out22, out_tile


def check_state(t, j):
    (tp, ta, ts), (jp, ja, js) = t, j
    for k in PARAM_FIELDS:
        close(getattr(tp, k).numpy(), getattr(jp, k), k)
        close(getattr(ta.mu, k).numpy(), getattr(ja.mu, k), f"mu {k}")
        close(getattr(ta.nu, k).numpy(), getattr(ja.nu, k), f"nu {k}")
    for k in ("grad_accum", "denom", "max_radii"):
        close(getattr(ts, k).numpy(), getattr(js, k), k)
    assert float(js.denom.max()) > 0 and float(js.grad_accum.max()) > 0


def test_sharded_train_step_matches_jax(port, jax_vanilla):
    tp, ta, ts, tl = port["vanilla"]["2x2"]
    jp, ja, js, jaux = jax_vanilla[0]
    loss_close(tl, float(jaux["loss"]))
    check_state((tp, ta, ts), (jp, ja, js))
    assert float(js.max_radii.max()) > 0  # the max over the two views


def test_tile_sharded_train_step_matches_jax(port, jax_vanilla):
    tp, ta, ts, tl, tovf = port["vanilla"]["tile"]
    jp, ja, js, jaux = jax_vanilla[1]
    loss_close(tl, float(jaux["loss"]))
    assert tovf == {k: int(jaux[k]) for k in tovf} == dict.fromkeys(tovf, 0)
    check_state((tp, ta, ts), (jp, ja, js))


def test_train_vanilla_sharded_matches_jax_and_descends(port, scenes, monkeypatch):
    import functools

    import jax

    from sugar_tpu.core.cameras import make_camera as jmake_camera
    from sugar_tpu.parallel import mesh as jmesh
    from sugar_tpu.parallel import trainer as jtrainer
    from sugar_tpu.parallel.trainer import train_vanilla_sharded as jtrain
    from sugar_tpu.trainers import optimizer as jopt
    from sugar_tpu.trainers.vanilla import TrainConfig as JTrainConfig

    s = scenes["loop"]
    jlogs = []
    # The JAX loop meshes every device; give it the port's 4.
    monkeypatch.setattr(jtrainer, "make_mesh", functools.partial(
        jmesh.make_mesh, devices=jax.devices()[:WORLD]))
    jm = jtrain([jmake_camera(**p) for p in s["poses"]], s["gts"], s["pts"], s["cols"], 1.5,
                JTrainConfig(**LOOP_CFG, optim=jopt.OptimConfig(**LOOP_OPTIM)), n_data=2,
                n_gauss=2, log_fn=jlogs.append)
    tm, tlogs = port["loop"]
    assert [r["iter"] for r in tlogs] == [r["iter"] for r in jlogs]
    tl, jl = [r["loss"] for r in tlogs], [r["loss"] for r in jlogs]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)  # the steps' loss tolerance
    assert tl[-1] < tl[0]
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(jm.alive))
    assert int(tm.alive.sum()) != 60  # the densify pass cloned or split some
    for k in PARAM_FIELDS:
        t, j = getattr(tm.params, k).numpy(), np.asarray(getattr(jm.params, k))
        assert np.isfinite(t).all()
        close(t[tm.alive.numpy()], j[np.asarray(jm.alive)], k)


@pytest.mark.slow
def test_full_pipeline_toy_multichip_on_the_port(tmp_path):
    """tests/test_pipeline.py::test_full_pipeline_toy_multichip on the port
    with devices=4 (a 2 x 2 mesh of CPU ranks), with its overrides and
    assertions."""
    from test_torch_pipeline import write_toy_scene

    from sugar_tpu_torch import pipeline as pipe
    from sugar_tpu_torch.io.ply import load_gaussian_ply, load_mesh_ply

    root = str(tmp_path / "scene")
    write_toy_scene(root)
    cfg = pipe.PipelineConfig(
        scene_path=root, output_dir=str(tmp_path / "out4"), poly="low_poly",
        refinement_time="short", eval_split=False, white_background=True, capacity=512,
        devices=4, vanilla_iterations=64,
        vanilla_overrides=dict(sh_degree=0, sh_warmup_every=1, densify_from=10_000,
                               densify_until=10_000, opacity_reset_every=10_000,
                               dup_capacity_mult=32, k_max=256, log_every=32),
        coarse_overrides=dict(start_iteration=0, num_iterations=40, entropy_start=5,
                              entropy_end=20, start_sdf_estimation_from=20, regularize_from=10,
                              prune_at=(), sh_degree=0, reset_neighbors_every=12,
                              n_samples_for_sdf_regularization=20_000, k_max=256,
                              dup_capacity_mult=32, log_every=12, render_mode="tiled"),
        extract_overrides=dict(total_points=60_000, poisson_resolution=64,
                               decimation_target=2_000, dup_capacity=2**14, k_max=256,
                               prune_opacity_threshold=0.1),
        refine_overrides=dict(num_iterations=24, sh_degree=0, sh_warmup_every=1, k_max=256,
                              dup_capacity_mult=16, log_every=12, render_mode="tiled"),
    )
    scene = pipe.load_scene(cfg, device="cpu")
    g = np.random.default_rng(1)
    d = g.normal(size=(200, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    scene.points = (0.7 * d + 0.05 * g.normal(size=(200, 3))).astype(np.float32)
    scene.colors = np.full((200, 3), 0.5, np.float32)

    logs = []
    gs = pipe.run_vanilla(cfg, scene, log_fn=logs.append)
    coarse = pipe.run_coarse(cfg, scene, gs, log_fn=logs.append)
    mesh = pipe.run_extract_mesh(cfg, scene, coarse, log_fn=logs.append)
    v, f, vc = load_mesh_ply(mesh)
    assert len(v) > 100 and len(f) > 100, (len(v), len(f))
    assert vc is not None  # vertex colors survive the sharded meshing path
    refined = pipe.run_refine(cfg, scene, mesh, log_fn=logs.append)
    assert load_gaussian_ply(refined)["xyz"].shape[0] == 6 * len(f)
    assert any("mesh" in str(r) for r in logs)  # the sharded loops logged their mesh
