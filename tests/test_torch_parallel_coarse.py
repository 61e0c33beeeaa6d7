"""The port's sharded coarse and refine steps (``parallel/coarse.py``,
``parallel/refine.py``) against the JAX package's, on the CPU: one (data
2, gauss 2) step of each on tests/test_parallel.py's scenes, from the same
numpy state, the coarse step fed the JAX step's own sample draws.

The port's cases run in four ``gloo`` ranks started once for the module
(``port``); the JAX steps run jitted on 4 of the virtual CPU devices of
tests/conftest.py. JAX is imported only inside fixtures and tests, so the
ranks, which import this module to find ``rank_cases``, never do.

Tolerances (tests/test_parallel.py's 1-vs-8 device tolerance): losses
within 1e-5 x max(1, |loss|); parameters and Adam moments rtol 2e-3, atol
2e-5.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel_train import (
    WORLD,
    cams,
    close,
    gather_all,
    loss_close,
    np_fields,
    ring_poses,
)
from sugar_tpu_torch.interop import bound_from_numpy, knn_table_from_numpy, params_from_numpy
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS
from sugar_tpu_torch.parallel.launch import run_ranks
from sugar_tpu_torch.parallel.mesh import make_mesh, shard_params
from sugar_tpu_torch.refine.bound import BOUND_FIELDS
from sugar_tpu_torch.trainers import optimizer as opt

torch.set_num_threads(2)

COARSE_IT = 7001
COARSE_CFG = dict(mode="sdf", n_samples_for_sdf_regularization=2048, knn_to_track=8,
                  k_max=256, sh_degree=1)
REFINE_IT = 3
REFINE_CFG = dict(num_iterations=1, n_gaussians_per_triangle=3, sh_degree=1, k_max=256)


def _coarse_step(dev, s):
    from sugar_tpu_torch.parallel.coarse import make_sharded_coarse_step
    from sugar_tpu_torch.trainers.coarse import CoarseConfig

    cfg = CoarseConfig(**COARSE_CFG)
    mesh = make_mesh(2, 2, device=dev)
    whole = params_from_numpy(s["fields"], dev)
    step = make_sharded_coarse_step(mesh, cfg, opt.group_lrs(cfg.optim, spatial_lr_scale=1.5),
                                    1.5, 2048, True, True)
    draws = [(torch.tensor(i, device=dev), torch.tensor(n, device=dev)) for i, n in s["draws"]]
    p, a, aux = step(shard_params(whole, mesh.gauss),
                     shard_params(torch.tensor(s["alive"], device=dev), mesh.gauss),
                     shard_params(opt.init_adam(whole), mesh.gauss),
                     shard_params(knn_table_from_numpy(s["knn"], dev), mesh.gauss),
                     cams(s["poses"], dev), [torch.tensor(x, device=dev) for x in s["gts"]],
                     COARSE_IT, draws)
    return gather_all(p, mesh.gauss), gather_all(a, mesh.gauss), float(aux["loss"])


def _refine_step(dev, s):
    from sugar_tpu_torch.parallel.refine import (
        gather_bound,
        make_sharded_refine_step,
        shard_bound_state,
    )
    from sugar_tpu_torch.refine.trainer import RefineConfig, bound_lrs, init_bound_adam

    cfg = RefineConfig(**REFINE_CFG)
    mesh = make_mesh(2, 2, device=dev)
    params, bm = bound_from_numpy(s["fields"], s["faces"], 3, s["thickness"], device=dev)
    p, a, sharded = shard_bound_state(mesh.gauss, params, init_bound_adam(params))
    step = make_sharded_refine_step(mesh, cfg, bm, torch.tensor(s["pairs"], device=dev),
                                    bound_lrs(cfg, spatial_lr_scale=1.0), 1,
                                    8 * params.opacity_logit.shape[0], sharded)
    p, a, aux = step(p, a, cams(s["poses"], dev), [torch.tensor(x, device=dev) for x in s["gts"]],
                     REFINE_IT)
    return (gather_bound(p, mesh.gauss, sharded), gather_bound(a.mu, mesh.gauss, sharded),
            gather_bound(a.nu, mesh.gauss, sharded), float(aux["loss"]), sharded)



def rank_cases(dev, scenes):
    """Every port case of this module, in one rank (run_ranks entry)."""
    return dict(coarse=_coarse_step(dev, scenes["coarse"]),
                refine=_refine_step(dev, scenes["refine"]))


def coarse_scene():
    """tests/test_parallel.py's TestShardedCoarse scene (2 of its views),
    its scales made anisotropic and its rotations random: from isotropic
    Gaussians the rotation gradients are float noise (exactly 0 in one
    package, +-1e-12 in the other), whose sign Adam's first step turns into
    a full +-lr move; tests/test_parallel.py's refine scene is perturbed
    for the same reason."""
    import jax.numpy as jnp

    from sugar_tpu.fields.knn import knn as jknn
    from sugar_tpu.models.gaussians import create_from_pcd as jcreate

    g = np.random.default_rng(11)
    pts = g.normal(size=(48, 3)).astype(np.float32) * 0.4
    cols = g.uniform(0.2, 1.0, (48, 3)).astype(np.float32)
    m = jcreate(pts, cols, 64, sh_degree=1, initial_opacity=0.8)
    gts = g.uniform(0, 1, (4, 24, 24, 3)).astype(np.float32)
    f = {k: v.copy() for k, v in np_fields(m.params).items()}
    g2 = np.random.default_rng(12)
    f["log_scales"][:48] += g2.uniform(-0.5, 0.5, (48, 3)).astype(np.float32)
    q = g2.normal(size=(48, 4)).astype(np.float32)
    f["quaternions"][:48] = q / np.linalg.norm(q, axis=1, keepdims=True)
    _, ki = jknn(m.params.xyz, m.params.xyz, k=8, ref_mask=m.alive)
    return dict(fields=f, alive=np.asarray(m.alive), knn=np.asarray(ki),
                poses=ring_poses(4, 24)[:2], gts=list(gts[:2]))


def refine_scene():
    """tests/test_parallel.py's TestShardedRefine scene (2 of its views)."""
    import dataclasses

    import jax.numpy as jnp
    from scipy.spatial import ConvexHull

    from sugar_tpu.refine import bound as jB

    g = np.random.default_rng(17)
    u = g.normal(size=(40, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    verts = (u * 0.8).astype(np.float32)
    faces = ConvexHull(verts).simplices.astype(np.int64)
    vc = g.uniform(0.2, 1.0, (len(verts), 3)).astype(np.float32)
    params, bm = jB.init_bound_params(verts, faces, vc, n_gaussians_per_triangle=3, extent=3.0,
                                      sh_degree=1)
    g2 = np.random.default_rng(23)
    ls = np.asarray(params.log_scales)
    ang = g2.uniform(-0.5, 0.5, len(np.asarray(params.complex_rot))).astype(np.float32)
    params = dataclasses.replace(
        params,
        log_scales=jnp.asarray(ls + g2.uniform(-0.5, 0.5, ls.shape).astype(np.float32)),
        complex_rot=jnp.asarray(np.stack([np.cos(ang), np.sin(ang)], -1)))
    gts = g.uniform(0, 1, (4, 24, 24, 3)).astype(np.float32)
    return dict(fields=np_fields(params), faces=np.asarray(bm.faces), thickness=float(bm.thickness),
                pairs=np.asarray(jB.normal_consistency_pairs(faces)).astype(np.int64),
                poses=ring_poses(4, 24)[:2], gts=list(gts[:2]))


def jax_coarse_draws(s):
    """Run JAX's (2, 2) coarse step, recording each view's categorical
    draw by its key; returns (the step's outputs, the (idx, noise) draws)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from sugar_tpu.core.cameras import Cameras, make_camera as jmake_camera
    from sugar_tpu.fields import density as jdf
    from sugar_tpu.models.gaussians import GaussianParams as JParams
    from sugar_tpu.parallel.coarse import make_sharded_coarse_step
    from sugar_tpu.parallel.mesh import make_mesh as jmake_mesh, shard_params as jshard
    from sugar_tpu.trainers import optimizer as jopt
    from sugar_tpu.trainers.coarse import CoarseConfig as JCoarseConfig
    from sugar_tpu.trainers.schedule import iteration_key

    rec = {}
    orig = jdf.sample_points_in_gaussians

    def sampler(rng, num, gp, mask, **kw):
        pts, idx = orig(rng, num, gp, mask, **kw)
        jax.debug.callback(
            lambda k, i: rec.__setitem__(tuple(np.asarray(k).tolist()), np.asarray(i)), rng, idx)
        return pts, idx

    cfg = JCoarseConfig(**COARSE_CFG)
    mesh = jmake_mesh(n_data=2, n_gauss=2, devices=jax.devices()[:WORLD])
    gsh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("gauss"))
    dsh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    p = JParams(**{k: jnp.asarray(v) for k, v in s["fields"].items()})
    adam = jopt.init_adam(p)
    adam = dataclasses.replace(jshard(dataclasses.replace(adam, count=None), mesh),
                               count=adam.count)
    rngs = jnp.stack([jax.random.key_data(iteration_key(0, i)) for i in range(2)])
    jdf.sample_points_in_gaussians = sampler
    try:
        step = make_sharded_coarse_step(mesh, cfg, jopt.group_lrs(cfg.optim, 1.5), 1.5, 2048,
                                        True, True)
        out = step(jshard(p, mesh), jax.device_put(jnp.asarray(s["alive"]), gsh), adam,
                   jax.device_put(jnp.asarray(s["knn"], jnp.int32), gsh),
                   jax.tree.map(lambda x: jax.device_put(x, dsh),
                                Cameras.stack([jmake_camera(**q) for q in s["poses"]])),
                   jax.device_put(jnp.asarray(np.stack(s["gts"])), dsh),
                   jnp.asarray(COARSE_IT, jnp.int32), rngs)
        jax.block_until_ready(out)
    finally:
        jdf.sample_points_in_gaussians = orig
    draws = []
    for key in np.asarray(rngs):
        noise = jax.random.normal(jax.random.split(jnp.asarray(key))[1],
                                  (COARSE_CFG["n_samples_for_sdf_regularization"], 3))
        draws.append((rec[tuple(key.tolist())], np.asarray(noise)))
    return out, draws



@pytest.fixture(scope="module")
def scenes():
    s = dict(coarse=coarse_scene(), refine=refine_scene())
    s["coarse_jax"], s["coarse"]["draws"] = jax_coarse_draws(s["coarse"])
    return s


@pytest.fixture(scope="module")
def port(scenes):
    data = {k: v for k, v in scenes.items() if k != "coarse_jax"}
    return run_ranks(rank_cases, WORLD, device="cpu", args=(data,), threads=1)


def test_sharded_coarse_step_matches_jax(port, scenes):
    jp, _, jaux = scenes["coarse_jax"]
    tp, ta, tl = port["coarse"]
    loss_close(tl, float(jaux["loss"]))
    for k in PARAM_FIELDS:
        close(getattr(tp, k).numpy(), getattr(jp, k), k)
    assert np.abs(ta.mu.xyz.numpy()).max() > 0


@pytest.fixture(scope="module")
def jax_refine(scenes):
    import jax
    import jax.numpy as jnp

    from sugar_tpu.core.cameras import Cameras, make_camera as jmake_camera
    from sugar_tpu.parallel.mesh import make_mesh as jmake_mesh
    from sugar_tpu.parallel.refine import make_sharded_refine_step, shard_bound_state
    from sugar_tpu.refine import bound as jB
    from sugar_tpu.refine.trainer import RefineConfig as JRefineConfig
    from sugar_tpu.refine.trainer import bound_lrs as jbound_lrs
    from sugar_tpu.refine.trainer import init_bound_adam as jinit_adam

    s = scenes["refine"]
    cfg = JRefineConfig(**REFINE_CFG)
    params = jB.BoundParams(**{k: jnp.asarray(v) for k, v in s["fields"].items()})
    _, bary = jB.BARY_TABLES[3]
    bm = jB.BoundMesh(faces=jnp.asarray(s["faces"], jnp.int32), bary=jnp.asarray(bary),
                      thickness=jnp.asarray(s["thickness"]), n_per_triangle=3)
    mesh = jmake_mesh(n_data=2, n_gauss=2, devices=jax.devices()[:WORLD])
    step = make_sharded_refine_step(mesh, cfg, bm, jnp.asarray(s["pairs"], jnp.int32),
                                    jbound_lrs(cfg, spatial_lr_scale=1.0), active_sh_degree=1,
                                    dup_capacity=8 * params.opacity_logit.shape[0])
    p, a = shard_bound_state(mesh, params, jinit_adam(params))
    dsh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    return step(p, a, jax.tree.map(lambda x: jax.device_put(x, dsh),
                                   Cameras.stack([jmake_camera(**q) for q in s["poses"]])),
                jax.device_put(jnp.asarray(np.stack(s["gts"])), dsh),
                jnp.asarray(REFINE_IT, jnp.int32))


def test_sharded_refine_step_matches_jax(port, jax_refine):
    jp, ja, jaux = jax_refine
    tp, tmu, tnu, tl, sharded = port["refine"]
    loss_close(tl, float(jaux["loss"]))
    assert sharded == dict.fromkeys(BOUND_FIELDS, True)  # V = 40 and G = 228 divide by 2
    for k in BOUND_FIELDS:
        close(getattr(tp, k).numpy(), getattr(jp, k), k)
        close(getattr(tmu, k).numpy(), getattr(ja.mu, k), f"mu {k}")
        close(getattr(tnu, k).numpy(), getattr(ja.nu, k), f"nu {k}")
