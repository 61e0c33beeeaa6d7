"""The port's bench (``sugar_tpu_torch/scripts/bench.py``) against the JAX
package's root ``bench.py``, on the CPU at a small size.

- The scenes: ``_scene_random`` and ``_scene_trained`` bit-equal to
  bench.py's (n 4,096, seeds 0, 1, 2). Root bench.py is loaded inside a
  fixture with its compilation-cache settings dropped.
- fwd+bwd: bench.py's loss ``sum(image**2)`` through ``mode="pallas"`` at
  n 4,096 and 64x64 on both scenes, against ``jax.grad`` of the same loss
  (Pallas in interpret mode): image atol 1e-5, the five gradients within
  2e-5 x max|g|, the overflow counters equal.
- The train step: bench.py's state at 2^12 Gaussians and 64x64 through the
  warm-up and one step of ``make_train_step``, against JAX's step with
  ``render_mode="pallas"`` (interpret mode); tolerances as
  tests/test_torch_train.py.
- Every measurement entry point's ``main()`` raises without a CUDA card.
"""

import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.models import densifier as jdens
from sugar_tpu.models.gaussians import GaussianParams as JParams
from sugar_tpu.raster import adaptive as jadaptive
from sugar_tpu.raster.api import rasterize_gaussians as jrasterize
from sugar_tpu.raster.common import from_camera as jfrom_camera
from sugar_tpu.trainers import optimizer as jopt
from sugar_tpu.trainers import vanilla as jvan
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.raster.common import from_camera
from sugar_tpu_torch.scripts import (
    bench,
    microbench_gather,
    microbench_prims,
    microbench_sort,
    profile_raster,
    profile_trained,
)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_SMALL = 4096
HW = 64
# Small caps that drop nothing at n 4,096 and 64x64 (the counters say so).
DUP_CAPACITY = 32768
K_MAX = 4096
TRAIN_CAPS = dict(tile_cap=16, dup_capacity=32768, k_max=4096)
GRAD_RTOL = 2e-5
OVF_KEYS = ("bin_overflow", "big_overflow", "cap_overflow", "tile_overflow", "num_rendered",
            "max_tile_count")


@pytest.fixture(scope="module")
def jax_bench():
    """Root bench.py's globals, loaded as a module without its
    compilation-cache settings (it sets them on import)."""
    update = jax.config.update
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, "update", lambda k, v: None if "cache" in k else update(k, v))
        return runpy.run_path(os.path.join(ROOT, "bench.py"), run_name="jax_bench")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scene", ["_scene_random", "_scene_trained"])
def test_bench_scenes_bit_equal(jax_bench, scene, seed):
    ours = getattr(bench, scene)(N_SMALL, np.random.default_rng(seed))
    theirs = jax_bench[scene](N_SMALL, np.random.default_rng(seed))
    for a, b in zip(ours, theirs, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


_fb = {}


def fwd_bwd_pair(jax_bench, scene):
    """(JAX image, grads, counters; port image, grads, counters) of
    bench.py's loss on the small scene, cached per module."""
    if scene not in _fb:
        arrays = jax_bench[scene](N_SMALL, np.random.default_rng(1))
        jst = jfrom_camera(jmake_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.2,
                                        height=HW, width=HW))

        def jloss(m, s, q, o, c):
            out = jrasterize(m, o, jst, scales=s, quaternions=q, colors=c, mode="pallas",
                             dup_capacity=DUP_CAPACITY, tile_cap=16, k_max=K_MAX)
            return jnp.sum(out["image"] ** 2), out

        with pltpu.force_tpu_interpret_mode():
            (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=range(5),
                                                           has_aux=True))(*arrays)
        jcounts = jadaptive.read_overflow(jout)

        settings = from_camera(bench.bench_camera(HW, HW, "cpu"))
        args = [torch.tensor(x, requires_grad=True) for x in arrays]
        loss, out = bench.scene_loss(args, settings, DUP_CAPACITY, K_MAX)
        grads = torch.autograd.grad(loss, args)
        _fb[scene] = (np.asarray(jout["image"]), [np.asarray(g) for g in jgrads], jcounts,
                      out["image"].detach().numpy(), [g.numpy() for g in grads],
                      adaptive.read_overflow(out))
    return _fb[scene]


@pytest.mark.parametrize("scene", ["_scene_random", "_scene_trained"])
def test_bench_fwd_bwd_image_and_counters_match_jax(jax_bench, scene):
    jimg, _, jc, timg, _, tc = fwd_bwd_pair(jax_bench, scene)
    np.testing.assert_allclose(timg, jimg, atol=1e-5, rtol=0)
    assert {k: tc[k] for k in OVF_KEYS} == {k: jc[k] for k in OVF_KEYS}
    assert tc["bin_overflow"] == 0 and tc["tile_overflow"] == 0
    assert float(np.abs(timg).max()) > 0.1


@pytest.mark.parametrize("i", range(5), ids=["means", "scales", "quats", "opac", "colors"])
@pytest.mark.parametrize("scene", ["_scene_random", "_scene_trained"])
def test_bench_fwd_bwd_gradients_match_jax(jax_bench, scene, i):
    _, jg, _, _, tg, _ = fwd_bwd_pair(jax_bench, scene)
    scale = float(np.abs(jg[i]).max())
    assert scale > 0
    np.testing.assert_allclose(tg[i], jg[i], atol=GRAD_RTOL * scale, rtol=0)


_step = {}


def train_step_pair(jax_bench):
    """bench.py's train-step warm-up at 2^12 Gaussians in both packages:
    the state after the first step that drops nothing."""
    if not _step:
        n = N_SMALL
        g = np.random.default_rng(bench.TRAIN_SEED)
        means, scales, quats, opac, colors = jax_bench["_scene_trained"](n, g)
        jp = JParams(
            xyz=jnp.asarray(means),
            sh_dc=jnp.asarray((colors - 0.5) / 0.28209479177387814),
            sh_rest=jnp.zeros((n, 3, 0), jnp.float32),
            opacity_logit=jnp.asarray(np.log(opac / (1 - opac))),
            log_scales=jnp.asarray(np.log(scales)),
            quaternions=jnp.asarray(quats),
        )
        gt = jnp.asarray(g.uniform(0, 1, (HW, HW, 3)).astype(np.float32))
        cfg = jvan.TrainConfig(sh_degree=0, capacity=n, k_max=bench.TRAIN_K_MAX,
                               render_mode="pallas")
        lrs = jopt.group_lrs(cfg.optim, spatial_lr_scale=1.0)
        jstep = jvan.make_train_step(cfg, lrs, active_sh_degree=0,
                                     caps=jadaptive.RasterCaps(**TRAIN_CAPS))
        cam = jmake_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.2, height=HW, width=HW)
        with pltpu.force_tpu_interpret_mode():
            jout = jstep(jp, jnp.ones((n,), bool), jopt.init_adam(jp), jdens.DensifyStats.zeros(n),
                         cam, gt, jnp.asarray(0, jnp.int32))
        jax.block_until_ready(jout)

        s = bench.train_step_setup(n, HW, HW, device="cpu")
        np.testing.assert_array_equal(s["gt"].numpy(), np.asarray(gt))
        _, ts, caps, steps, aux = bench.warm_up_train_step(s, adaptive.RasterCaps(**TRAIN_CAPS))
        _step.update(jax=jout, port=(ts["params"], ts["adam"], ts["stats"], aux), caps=caps,
                     steps=steps, lrs=s["lrs"])
    return _step


def test_bench_train_step_loss_and_counters_match_jax(jax_bench):
    s = train_step_pair(jax_bench)
    jaux, taux = s["jax"][3], s["port"][3]
    assert s["steps"] == 1 and s["caps"] == adaptive.RasterCaps(**TRAIN_CAPS)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
    assert adaptive.read_overflow(taux) == jadaptive.read_overflow(jaux)
    assert not adaptive.overflowed(adaptive.read_overflow(taux))


@pytest.mark.parametrize("field", PARAM_FIELDS)
def test_bench_train_step_params_match_jax(jax_bench, field):
    """Adam's first moment gives the gradient (mu = 0.1 g after one step);
    the stepped parameters as tests/test_torch_train.py holds them."""
    s = train_step_pair(jax_bench)
    jg = np.asarray(getattr(s["jax"][1].mu, field)) / 0.1
    tg = getattr(s["port"][1].mu, field).numpy() / 0.1
    if jg.size == 0:  # sh_rest at SH degree 0
        assert tg.shape == jg.shape
        return
    tol = GRAD_RTOL * max(float(np.abs(jg).max()), 1e-8) + 1e-9
    np.testing.assert_allclose(tg, jg, atol=tol, rtol=0)
    lr = float(s["lrs"][field](0))
    jp = np.asarray(getattr(s["jax"][0], field))
    tp = getattr(s["port"][0], field).numpy()
    near_zero = np.abs(jg) <= tol
    np.testing.assert_allclose(tp[~near_zero], jp[~near_zero], rtol=1e-6, atol=1e-3 * lr)
    assert np.all(np.abs(tp[near_zero] - jp[near_zero]) <= 2 * lr * (1 + 1e-5))


def test_bench_warm_up_grows_the_caps_until_nothing_drops():
    """From a k_max below the deepest tile, the warm-up grows the caps by
    the trainer's rule and keeps the first step that drops nothing."""
    s = bench.train_step_setup(N_SMALL, HW, HW, device="cpu")
    small = adaptive.RasterCaps(tile_cap=16, dup_capacity=32768, k_max=256)
    step, ts, caps, steps, aux = bench.warm_up_train_step(s, small)
    ovf = adaptive.read_overflow(aux)
    assert steps == 2 and caps.k_max > 256 and caps.k_max >= ovf["max_tile_count"]
    assert not adaptive.overflowed(ovf)
    assert not torch.equal(ts["params"].xyz, s["params"].xyz)  # the kept step moved the state


@pytest.mark.parametrize("tool,argv", [
    (bench, None), (profile_raster, None), (profile_trained, []), (profile_trained, ["--scene",
    "random"]), (microbench_gather, None), (microbench_prims, None), (microbench_sort, []),
    (microbench_sort, ["extra"]),
], ids=["bench", "profile_raster", "profile_trained", "profile_trained_random",
        "microbench_gather", "microbench_prims", "microbench_sort", "microbench_sort_extra"])
def test_main_refuses_to_measure_without_a_card(tool, argv):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA card"):
        tool.main() if argv is None else tool.main(argv)
