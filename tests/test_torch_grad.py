"""Gradients of the port's render path against jax.grad through the JAX
package's mode="pallas" (its Pallas kernels in interpret mode on the CPU).

1. rasterize_gaussians on TestPallasBackward's scene (tests/test_pallas.py:
   200 Gaussians, 48 x 64, colors given): gradients with respect to
   means, scales, quaternions, opacities, colors and the ndc_offset probe.
2. render_params on a padded SH-degree-3 model with dead slots: gradients
   with respect to every raw field (through sigmoid, exp and the
   quaternion normalization, SH-3 coefficients included) and ndc_offset.

Loss: mean((image - target)^2) + 0.1 mean(final_T). Tolerance per
gradient: 2e-5 * max|g| + 1e-9 (tests/test_pallas.py:84-88).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_raster import make_scene, make_settings
from test_torch_render import BG, CAM, model_arrays
from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.models import gaussians as jgm
from sugar_tpu.models.render import render_params as jrender_params
from sugar_tpu.raster.api import rasterize_gaussians as jrasterize
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.interop import params_from_numpy
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS
from sugar_tpu_torch.models.render import render_params
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster.api import rasterize_gaussians

torch.set_num_threads(2)
RASTER_ARGS = ("means", "scales", "quats", "opac", "colors", "ndc_offset")
_cache = {}


def _loss_np(image, final_t, target, mean):
    return mean((image - target) ** 2) + 0.1 * mean(final_t)


def raster_grads():
    if "raster" not in _cache:
        means, scales, quats, opac, colors = make_scene(n=200, seed=3)
        arrays = (means, scales, quats, opac, colors, np.zeros((200, 2), np.float32))
        target = np.random.default_rng(0).uniform(0, 1, (48, 64, 3)).astype(np.float32)
        st = make_settings(h=48, w=64, bg=(0.1, 0.2, 0.3))

        def jloss(m, s, q, o, c, off):
            out = jrasterize(m, o, st, scales=s, quaternions=q, colors=c, ndc_offset=off,
                             mode="pallas", dup_capacity=8192, k_max=512)
            return _loss_np(out["image"], out["final_T"], target, jnp.mean)

        with pltpu.force_tpu_interpret_mode():
            ref = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(x) for x in arrays))

        cam = make_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.0, height=48, width=64,
                          device="cpu")
        tst = rc.from_camera(cam, bg=torch.tensor([0.1, 0.2, 0.3]))
        t = [torch.tensor(x, requires_grad=True) for x in arrays]
        out = rasterize_gaussians(t[0], t[3], tst, scales=t[1], quaternions=t[2], colors=t[4],
                                  ndc_offset=t[5], dup_capacity=8192, k_max=512)
        loss = _loss_np(out["image"], out["final_T"], torch.tensor(target), torch.mean)
        got = torch.autograd.grad(loss, t)
        _cache["raster"] = (dict(zip(RASTER_ARGS, map(np.asarray, ref))),
                            dict(zip(RASTER_ARGS, (g.numpy() for g in got))))
    return _cache["raster"]


def params_grads():
    if "params" not in _cache:
        d, alive = model_arrays()
        n = alive.shape[0]
        target = np.random.default_rng(1).uniform(0, 1, (CAM["height"], CAM["width"], 3))
        target = target.astype(np.float32)
        kw = dict(dup_capacity=8192, k_max=512)

        def jloss(p, off):
            out = jrender_params(p, jnp.asarray(alive), jmake_camera(**CAM), 3, jnp.asarray(BG),
                                 ndc_offset=off, mode="pallas", **kw)
            return _loss_np(out["image"], out["final_T"], target, jnp.mean)

        jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})
        with pltpu.force_tpu_interpret_mode():
            gp, goff = jax.grad(jloss, argnums=(0, 1))(jp, jnp.zeros((n, 2), jnp.float32))
        ref = {f: np.asarray(getattr(gp, f)) for f in PARAM_FIELDS}
        ref["ndc_offset"] = np.asarray(goff)

        tp = params_from_numpy(d, device="cpu")
        leaves = {f: getattr(tp, f).requires_grad_(True) for f in PARAM_FIELDS}
        off = torch.zeros((n, 2), requires_grad=True)
        out = render_params(type(tp)(**leaves), torch.tensor(alive),
                            make_camera(**CAM, device="cpu"), 3, torch.tensor(BG),
                            ndc_offset=off, **kw)
        loss = _loss_np(out["image"], out["final_T"], torch.tensor(target), torch.mean)
        g = torch.autograd.grad(loss, list(leaves.values()) + [off])
        got = dict(zip(list(PARAM_FIELDS) + ["ndc_offset"], (x.numpy() for x in g)))
        _cache["params"] = (ref, got)
    return _cache["params"]


def assert_grad_close(got, want):
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale + 1e-9, rtol=0)


@pytest.mark.parametrize("arg", RASTER_ARGS)
def test_rasterize_gradients_match_jax(arg):
    ref, got = raster_grads()
    assert_grad_close(got[arg], ref[arg])
    assert float(np.abs(ref[arg]).max()) > 0.0


@pytest.mark.parametrize("field", list(PARAM_FIELDS) + ["ndc_offset"])
def test_render_params_gradients_match_jax(field):
    ref, got = params_grads()
    assert_grad_close(got[field], ref[field])
    assert np.isfinite(got[field]).all()


def test_dead_slots_get_no_gradient():
    _, got = params_grads()
    _, alive = model_arrays()
    for field in list(PARAM_FIELDS) + ["ndc_offset"]:
        assert float(np.abs(got[field][~alive]).max()) == 0.0, field
