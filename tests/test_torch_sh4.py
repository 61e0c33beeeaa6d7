"""SH degree 4 in the port against the JAX package, on the CPU.

- ``core/sh.eval_sh(4, ...)`` and its gradients with respect to the
  coefficients and the directions: atol 1e-5 (values), 1e-5 x max|g|.
- A degree-4 PLY written by the JAX package's ``save_ply`` loads in the
  port (``sh_degree`` 4, every field bit-equal) and renders through
  ``mode="pallas"`` on the CPU to the JAX package's image (Pallas in
  interpret mode) within 1e-5, with equal counters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sugar_tpu.core import sh as jsh
from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.models import gaussians as jgm
from sugar_tpu.models.render import render_model as jrender_model
from sugar_tpu.raster import adaptive as jadaptive
from sugar_tpu_torch.core import sh as tsh
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS, load_ply
from sugar_tpu_torch.models.render import render_model
from sugar_tpu_torch.raster import adaptive

torch.set_num_threads(2)

N = 400
CAP = dict(dup_capacity=8192, k_max=1024)


def _sh_case(seed=4):
    g = np.random.default_rng(seed)
    sh = g.normal(size=(64, 3, 25)).astype(np.float32)
    d = g.normal(size=(64, 3)).astype(np.float32)
    dirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
    w = g.normal(size=(64, 3)).astype(np.float32)
    return sh, dirs, w


def test_eval_sh_degree_4_matches_jax():
    sh, dirs, _ = _sh_case()
    t = tsh.eval_sh(4, torch.tensor(sh), torch.tensor(dirs)).numpy()
    j = np.asarray(jsh.eval_sh(4, jnp.asarray(sh), jnp.asarray(dirs)))
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
    # The fourth band contributes: degree 4 is not degree 3.
    j3 = np.asarray(jsh.eval_sh(3, jnp.asarray(sh[..., :16]), jnp.asarray(dirs)))
    assert float(np.abs(j - j3).max()) > 0.1
    assert tsh.C4 == jsh.C4


@pytest.mark.parametrize("wrt", [0, 1], ids=["sh", "dirs"])
def test_eval_sh_degree_4_gradient_matches_jax(wrt):
    sh, dirs, w = _sh_case(5)
    jg = jax.grad(lambda s, d: jnp.sum(jsh.eval_sh(4, s, d) * w), argnums=wrt)(
        jnp.asarray(sh), jnp.asarray(dirs))
    ts, td = torch.tensor(sh, requires_grad=True), torch.tensor(dirs, requires_grad=True)
    (tg,) = torch.autograd.grad(torch.sum(tsh.eval_sh(4, ts, td) * torch.tensor(w)),
                                (ts, td)[wrt])
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-5 * float(np.abs(jg).max()), rtol=0)


def test_eval_sh_refuses_degree_5():
    with pytest.raises(AssertionError):
        tsh.eval_sh(5, torch.zeros(2, 3, 36), torch.zeros(2, 3))


def _jax_model():
    """A degree-4 JAX model of N Gaussians in front of the camera."""
    g = np.random.default_rng(44)
    xyz = np.stack([g.uniform(-1, 1, N), g.uniform(-1, 1, N), g.uniform(2.5, 5, N)], -1)
    params = jgm.GaussianParams(
        xyz=jnp.asarray(xyz.astype(np.float32)),
        sh_dc=jnp.asarray(g.normal(0, 0.5, (N, 3)).astype(np.float32)),
        sh_rest=jnp.asarray(g.normal(0, 0.2, (N, 3, 24)).astype(np.float32)),
        opacity_logit=jnp.asarray(g.normal(0, 1, N).astype(np.float32)),
        log_scales=jnp.asarray(np.log(g.uniform(0.02, 0.12, (N, 3))).astype(np.float32)),
        quaternions=jnp.asarray(g.normal(size=(N, 4)).astype(np.float32)),
    )
    return jgm.GaussianModel(params, jnp.ones((N,), bool), 4)


@pytest.fixture(scope="module")
def ply_pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sh4") / "sh4.ply")
    jm = _jax_model()
    jgm.save_ply(jm, path)
    tm = load_ply(path, device="cpu")
    cam = dict(R=np.eye(3), T=np.zeros(3), fov_x=1.1, fov_y=0.9, height=48, width=64)
    with pltpu.force_tpu_interpret_mode():
        jout = jrender_model(jgm.load_ply(path), jmake_camera(**cam), mode="pallas", **CAP)
        jax.block_until_ready(jout)
    tout = render_model(tm, make_camera(**cam, device="cpu"), mode="pallas", **CAP)
    return jm, tm, jout, tout


def test_degree_4_ply_from_jax_loads_in_the_port(ply_pair):
    jm, tm, _, _ = ply_pair
    assert tm.sh_degree == 4
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(tm.params, f)[:N].numpy(),
                                      np.asarray(getattr(jm.params, f)))
    assert tuple(tm.sh.shape[1:]) == (3, 25)


def test_degree_4_ply_renders_to_the_jax_image(ply_pair):
    _, _, jout, tout = ply_pair
    np.testing.assert_allclose(tout["image"].numpy(), np.asarray(jout["image"]), atol=1e-5,
                               rtol=0)
    assert adaptive.read_overflow(tout) == jadaptive.read_overflow(jout)
    assert not adaptive.overflowed(adaptive.read_overflow(tout))
    assert float(tout["image"].max()) > 0.1
