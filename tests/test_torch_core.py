"""sugar_tpu_torch core + losses against sugar_tpu, from the same numpy inputs.

Tolerance: atol 1e-6 on float32 values of order 1 (both sides do the same
float32 arithmetic; differences are last-bit rounding of sqrt/norm).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sugar_tpu.core import cameras as jcam
from sugar_tpu.core import quaternions as jq
from sugar_tpu.core import sh as jsh
from sugar_tpu.core import transforms as jtf
from sugar_tpu.raster import common as jrc
from sugar_tpu.utils import losses as jloss
from sugar_tpu_torch.core import cameras as tcam
from sugar_tpu_torch.core import quaternions as tq
from sugar_tpu_torch.core import sh as tsh
from sugar_tpu_torch.core import transforms as ttf
from sugar_tpu_torch.raster import common as trc
from sugar_tpu_torch.utils import losses as tloss

torch.set_num_threads(1)
ATOL = 1e-6


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _unit(g, n):
    d = g.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(deg):
    g = np.random.default_rng(deg)
    k = (deg + 1) ** 2
    sh = g.normal(size=(50, 3, k)).astype(np.float32)
    dirs = _unit(g, 50)
    _close(tsh.eval_sh(deg, torch.tensor(sh), torch.tensor(dirs)),
           jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    _close(tsh.sh_to_rgb(deg, torch.tensor(sh), torch.tensor(dirs)),
           jsh.sh_to_rgb(deg, jnp.asarray(sh), jnp.asarray(dirs)))


def test_sh_dc_conversions():
    rgb = np.random.default_rng(0).uniform(0, 1, (40, 3)).astype(np.float32)
    _close(tsh.rgb_to_sh0(torch.tensor(rgb)), jsh.rgb_to_sh0(jnp.asarray(rgb)))
    _close(tsh.sh0_to_rgb(torch.tensor(rgb)), jsh.sh0_to_rgb(jnp.asarray(rgb)))
    assert tsh.num_sh_coeffs(3) == jsh.num_sh_coeffs(3) == 16


def _quats(seed, n=64):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q


@pytest.mark.parametrize(
    "name",
    ["normalize", "quaternion_to_matrix", "matrix_to_quaternion", "raw_multiply", "apply"],
)
def test_quaternions(name):
    q = _quats(1)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    if name == "normalize":
        _close(tq.normalize(torch.tensor(q)), jq.normalize(jnp.asarray(q)))
    elif name == "quaternion_to_matrix":
        _close(tq.quaternion_to_matrix(torch.tensor(qn)), jq.quaternion_to_matrix(jnp.asarray(qn)))
    elif name == "matrix_to_quaternion":
        m = np.asarray(jq.quaternion_to_matrix(jnp.asarray(qn)))
        _close(tq.matrix_to_quaternion(torch.tensor(m)), jq.matrix_to_quaternion(jnp.asarray(m)))
    elif name == "raw_multiply":
        b = _quats(2)
        _close(tq.quaternion_raw_multiply(torch.tensor(q), torch.tensor(b)),
               jq.quaternion_raw_multiply(jnp.asarray(q), jnp.asarray(b)))
    else:
        v = np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32)
        _close(tq.quaternion_apply(torch.tensor(qn), torch.tensor(v)),
               jq.quaternion_apply(jnp.asarray(qn), jnp.asarray(v)), atol=2e-6)


def test_transforms_numpy_builders_identical():
    R = np.asarray(jq.quaternion_to_matrix(jnp.asarray(_quats(4, 1)[0] / 2.0)))
    T = np.array([0.3, -0.2, 1.5], np.float32)
    np.testing.assert_array_equal(ttf.world_to_view(R, T), jtf.world_to_view(R, T))
    np.testing.assert_array_equal(
        ttf.projection_matrix(0.01, 100.0, 1.1, 0.9, 0.05, -0.02),
        jtf.projection_matrix(0.01, 100.0, 1.1, 0.9, 0.05, -0.02),
    )
    assert ttf.fov2focal(1.2, 512) == jtf.fov2focal(1.2, 512)
    assert ttf.focal2fov(300.0, 512) == jtf.focal2fov(300.0, 512)


def test_transform_points():
    m = np.random.default_rng(5).normal(size=(4, 4)).astype(np.float32)
    p = np.random.default_rng(6).normal(size=(30, 3)).astype(np.float32)
    _close(ttf.transform_points_h(torch.tensor(m), torch.tensor(p)),
           jtf.transform_points_h(jnp.asarray(m), jnp.asarray(p)), atol=1e-5)
    _close(ttf.transform_points(torch.tensor(m), torch.tensor(p)),
           jtf.transform_points(jnp.asarray(m), jnp.asarray(p)), atol=1e-5)


def _cam_args(principal):
    ang = 0.4
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    kw = dict(R=R, T=np.array([0.1, -0.2, 2.0]), fov_x=1.1, fov_y=0.8, height=48, width=64)
    if principal:
        kw.update(cx=30.0, cy=25.0, znear=0.1, zfar=50.0)
    return kw


@pytest.mark.parametrize("principal", [False, True])
def test_make_camera(principal):
    tc = tcam.make_camera(**_cam_args(principal), device="cpu")
    jc = jcam.make_camera(**_cam_args(principal))
    for f in ("world_view", "full_proj", "cam_center"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    for f in ("height", "width", "tan_half_fov_x", "tan_half_fov_y", "focal_x", "focal_y"):
        assert getattr(tc, f) == getattr(jc, f)


def test_cameras_stack_and_index():
    tcs = [tcam.make_camera(**_cam_args(p), device="cpu") for p in (False, True)]
    jcs = [jcam.make_camera(**_cam_args(p)) for p in (False, True)]
    tb, jb = tcam.Cameras.stack(tcs), jcam.Cameras.stack(jcs)
    assert len(tb) == len(jb) == 2
    np.testing.assert_array_equal(tb[1].full_proj.numpy(), np.asarray(jb[1].full_proj))
    assert tb[0].width == jb[0].width and tb[1].tan_half_fov_y == jb[1].tan_half_fov_y


def test_from_camera():
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    ts = trc.from_camera(tcam.make_camera(**_cam_args(True), device="cpu"), bg=torch.tensor(bg))
    js = jrc.from_camera(jcam.make_camera(**_cam_args(True)), bg=jnp.asarray(bg))
    for f in ("viewmatrix", "projmatrix", "campos", "bg"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    for f in ("image_height", "image_width", "tanfovx", "tanfovy", "focal_x", "focal_y",
              "tiles_x", "tiles_y", "sh_degree", "scale_modifier"):
        assert getattr(ts, f) == getattr(js, f)


def test_constants_identical():
    for name in ("ALPHA_CLAMP", "ALPHA_CUTOFF", "T_EPS", "LOWPASS", "Z_CULL",
                 "RADIUS_SIGMA", "FOV_CLAMP", "W_EPS", "TILE_X", "TILE_Y"):
        assert getattr(trc, name) == getattr(jrc, name), name


@pytest.mark.parametrize("name", ["l1_loss", "psnr", "ssim"])
def test_losses(name):
    g = np.random.default_rng(7)
    a = g.uniform(0, 1, (40, 52, 3)).astype(np.float32)
    b = np.clip(a + g.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    t = getattr(tloss, name)(torch.tensor(a), torch.tensor(b))
    j = getattr(jloss, name)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5, atol=1e-6)


def test_spatial_extent():
    g = np.random.default_rng(7)
    centers = g.normal(0, 2.0, (12, 3)).astype(np.float32)
    t = tcam.spatial_extent(torch.tensor(centers))
    j = jcam.spatial_extent(jnp.asarray(centers))
    assert t.shape == ()
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
