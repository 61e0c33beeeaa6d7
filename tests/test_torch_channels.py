"""Colour widths above the kernels' instantiations (C > 4 channels, 6 + C >
16 gradient rows).

1. The render end to end: rasterize_gaussians(mode="pallas") of the port on
   the CPU against the JAX package's (its Pallas kernels in interpret mode)
   on a small SH-free scene at 64x64 with C = 8 and C = 13 colour
   channels: image and final_T within atol 1e-5, n_contrib exactly equal;
   the gradients of means, opacities and colours within 2e-5 * max|g| +
   1e-9 (tests/test_pallas.py:84-88).
2. The wrappers' channel-group and row-block split on the CPU, with the
   plain versions standing in for the per-group launch: K1 in groups and
   K3 in row blocks bit-equal to one wide plain call; K2 in groups within
   2e-5 * max|g| per gradient block, the final_T cotangent given to one
   group alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_raster import make_scene
from test_torch_composite import random_case
from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.raster import common as jrc
from sugar_tpu.raster.api import rasterize_gaussians as jrasterize
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster import segsum as tss
from sugar_tpu_torch.raster import tile_composite as ttc
from sugar_tpu_torch.raster.api import rasterize_gaussians

torch.set_num_threads(2)
HW = 64
N = 200
RENDER_KW = dict(dup_capacity=8192, k_max=512)
GRAD_ARGS = ("means", "opac", "colors")
BLOCKS = {"mean2d": slice(0, 2), "conic": slice(2, 5), "opacity": slice(5, 6),
          "color": slice(6, None)}
_cache = {}


def scene(ch: int):
    """make_scene's Gaussians with ``ch`` colour channels (its three, then
    ch - 3 seeded uniform ones), a ch-wide background and target."""
    means, scales, quats, opac, colors = make_scene(n=N, seed=5)
    g = np.random.default_rng(100 + ch)
    colors = np.concatenate([colors, g.uniform(0, 1, (N, ch - 3))], 1).astype(np.float32)
    bg = g.uniform(0, 0.5, ch).astype(np.float32)
    target = g.uniform(0, 1, (HW, HW, ch)).astype(np.float32)
    return means, scales, quats, opac, colors, bg, target


def _loss(image, final_t, target, mean):
    return mean((image - target) ** 2) + 0.1 * mean(final_t)


def renders(ch: int):
    """(JAX, port) dicts of image, final_T, n_contrib and the gradients,
    numpy; computed once per module."""
    if ch in _cache:
        return _cache[ch]
    means, scales, quats, opac, colors, bg, target = scene(ch)
    cam = dict(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.2, height=HW, width=HW)
    jst = jrc.from_camera(jmake_camera(**cam), bg=jnp.asarray(bg))

    def jloss(m, o, c):
        out = jrasterize(m, o, jst, scales=jnp.asarray(scales), quaternions=jnp.asarray(quats),
                         colors=c, mode="pallas", **RENDER_KW)
        return _loss(out["image"], out["final_T"], target, jnp.mean), out

    with pltpu.force_tpu_interpret_mode():
        (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(means), jnp.asarray(opac), jnp.asarray(colors))
    want = {k: np.asarray(jout[k]) for k in ("image", "final_T", "n_contrib")}
    want.update(zip(GRAD_ARGS, map(np.asarray, jg)))

    tst = rc.from_camera(make_camera(**cam, device="cpu"), bg=torch.tensor(bg))
    leaves = [torch.tensor(x, requires_grad=True) for x in (means, opac, colors)]
    out = rasterize_gaussians(leaves[0], leaves[1], tst, scales=torch.tensor(scales),
                              quaternions=torch.tensor(quats), colors=leaves[2], mode="pallas",
                              **RENDER_KW)
    loss = _loss(out["image"], out["final_T"], torch.tensor(target), torch.mean)
    got = {k: out[k].detach().numpy() for k in ("image", "final_T", "n_contrib")}
    got.update(zip(GRAD_ARGS, (x.numpy() for x in torch.autograd.grad(loss, leaves))))
    _cache[ch] = (want, got)
    return _cache[ch]


@pytest.mark.parametrize("ch", [8, 13])
def test_render_matches_jax_above_four_channels(ch):
    want, got = renders(ch)
    assert got["image"].shape == want["image"].shape == (HW, HW, ch)
    np.testing.assert_allclose(got["image"], want["image"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["final_T"], want["final_T"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["n_contrib"], want["n_contrib"])
    assert float(got["final_T"].min()) < 0.5 and int(got["n_contrib"].max()) > 5


@pytest.mark.parametrize("ch", [8, 13])
@pytest.mark.parametrize("arg", GRAD_ARGS)
def test_gradients_match_jax_above_four_channels(ch, arg):
    want, got = renders(ch)
    scale = float(np.abs(want[arg]).max())
    assert scale > 0.0
    np.testing.assert_allclose(got[arg], want[arg], atol=2e-5 * scale + 1e-9, rtol=0)


def test_channel_groups_cover_every_channel_once():
    assert ttc.channel_groups(3) == [(0, 3)]
    assert ttc.channel_groups(4) == [(0, 4)]
    assert ttc.channel_groups(8) == [(0, 4), (4, 8)]
    assert ttc.channel_groups(13) == [(0, 4), (4, 8), (8, 12), (12, 13)]


def _wide_case(ch=13):
    start, count, data, tiles_x, ch, mc = random_case(7, 3, 3, ch, 3)
    return (torch.tensor(start), torch.tensor(count), torch.tensor(data), tiles_x, ch, mc)


def test_k1_channel_groups_bit_equal_to_one_wide_call(monkeypatch):
    args = _wide_case()
    want = ttc.tile_composite_plain(*args)
    calls = []

    def per_group(*a):
        calls.append(a[4])
        assert a[2].shape[0] == 6 + a[4] and a[2].is_contiguous()
        return ttc.tile_composite_plain(*a)

    monkeypatch.setattr(ttc, "_launch_fwd", per_group)
    got = ttc.composite_groups(*args)
    assert calls == [4, 4, 4, 1]
    for name, x, y in zip(ttc.CompositeOut._fields, got, want):
        assert torch.equal(x, y), name
    assert float(want.final_t.min()) < 0.5


def test_k2_channel_groups_match_one_wide_call(monkeypatch):
    start, count, data, tiles_x, ch, mc = _wide_case()
    fwd = ttc.tile_composite_plain(start, count, data, tiles_x, ch, mc)
    g = np.random.default_rng(8)
    g_img = torch.tensor(g.normal(size=fwd.img.shape).astype(np.float32))
    gt_total = torch.tensor(g.normal(size=fwd.final_t.shape).astype(np.float32))
    args = (start, count, fwd.nch, data, g_img, gt_total, fwd.final_t, fwd.entry_p, tiles_x, ch,
            mc)
    want = ttc.tile_composite_bwd_plain(*args)
    gts = []

    def per_group(*a):
        gts.append(a[5])
        return ttc.tile_composite_bwd_plain(*a)

    monkeypatch.setattr(ttc, "_launch_bwd", per_group)
    got = ttc.composite_bwd_groups(*args)
    assert len(gts) == 4
    assert sum(torch.equal(x, gt_total) for x in gts) == 1
    assert sum(bool((x == 0).all()) for x in gts) == 3
    assert got.shape == want.shape
    for name, rows in BLOCKS.items():
        scale = float(want[rows].abs().max())
        assert scale > 0.0, name
        np.testing.assert_allclose(got[rows].numpy(), want[rows].numpy(),
                                   atol=2e-5 * scale + 1e-9, rtol=0, err_msg=name)
    assert float(got[6 + ch:].abs().max()) == 0.0  # the padding rows


def test_k3_row_blocks_bit_equal_to_one_wide_call(monkeypatch):
    g = np.random.default_rng(9)
    n, d, rows = 300, 2000, 19
    gid = torch.tensor(np.sort(g.integers(-3, n + 5, d)).astype(np.int32))
    ct = torch.tensor(g.normal(size=(rows, d)).astype(np.float32))
    want = tss.segment_sum_plain(ct, gid, n)
    blocks = []

    def per_block(c, i, m, out):
        blocks.append(c.shape[0])
        assert c.is_contiguous() and out.is_contiguous()
        out.copy_(tss.segment_sum_plain(c, i, m))

    monkeypatch.setattr(tss, "_launch_block", per_block)
    got = tss.row_blocks(ct, gid, n, torch.full((rows, n), float("nan")))
    assert blocks == [16, 3]
    assert torch.equal(got, want)


def test_wrappers_still_refuse_cpu_tensors_above_four_channels():
    start, count, data, tiles_x, ch, mc = _wide_case()
    launches = ttc.tile_composite_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ttc.tile_composite_cuda(start, count, data, tiles_x, ch, mc)
    assert ttc.tile_composite_cuda.launches == launches
    ct = torch.zeros((19, 4))
    gid = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tss.segment_sum_cuda(ct, gid, 4)
