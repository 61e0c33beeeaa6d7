"""The port's compositing backward (K2's plain version, through the
TileComposite autograd Function) against jax.vjp of the JAX package's
tile_composite, whose Pallas backward runs in interpret mode on the CPU.

Cases: chip_smoke's synthetic case (unaligned ranges, empty tiles, early
exit, k_max clipping, NaN conic/opacity on dropped slots), its deep case
(49 chunks, a crossing deep in a range, NaN and large colors past an
early exit), two random
layouts, and the ranges and dup data of a small scene binned by the
port. Cotangents of the image and of final_T are drawn from a numpy seed.
Tolerance per gradient block: 2e-5 * max|g| + 1e-9 (tests/test_pallas.py:
84-88), since the two take their sums in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from test_raster import make_scene
from test_torch_composite import random_case
from sugar_tpu.raster import pallas_composite as jpc
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster import tile_composite as ttc
from sugar_tpu_torch.raster.fused import bin_and_gather
from sugar_tpu_torch.raster.preprocess import preprocess

torch.set_num_threads(2)
BG = np.array([0.2, 0.5, 0.7], np.float32)
BLOCKS = {"mean2d": slice(0, 2), "conic": slice(2, 5), "opacity": slice(5, 6), "color": slice(6, None)}


def binned_case():
    """Ranges and packed dup data of a 300-Gaussian scene at 64 x 80,
    binned by the port (k_max 512: two chunks per tile)."""
    means, scales, quats, opac, colors = make_scene(n=300, seed=11)
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.0, height=64, width=80,
                      device="cpu")
    st = rc.from_camera(cam)
    t = [torch.tensor(x) for x in (means, scales, quats, opac, colors)]
    with torch.no_grad():
        prep = preprocess(t[0], t[3], st, scales=t[1], quaternions=t[2], colors=t[4])
        b, dup = bin_and_gather(prep, st, tile_cap=16, capacity=8192)
    return (b["tile_start"].numpy(), b["tile_count"].numpy(), dup.numpy(), st.tiles_x, 3, 2)


CASES = {
    "synthetic": lambda: chip_smoke.synthetic_case(0),
    "deep": lambda: chip_smoke.deep_case(0),
    "random_ch3": lambda: random_case(1, 4, 4, 3, 2),
    "random_ch1": lambda: random_case(2, 3, 4, 1, 3),
    "binned_scene": binned_case,
}
_cache = {}


def cotangents(num_tiles, ch, seed):
    g = np.random.default_rng(seed)
    return (g.uniform(-1, 1, (num_tiles, ttc.P_TILE, ch)).astype(np.float32),
            g.uniform(-1, 1, (num_tiles, ttc.P_TILE)).astype(np.float32))


def grads(case):
    if case not in _cache:
        start, count, data, tiles_x, ch, max_chunks = CASES[case]()
        num_tiles = start.shape[0]
        bg = BG[:ch]
        g_img, g_t = cotangents(num_tiles, ch, 100 + len(case))
        clipped = np.minimum(count, max_chunks * ttc.C_CHUNK)  # the JAX caller clips

        def f(d, b):
            img, t_fin, _ = jpc.tile_composite(
                (tiles_x, num_tiles, ch, max_chunks), jnp.asarray(start), jnp.asarray(clipped), d, b
            )
            return img, t_fin

        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(f, jnp.asarray(data), jnp.asarray(bg))
            jd, jbg = vjp((jnp.asarray(g_img), jnp.asarray(g_t)))
        ref = dict(d=np.asarray(jd), bg=np.asarray(jbg))

        d_t = torch.tensor(data, requires_grad=True)
        bg_t = torch.tensor(bg, requires_grad=True)
        img, t_fin, n_contrib = ttc.tile_composite(
            torch.tensor(start), torch.tensor(count), d_t, bg_t, tiles_x, ch, max_chunks
        )
        gd, gbg = torch.autograd.grad((img, t_fin), (d_t, bg_t),
                                      (torch.tensor(g_img), torch.tensor(g_t)))
        got = dict(d=gd.numpy(), bg=gbg.numpy(), grad_fn=type(img.grad_fn).__name__,
                   n_contrib=n_contrib)
        _cache[case] = (ref, got, (start, clipped, ch))
    return _cache[case]


def assert_close(got, want):
    assert got.shape == want.shape
    scale = float(np.nanmax(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, atol=2e-5 * scale + 1e-9, rtol=0)


@pytest.mark.parametrize("block", list(BLOCKS) + ["bg"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_pallas(case, block):
    ref, got, (_, _, ch) = grads(case)
    if block == "bg":
        assert_close(got["bg"], ref["bg"])
    else:
        rows = BLOCKS[block]
        end = 6 + ch
        sl = slice(rows.start, end if rows.stop is None else rows.stop)
        assert_close(got["d"][sl], ref["d"][sl])
        assert np.isfinite(got["d"][sl]).all()


@pytest.mark.parametrize("case", list(CASES))
def test_unowned_and_padding_slots_get_zero(case):
    ref, got, (start, clipped, ch) = grads(case)
    d = got["d"]
    owned = np.zeros(d.shape[1], bool)
    for s, c in zip(start, clipped):
        owned[s : s + c] = True
    assert float(np.abs(d[:, ~owned]).max(initial=0.0)) == 0.0
    assert float(np.abs(d[6 + ch :]).max(initial=0.0)) == 0.0  # padding rows
    assert np.count_nonzero(d[:, owned]) > 0


def test_backward_goes_through_the_port_function():
    _, got, _ = grads("synthetic")
    assert got["grad_fn"] == "TileCompositeBackward"
    assert not got["n_contrib"].requires_grad


def test_bwd_wrapper_refuses_cpu_tensors():
    start, count, data, tiles_x, ch, mc = random_case(5, 2, 2, 3, 2)
    t = ttc.tile_composite_plain(torch.tensor(start), torch.tensor(count), torch.tensor(data),
                                 tiles_x, ch, mc)
    launches = ttc.tile_composite_bwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ttc.tile_composite_bwd_cuda(
            torch.tensor(start), torch.tensor(count), t.nch, torch.tensor(data), t.img,
            t.final_t, t.final_t, t.entry_p, tiles_x, ch, mc,
        )
    assert ttc.tile_composite_bwd_cuda.launches == launches
