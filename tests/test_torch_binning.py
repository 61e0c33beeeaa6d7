"""sugar_tpu_torch fused binning against sugar_tpu's, bit for bit.

Both packages bin the SAME preprocessed Gaussians (the JAX preprocess
output, carried over as numpy), so the comparison isolates binning:
``gid``, ``tile_start``, ``tile_count`` and ``counts_culled`` must be
equal, and so must every counter.

Beside the five cases, the plain version of the card's binning kernels
(``bin_fused_plain``: no rect or bucket cap) is held to the JAX package's
``bin_fused`` at covering caps on every case (``<case>:plain_vs_jax``),
on the counters it has: ``num_big`` sizes the caps it lacks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_raster import make_scene, make_settings
from sugar_tpu.raster import fused as jfused
from sugar_tpu.raster.preprocess import preprocess as jpreprocess
from sugar_tpu_torch.raster import fused as tfused
from sugar_tpu_torch.raster.preprocess import Preprocessed

torch.set_num_threads(1)

# name -> (scene seed, h, w, tile_cap, cap_a, big_cap, capacity)
CASES = {
    # bucket B in use (cap_b = 12 > 0, many Gaussians with rects > 4 tiles)
    "buckets": (21, 64, 80, 16, 4, 300, 8192),
    # bucket B too small: forced big_overflow
    "big_overflow": (22, 64, 80, 16, 4, 6, 8192),
    # tile_cap below the largest rects: rect overflow
    "rect_overflow": (23, 64, 80, 6, 4, 300, 8192),
    # dup capacity below num_rendered: truncated sort output, cap_overflow
    "capacity": (24, 64, 80, 16, 4, 300, 400),
    # no bucket B at all (cap_a = tile_cap)
    "bucket_a_only": (25, 48, 96, 16, 16, 300, 8192),
}
ARRAYS = ["gid", "tile_start", "tile_count", "counts_culled"]
COUNTERS = ["num_rendered", "overflow", "inexact", "big_overflow"]
PLAIN_VS_JAX = [f"{case}:plain_vs_jax" for case in CASES]
COMPARED = list(CASES) + PLAIN_VS_JAX


def _to_torch_prep(jprep) -> Preprocessed:
    return Preprocessed(**{
        k: torch.from_numpy(np.array(getattr(jprep, k))) for k in Preprocessed.__dataclass_fields__
    })


_inputs = {}


def inputs(case):
    """(JAX prep, port prep, bin_fused's arguments after prep) of a case."""
    if case not in _inputs:
        seed, h, w, tile_cap, cap_a, big_cap, capacity = CASES[case]
        means, scales, quats, opac, colors = make_scene(n=300, seed=seed)
        st = make_settings(h=h, w=w)
        jprep = jpreprocess(
            jnp.asarray(means), jnp.asarray(opac), st, scales=jnp.asarray(scales),
            quaternions=jnp.asarray(quats), colors=jnp.asarray(colors),
        )
        args = (st.tiles_x * st.tiles_y, st.tiles_x, tile_cap, cap_a, big_cap, capacity)
        _inputs[case] = (jprep, _to_torch_prep(jprep), args)
    return _inputs[case]


_cache = {}


def binned(case):
    """(want, got) of a compared name: the JAX package and the torch route
    on a case; the JAX package at covering caps and the plain version of
    the kernels (``:plain_vs_jax``)."""
    if case not in _cache:
        base, _, plain = case.partition(":")
        jprep, tprep, args = inputs(base)
        if not plain:
            _cache[case] = (jfused.bin_fused(jprep, *args), tfused.bin_fused(tprep, *args))
        else:
            num_tiles, tiles_x, _tile_cap, cap_a, _big_cap, capacity = args
            n = tprep.tiles_touched.shape[0]
            covering = (num_tiles, tiles_x, int(tprep.tiles_touched.max()), cap_a, n, capacity)
            got = tfused.bin_fused_plain(tprep, num_tiles, tiles_x, capacity)
            _cache[case] = (jfused.bin_fused(jprep, *covering), got)
    return _cache[case]


@pytest.mark.parametrize("key", ARRAYS)
@pytest.mark.parametrize("case", COMPARED)
def test_bin_fused_arrays_bit_equal(case, key):
    jb, tb = binned(case)
    np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]), err_msg=f"{case}/{key}")


@pytest.mark.parametrize("case", COMPARED)
def test_bin_fused_counters_equal(case):
    jb, tb = binned(case)
    keys = COUNTERS if case.endswith(":plain_vs_jax") else COUNTERS + ["num_big"]
    got = {k: int(tb[k]) for k in keys}
    want = {k: int(jb[k]) for k in keys}
    assert got == want


def test_cases_exercise_what_they_name():
    assert int(binned("buckets")[1]["num_big"]) > 0
    assert int(binned("buckets")[1]["overflow"]) == 0
    assert int(binned("big_overflow")[1]["big_overflow"]) > 0
    tb = binned("rect_overflow")[1]
    assert int(tb["overflow"]) > int(tb["inexact"])
    assert int(binned("capacity")[1]["inexact"]) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_plain_drops_only_past_the_capacity(case):
    """The kernels' plain version has no rect or bucket cap: overflow =
    inexact = cap_overflow = the slots past the capacity, big_overflow 0,
    and neither num_big nor max_tiles_touched (the card route's counter
    set)."""
    _, tprep, (num_tiles, tiles_x, tile_cap, cap_a, _big_cap, capacity) = inputs(case)
    got = binned(f"{case}:plain_vs_jax")[1]
    past = max(int(got["num_rendered"]) - capacity, 0)
    assert (int(got["overflow"]), int(got["inexact"]), int(got["big_overflow"])) == (past, past, 0)
    assert int(got["cap_overflow"]) == int(got["overflow"])
    assert "num_big" not in got and "max_tiles_touched" not in got
    n = tprep.tiles_touched.shape[0]
    assert int(got["num_rendered"]) == int(got["counts_culled"].sum())
    assert got["gid"].shape == (tfused.dup_pad(capacity),)
    assert int((got["gid"] < n).sum()) == min(int(got["num_rendered"]), tfused.dup_pad(capacity))


def test_plain_truncates_at_d_pad():
    """The capacity case: the plain version keeps the tile-major head of
    its slots up to D_pad, tile_start and tile_count clipped there."""
    got = binned("capacity:plain_vs_jax")[1]
    d_pad = tfused.dup_pad(CASES["capacity"][-1])
    start, count = got["tile_start"].to(torch.int64), got["tile_count"].to(torch.int64)
    assert int(got["num_rendered"]) > d_pad
    assert int(count.sum()) == d_pad
    assert int((start + count).max()) == d_pad
    assert bool((start[1:] == start[:-1] + count[:-1]).all())


def test_slot_tiles_wide_rects_bit_equal():
    """The f32 divide-and-floor of j // w picks the JAX package's tile even
    where it differs from integer division (wide rects, large j)."""
    g = np.random.default_rng(3)
    w = g.integers(1, 4096, 2000).astype(np.int32)
    j = g.integers(0, 2**24, 2000).astype(np.int32)
    rx = g.integers(0, 64, 2000).astype(np.int32)
    ry = g.integers(0, 64, 2000).astype(np.int32)
    tx, ty = tfused._slot_tiles(torch.tensor(rx), torch.tensor(ry), torch.tensor(w), torch.tensor(j))
    jx, jy = jfused._slot_tiles(jnp.asarray(rx), jnp.asarray(ry), jnp.asarray(w), jnp.asarray(j))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_box_qmin_matches():
    g = np.random.default_rng(4)
    lx = g.uniform(-30, 30, 500).astype(np.float32)
    ly = g.uniform(-30, 30, 500).astype(np.float32)
    hx, hy = lx + 15, ly + 15
    sx, sy, r = g.uniform(1, 8, 500), g.uniform(1, 8, 500), g.uniform(-0.9, 0.9, 500)
    det = sx**2 * sy**2 * (1 - r**2)
    a, b, c = (x.astype(np.float32) for x in (sy**2 / det, -r * sx * sy / det, sx**2 / det))
    t = tfused._box_qmin(*(torch.tensor(x) for x in (lx, hx, ly, hy, a, b, c)))
    j = jfused._box_qmin(*(jnp.asarray(x) for x in (lx, hx, ly, hy, a, b, c)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
