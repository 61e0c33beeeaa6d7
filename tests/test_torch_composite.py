"""tile_composite_plain against the JAX package's Pallas compositing kernel
(run in interpret mode on the CPU, as tests/test_pallas.py runs it). The
plain version replays the CUDA kernel's split into (tile, chunk) pairs, so
these tests hold that decomposition to the Pallas kernel; the deep case
walks 49 chunks, crosses T_EPS deep in a range and exits early in another.

Tolerances: image and final_T atol 1e-5 (the plain version's cumprod and
bmm round differently from the Pallas kernel's lane scan and MXU
contraction); entry_p atol 1e-6 on the rows both processed; n_contrib and
nch exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from sugar_tpu.raster import pallas_composite as jpc
from sugar_tpu_torch.raster import tile_composite as ttc

torch.set_num_threads(2)
FIELDS = ["img", "final_t", "n_contrib", "nch", "entry_p"]


def random_case(seed, tiles_x, tiles_y, ch, max_chunks):
    """Contiguous unaligned ranges as binning lays them out (one leading
    unowned slot run, empty tiles, ranges past max_chunks * 256)."""
    g = np.random.default_rng(seed)
    t = tiles_x * tiles_y
    count = g.integers(0, 3 * 256, t).astype(np.int32)
    count[g.uniform(size=t) < 0.2] = 0
    start = (37 + np.concatenate([[0], np.cumsum(count)[:-1]])).astype(np.int32)
    d_pad = ((int(start[-1] + count[-1]) + 255) // 256) * 256 + 256
    data = np.zeros((((6 + ch + 7) // 8) * 8, d_pad), np.float32)
    tile_of = np.searchsorted(np.cumsum(count) + 37, np.arange(d_pad), side="right")
    tile_of = np.minimum(tile_of, t - 1)
    data[0] = (tile_of % tiles_x) * 16 + g.uniform(-10, 26, d_pad)
    data[1] = (tile_of // tiles_x) * 16 + g.uniform(-10, 26, d_pad)
    sx, sy, r = g.uniform(0.8, 7, d_pad), g.uniform(0.8, 7, d_pad), g.uniform(-0.85, 0.85, d_pad)
    det = sx**2 * sy**2 * (1 - r**2)
    data[2], data[3], data[4] = sy**2 / det, -r * sx * sy / det, sx**2 / det
    data[5] = g.uniform(0.0, 0.99, d_pad)
    data[6 : 6 + ch] = g.uniform(0, 1, (ch, d_pad))
    return start, count, data, tiles_x, ch, max_chunks


CASES = {
    "synthetic": lambda: chip_smoke.synthetic_case(0),
    "deep": lambda: chip_smoke.deep_case(0),
    "random_ch3": lambda: random_case(1, 4, 4, 3, 2),
    "random_ch1": lambda: random_case(2, 3, 4, 1, 3),
}
_cache = {}


def composited(case):
    if case not in _cache:
        start, count, data, tiles_x, ch, max_chunks = CASES[case]()
        num_tiles = start.shape[0]
        clipped = np.minimum(count, max_chunks * ttc.C_CHUNK)  # the JAX caller clips
        with pltpu.force_tpu_interpret_mode():
            img, t_fin, ninc, entry_p, nch = jpc._make_fwd(tiles_x, num_tiles, ch, max_chunks)(
                jnp.asarray(start), jnp.asarray(clipped), jnp.asarray(data)
            )
        ref = dict(
            img=np.asarray(img), final_t=np.asarray(t_fin)[..., 0],
            n_contrib=np.asarray(ninc)[..., 0], entry_p=np.asarray(entry_p),
            nch=np.asarray(nch)[:, 0, 0],
        )
        out = ttc.tile_composite_plain(
            torch.tensor(start), torch.tensor(count), torch.tensor(data), tiles_x, ch, max_chunks
        )
        _cache[case] = (ref, {k: getattr(out, k).numpy() for k in FIELDS})
    return _cache[case]


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_kernel(case, field):
    ref, got = composited(case)
    assert got[field].shape == ref[field].shape, (got[field].shape, ref[field].shape)
    if field in ("n_contrib", "nch"):
        np.testing.assert_array_equal(got[field], ref[field])
    elif field == "entry_p":
        rows = np.arange(ref["entry_p"].shape[1])
        valid = (rows[None, :] < ref["nch"][:, None])[:, :, None]
        np.testing.assert_allclose(
            np.where(valid, got[field], 0), np.where(valid, ref[field], 0), atol=1e-6, rtol=0
        )
    else:
        np.testing.assert_allclose(got[field], ref[field], atol=1e-5, rtol=0)


def test_cases_cover_early_exit_and_multichunk():
    ref, _ = composited("synthetic")
    assert ref["nch"][3] < 3 and ref["nch"][2] == 4 and ref["nch"][0] == 0
    ref, _ = composited("random_ch3")
    assert (ref["nch"] >= 2).any()
    ref, _ = composited("deep")
    assert ref["nch"].tolist() == [49, 32, 1, 0]


def test_tile_batch_does_not_change_results(monkeypatch):
    start, count, data, tiles_x, ch, mc = random_case(3, 4, 3, 3, 3)
    args = (torch.tensor(start), torch.tensor(count), torch.tensor(data), tiles_x, ch, mc)
    b = ttc.tile_composite_plain(*args)
    monkeypatch.setattr(ttc, "_TILE_BATCH", 1)
    a = ttc.tile_composite_plain(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_tile_composite_adds_background_on_cpu():
    start, count, data, tiles_x, ch, mc = random_case(4, 2, 2, 3, 2)
    args = (torch.tensor(start), torch.tensor(count), torch.tensor(data))
    bg = torch.tensor([0.2, 0.5, 0.7])
    image, final_t, n_contrib = ttc.tile_composite(*args, bg, tiles_x, ch, mc)
    plain = ttc.tile_composite_plain(*args, tiles_x, ch, mc)
    assert torch.equal(image, plain.img + plain.final_t[:, :, None] * bg)
    assert torch.equal(final_t, plain.final_t) and torch.equal(n_contrib, plain.n_contrib)


def test_kernel_wrapper_refuses_cpu_tensors():
    start, count, data, tiles_x, ch, mc = random_case(5, 2, 2, 3, 2)
    launches = ttc.tile_composite_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ttc.tile_composite_cuda(
            torch.tensor(start), torch.tensor(count), torch.tensor(data), tiles_x, ch, mc
        )
    assert ttc.tile_composite_cuda.launches == launches


def test_tile_composite_refuses_other_devices():
    meta = torch.empty((16, 512), device="meta")
    idx = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        ttc.tile_composite(idx, idx, meta, torch.zeros(3), 2, 3, 2)
