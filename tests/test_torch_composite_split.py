"""The host side of the compositing kernels' split into (tile, chunk)
pairs: the work list (``work_items``, the CPU replay of the kernels'
``build_items``), the pair capacity the scratch is sized by, the scratch
layout, and the deep case's early exit on the plain versions, which
replay the kernels' decomposition.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_composite import CASES as FWD_CASES
from test_torch_composite_bwd import binned_case
from sugar_tpu_torch.raster import tile_composite as ttc

torch.set_num_threads(2)
CASES = dict(FWD_CASES, binned_scene=binned_case)


@pytest.mark.parametrize("case", list(CASES))
def test_pair_capacity_holds_every_work_list(case):
    start, count, data, tiles_x, ch, max_chunks = CASES[case]()
    *_, n_chunks = ttc._tile_ranges(torch.tensor(start), torch.tensor(count), max_chunks)
    cap = ttc.pair_capacity(start.shape[0], data.shape[1], max_chunks)
    assert int(n_chunks.sum()) <= cap
    first, item_tile = ttc.work_items(n_chunks)
    assert int(first[-1]) == int(n_chunks.sum()) == item_tile.numel()


def test_pair_capacity_takes_the_smaller_bound():
    # 4 tiles of at most 2 chunks: 8; 512 slots + one shared chunk per tile: 6.
    assert ttc.pair_capacity(4, 512, 1) == 6
    assert ttc.pair_capacity(2, 1 << 20, 3) == 8
    assert ttc.pair_capacity(1, 0, 1) == 1


def test_work_items_lists_pairs_tile_major():
    first, item_tile = ttc.work_items(torch.tensor([2, 0, 3, 1], dtype=torch.int32))
    assert first.tolist() == [0, 2, 2, 5, 6]
    assert item_tile.tolist() == [0, 0, 2, 2, 2, 3]
    chunks = torch.arange(item_tile.numel()) - first[item_tile]
    assert chunks.tolist() == [0, 1, 0, 1, 2, 0]


def test_scratch_layout_follows_the_c_interface():
    fwd = ttc.fwd_scratch(num_tiles=3, capacity=5, ch=2, device="cpu")
    assert list(fwd) == ["first", "item_tile", "cross", "npart", "part"]
    assert [tuple(x.shape) for x in fwd.values()] == [(4,), (5,), (768,), (1280,), (3840,)]
    assert [x.dtype for x in fwd.values()] == [torch.int32] * 4 + [torch.float32]
    bwd = ttc.bwd_scratch(num_tiles=3, capacity=5, device="cpu")
    assert list(bwd) == ["first", "item_tile", "tot"]
    assert [tuple(x.shape) for x in bwd.values()] == [(4,), (5,), (1280,)]


def _deep():
    start, count, data, tiles_x, ch, mc = chip_smoke.deep_case(0)
    args = (torch.tensor(start), torch.tensor(count), torch.tensor(data))
    fwd = ttc.tile_composite_plain(*args, tiles_x, ch, mc)
    return args, fwd, (tiles_x, ch, mc)


def test_deep_case_walks_past_the_exit_only_in_the_local_pass():
    (start, count, _), fwd, (_, _, mc) = _deep()
    *_, n_chunks = ttc._tile_ranges(start, count, mc)
    assert n_chunks.tolist() == [49, 41, 49, 0]
    assert fwd.nch.tolist() == [49, 32, 1, 0]
    # Tile 0 stays translucent; tile 1's pixels all cross T_EPS.
    assert float(fwd.final_t[0].min()) > 1e-3
    assert float(fwd.final_t[1].max()) < 1e-2


def test_deep_case_leaks_nothing_past_the_early_exit():
    (start, count, data), fwd, (tiles_x, ch, mc) = _deep()
    assert torch.isfinite(fwd.img).all() and float(fwd.img.max()) < 1.0
    g = np.random.default_rng(5)
    g_img = torch.tensor(g.uniform(-1, 1, (4, ttc.P_TILE, ch)), dtype=torch.float32)
    gt = torch.tensor(g.uniform(-1, 1, (4, ttc.P_TILE)), dtype=torch.float32)
    d = ttc.tile_composite_bwd_plain(start, count, fwd.nch, data, g_img, gt, fwd.final_t,
                                     fwd.entry_p, tiles_x, ch, mc)
    assert torch.isfinite(d).all()
    walked_end = (int(start[2]) // ttc.C_CHUNK + int(fwd.nch[2])) * ttc.C_CHUNK
    assert float(d[:, walked_end:].abs().max()) == 0.0
    assert float(d[:, int(start[2]) : walked_end].abs().max()) > 0.0
