"""The port's gradient segment-sum (K3's plain version) and the dup
gather's backward against the JAX package.

segment_sum_plain is held against sugar_tpu's segment_sum_sorted twice:
through its Pallas kernel (force_kernel=True, interpret mode on the CPU)
and through its pure-XLA reference path, on the cases of
tests/test_segsum.py plus segments longer than 16 slots, and on the edge
cases of the Hopper kernel's id-range blocks (no live id, live ids only
near n - 1, negative ids, n = 1, a segment longer than a staging tile,
16 slots per id over many block ranges); two of those also go through
the interpreted kernel, the rest through the reference path only.
Tolerance rtol and atol 1e-5 (the sums are taken in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_segsum import _case, _naive
from sugar_tpu.raster import pallas_render as jpr
from sugar_tpu.raster.segsum import segment_sum_sorted as jsegsum
from sugar_tpu_torch.raster import dup_gather as tdg
from sugar_tpu_torch.raster import segsum as tss

torch.set_num_threads(2)


def _sparse(rng):
    n = 50_000
    gid = np.sort(rng.choice(n, size=2048, replace=False)).astype(np.int32)
    return rng.normal(size=(16, 2048)).astype(np.float32), gid, n


def _edge(ct_rng, gid, n, rows=16):
    return ct_rng.normal(size=(rows, len(gid))).astype(np.float32), np.asarray(gid, np.int32), n


def _no_live(rng):
    return _edge(rng, np.full(300, 700), 700)  # every id is the sentinel


def _near_end(rng):
    # Live ids only at n - 3 and n - 1: the last block range holds them all.
    return _edge(rng, [697] * 3 + [699] * 2 + [700] * 40, 700)


def _negative_head(rng):
    gid = np.concatenate([-rng.integers(1, 50, 30), rng.integers(0, 500, 400), np.full(33, 500)])
    return _edge(rng, np.sort(gid), 500, rows=9)


def _n1(rng):
    return _edge(rng, [0] * 7 + [1] * 4, 1)


def _long_segment(rng):
    # One id holds 5,000 slots, more than a staging tile of the kernel.
    gid = np.sort(np.concatenate([np.arange(600), np.full(5_000, 300), np.full(21, 600)]))
    return _edge(rng, gid, 600, rows=9)


def _dense16(rng):
    # 16 slots for every id: each block range of 128 ids spans 2,048 slots.
    return _edge(rng, np.concatenate([np.repeat(np.arange(2048), 16), np.full(7, 2048)]), 2048,
                 rows=9)


CASES = {
    "small": lambda: (*_case(np.random.default_rng(0), 64, 100, 5), 64),
    "mid": lambda: (*_case(np.random.default_rng(1), 1000, 3000, 16), 1000),
    "odd_width": lambda: (*_case(np.random.default_rng(2), 300, 257, 3), 300),
    "rows9": lambda: (_case(np.random.default_rng(3), 128, 512, 4)[0][:9],
                      _case(np.random.default_rng(3), 128, 512, 4)[1], 128),
    "sparse": lambda: _sparse(np.random.default_rng(4)),
    "long_segments": lambda: (*_case(np.random.default_rng(5), 40, 2000, 90), 40),
    "no_live": lambda: _no_live(np.random.default_rng(6)),
    "near_end": lambda: _near_end(np.random.default_rng(7)),
    "negative_head": lambda: _negative_head(np.random.default_rng(8)),
    "n1": lambda: _n1(np.random.default_rng(9)),
    "long_segment_5000": lambda: _long_segment(np.random.default_rng(10)),
    "dense16": lambda: _dense16(np.random.default_rng(11)),
}
# Edge cases held against the reference path only: the TPU kernel's
# windows assume ids >= 0, and interpreted calls are kept to two new cases.
REFERENCE_ONLY = {"no_live", "negative_head", "long_segment_5000", "dense16"}
PAIRS = [(c, p) for p in ("kernel", "reference") for c in CASES
         if p == "reference" or c not in REFERENCE_ONLY]


@pytest.mark.parametrize("case,path", PAIRS, ids=[f"{c}-{p}" for c, p in PAIRS])
def test_plain_matches_jax(case, path):
    ct, gid, n = CASES[case]()
    ref = np.asarray(jsegsum(jnp.asarray(ct), jnp.asarray(gid), n,
                             force_kernel=(path == "kernel")))
    got = tss.segment_sum_plain(torch.tensor(ct), torch.tensor(gid), n).numpy()
    assert got.shape == ref.shape == (ct.shape[0], n)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    keep = gid >= 0  # _naive keeps ids < n only; negative ids are dropped too
    np.testing.assert_allclose(got, _naive(ct[:, keep], gid[keep], n), rtol=1e-5, atol=1e-5)


def test_segment_sum_sorted_dispatches_to_plain_on_cpu():
    ct, gid, n = CASES["long_segments"]()
    a = tss.segment_sum_sorted(torch.tensor(ct), torch.tensor(gid), n)
    b = tss.segment_sum_plain(torch.tensor(ct), torch.tensor(gid), n)
    assert torch.equal(a, b)
    assert int((torch.tensor(gid) >= n).sum()) > 0  # the case has sentinels


def test_kernel_wrapper_refuses_cpu_tensors():
    ct, gid, n = CASES["small"]()
    launches = tss.segment_sum_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tss.segment_sum_cuda(torch.tensor(ct), torch.tensor(gid), n)
    assert tss.segment_sum_cuda.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        tss._launch(torch.tensor(ct), torch.tensor(gid), n, torch.empty((ct.shape[0], n)))
    assert tss.segment_sum_cuda.launches == launches
    with pytest.raises(ValueError, match="device"):
        tss.segment_sum_sorted(torch.empty((2, 4), device="meta"),
                               torch.empty((4,), dtype=torch.int32, device="meta"), 3)


def _gather_case(seed=6, n=50, rows=16, live=9, d=300):
    g = np.random.default_rng(seed)
    packed = g.normal(size=(rows, n)).astype(np.float32)
    packed[live:] = 0.0
    gid = g.integers(0, n + 1, d).astype(np.int32)  # unsorted, n = sentinel
    ct = g.normal(size=(rows, d)).astype(np.float32)
    return packed, gid, ct, n, live


def _port_vjp(packed, gid, ct, n, live, exact=True):
    p = torch.tensor(packed, requires_grad=True)
    out = tdg.gather_dup(p, torch.tensor(gid), n, torch.tensor(exact), live)
    (g,) = torch.autograd.grad(out, p, torch.tensor(ct))
    return out, g


def test_gather_dup_backward_matches_jax():
    packed, gid, ct, n, live = _gather_case()
    out, g = _port_vjp(packed, gid, ct, n, live)
    counts = np.bincount(gid[gid < n], minlength=n).astype(np.int32)
    jout, vjp = jax.vjp(
        lambda p: jpr.gather_dup(p, jnp.asarray(gid), jnp.asarray(counts), jnp.asarray(True),
                                 n, live, 16),
        jnp.asarray(packed),
    )
    (jg,) = vjp(jnp.asarray(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(g[:live].numpy(), np.asarray(jg)[:live], rtol=1e-5, atol=1e-5)
    assert float(g[live:].abs().max()) == 0.0  # padding rows are constants


def test_gather_dup_backward_drops_the_sentinel():
    packed, gid, ct, n, live = _gather_case(seed=7)
    _, g = _port_vjp(packed, gid, ct, n, live)
    want = np.zeros((live, n), np.float32)
    for j, k in enumerate(gid):
        if k < n:
            want[:, k] += ct[:live, j]
    np.testing.assert_allclose(g[:live].numpy(), want, rtol=1e-5, atol=1e-5)
    assert (gid == n).any()  # column n - 1 is read for the sentinel, gets none of its grad


def test_gather_dup_backward_is_zero_when_inexact():
    packed, gid, ct, n, live = _gather_case(seed=8)
    _, g = _port_vjp(packed, gid, ct, n, live, exact=False)
    assert float(g.abs().max()) == 0.0


def test_gather_dup_backward_goes_through_the_port_function():
    packed, gid, _, n, live = _gather_case()
    out = tdg.gather_dup(torch.tensor(packed, requires_grad=True), torch.tensor(gid), n,
                         torch.tensor(True), live)
    assert type(out.grad_fn).__name__ == "GatherDupBackward"
