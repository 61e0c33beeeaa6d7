"""The primitives of the render path at binning scale on the card: sorts,
searchsorted, gathers, scatter-adds and cumsums. The port of the JAX
package's ``scripts/microbench_prims.py``, with its shapes, seed and
labels (N 1M Gaussians, D 4M slots).

Translations:

- ``jax.lax.sort`` with a payload is ``torch.sort(stable=...)`` plus a
  gather of the payload by the returned indices; the two-key stable sort
  is two stable passes, minor key first (depth, then tile), as
  ``raster/binning`` orders dup slots.
- torch has one ``searchsorted``, so JAX's two methods (``sort`` and
  ``scan_unrolled``) give one line.
- ``jax.ops.segment_sum`` is ``index_add_`` into zeros (torch takes no
  sortedness hint, so the sorted line differs only in its ids), and
  ``.at[].add`` is ``index_put_(accumulate=True)``.
- ``jnp.take`` along axis 0 is ``index_select``.

Times are CUDA events over ``REPS`` calls after two warm-ups, each beside
its cost per sorted key, query, lookup or added element. The first line is
the card's name and power limit.

    python -m sugar_tpu_torch.scripts.microbench_prims
"""

from __future__ import annotations

import numpy as np
import torch

from sugar_tpu_torch.utils.profiling import card_line, op_line, release, require_cuda

N = 1_000_000
D = 4_000_000
REPS = 5
WARMUP = 2


def sort_keys(k):
    return torch.sort(k).values


def sort_key_payload(k, p, stable: bool = True):
    s = torch.sort(k, stable=stable)
    return s.values, p[s.indices]


def sort_two_keys_payload(major, minor, p):
    """Stable sort by (major, minor) carrying ``p``: a stable pass on the
    minor key, then a stable pass on the major key in that order."""
    o1 = torch.sort(minor, stable=True).indices
    o2 = torch.sort(major[o1], stable=True).indices
    perm = o1[o2]
    return major[perm], minor[perm], p[perm]


def searchsorted_right(offs, d: int):
    """For each q in [0, d): the count of ``offs`` entries <= q."""
    q = torch.arange(d, dtype=offs.dtype, device=offs.device)
    return torch.searchsorted(offs, q, right=True, out_int32=True)


def gather_rows(x, i):
    return x[i]


def gather_cols(x, i):
    return x[:, i]


def take_rows(x, i):
    return torch.index_select(x, 0, i)


def segment_sum(v, i, n: int):
    """Sum the rows of ``v`` (D, C) into ``n`` segments by id ``i``."""
    return torch.zeros((n, v.shape[1]), dtype=v.dtype, device=v.device).index_add_(0, i, v)


def scatter_add(v, i, n: int):
    """``zeros((n, C)).at[i].add(v)``."""
    out = torch.zeros((n, v.shape[1]), dtype=v.dtype, device=v.device)
    return out.index_put_((i,), v, accumulate=True)


def cumsum_rows(v):
    return torch.cumsum(v, dim=1)


def cumsum_int(c):
    return torch.cumsum(c, dim=0, dtype=c.dtype)


def main() -> list[dict]:
    require_cuda("microbench_prims")
    card = card_line()
    print(f"microbench_prims on {card}", flush=True)
    g = np.random.default_rng(0)
    dev = "cuda"

    def t(x):
        return torch.as_tensor(x, device=dev)

    # The JAX script's draws, in its order.
    keys32 = t(g.integers(0, 2**31, D, dtype=np.int32))
    depth = t(g.uniform(0.2, 8.0, D).astype(np.float32))
    tile = t(g.integers(0, 1024, D, dtype=np.int32))
    payload = t(g.integers(0, N, D, dtype=np.int32))
    gid = t(g.integers(0, N, D, dtype=np.int32))
    gid_sorted = torch.sort(gid).values
    x8 = t(g.normal(size=(N, 8)).astype(np.float32))
    x16T = t(g.normal(size=(16, N)).astype(np.float32))
    vals16 = t(g.normal(size=(16, D)).astype(np.float32))
    vals8 = t(g.normal(size=(D, 8)).astype(np.float32))
    offs = torch.sort(t(g.integers(0, D, N, dtype=np.int32))).values
    f32_1m = t(g.normal(size=N).astype(np.float32))
    pay_1m = t(g.integers(0, N, N, dtype=np.int32))
    recs = []

    def op(label, fn, args, count, unit):
        recs.append(op_line(label, fn, args, count, unit, REPS, WARMUP, width=36))

    op("sort 4M int32 1key unstable:", sort_keys, (keys32,), D, "key")
    op("sort 4M int32 1key+1payload stable:", sort_key_payload, (keys32, payload), D, "key")
    op("sort 4M 2key+payload stable:", sort_two_keys_payload, (tile, depth, payload), D, "key")
    op("sort 1M f32+payload stable:", sort_key_payload, (f32_1m, pay_1m), N, "key")
    op("searchsorted 1M/4Mq:", searchsorted_right, (offs, D), D, "query")
    del keys32, depth, tile, payload, f32_1m, pay_1m
    release()

    op("gather (1M,8)[4M] rows:", gather_rows, (x8, gid), D, "lookup")
    op("gather (16,1M)[:,4M] cols:", gather_cols, (x16T, gid), D, "lookup")
    op("take (1M,8)[4M]:", take_rows, (x8, gid), D, "lookup")
    x128 = t(g.normal(size=(N // 8, 128)).astype(np.float32))
    op("gather (125k,128)[4M] rows:", gather_rows, (x128, gid % (N // 8)), D, "lookup")
    del x16T, x128
    release()

    op("segment_sum 4Mx8 -> 1M (unsorted):", segment_sum, (vals8, gid, N), D * 8, "add")
    op("segment_sum 4Mx8 -> 1M (sorted):", segment_sum, (vals8, gid_sorted, N), D * 8, "add")
    op("at[].add 4Mx8 -> 1M:", scatter_add, (vals8, gid, N), D * 8, "add")
    del vals8, x8
    release()

    op("cumsum (16,4M) axis1:", cumsum_rows, (vals16,), 16 * D, "element")
    op("cumsum 1M int32:", cumsum_int, (t(g.integers(0, 5, N, dtype=np.int32)),), N, "element")
    return recs


if __name__ == "__main__":
    main()
