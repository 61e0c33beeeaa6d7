"""Sorts and gathers of the binning and the gradient reduction on the card:
the port of the JAX package's ``scripts/microbench_sort.py``, with its
shapes, seed and labels.

The default mode times the 16M and 8M binning sorts (keys alone, with a
payload, unstable and stable), the 2.56M sort of slots by Gaussian id,
gathers of (rows, 2.56M) cotangents by a permutation in both layouts, the
segment starts' searchsorted and a 5-row int32 gather. ``extra`` times the
gathers by ascending, sorted-value and random indices and the sorts
carrying 9 or 4 float payloads. ``jax.lax.sort`` with payloads is
``torch.sort`` plus a gather of each payload by the returned indices.

Times are CUDA events over ``REPS`` calls after one warm-up, each beside
its cost per sorted key or lookup. The first line is the card's name and
power limit.

    python -m sugar_tpu_torch.scripts.microbench_sort [extra]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sugar_tpu_torch.utils.profiling import card_line, op_line, release, require_cuda

REPS = 10
WARMUP = 1
D = 2_560_000
N = 1_000_000


def sort_keys(k):
    return torch.sort(k).values


def sort_key_payload(k, p, stable: bool = False):
    s = torch.sort(k, stable=stable)
    return s.values, p[s.indices]


def sort_key_payload_stable(k, p):
    return sort_key_payload(k, p, stable=True)


def gather_cols(r, p):
    return r[:, p]


def gather_rows(r, p):
    return r[p, :]


def gather_1d(r, p):
    return r[p]


def searchsorted_left(k, q):
    return torch.searchsorted(k, q, right=False, out_int32=True)


def sort_payload_rows(k, r):
    """Sort ``k`` carrying each row of ``r`` as a payload; returns the
    first payload, as the JAX script does."""
    return r[:, torch.sort(k).indices][0]


def sort_pair_then_gather(k, r):
    """Sort (key, slot), then gather the columns of ``r`` by the slots."""
    slot = torch.arange(k.shape[0], dtype=torch.int32, device=k.device)
    return r[:, slot[torch.sort(k).indices]]


def _op(recs, label, fn, args, count, unit):
    recs.append(op_line(label, fn, args, count, unit, REPS, WARMUP))


def run_main(g, t) -> list[dict]:
    recs = []
    for m in (16, 8):
        d = m * 1_000_000
        keys = t(g.integers(0, 2**30, d, dtype=np.int32))
        pay = t(g.integers(0, 2**30, d, dtype=np.int32))
        _op(recs, f"sort {m}M 1-array unstable", sort_keys, (keys,), d, "key")
        _op(recs, f"sort {m}M key+payload unstable", sort_key_payload, (keys, pay), d, "key")
        _op(recs, f"sort {m}M key+payload stable", sort_key_payload_stable, (keys, pay), d, "key")
        del keys, pay
        release()

    keys = t(g.integers(0, N, D, dtype=np.int32))
    pay = t(g.integers(0, D, D, dtype=np.int32))
    _op(recs, "sort 2.56M key+payload unstable", sort_key_payload, (keys, pay), D, "key")
    rows9_np = g.normal(size=(9, D)).astype(np.float32)
    rows9 = t(rows9_np)
    perm = t(g.permutation(D).astype(np.int32))
    _op(recs, "gather (9, 2.56M) by perm", gather_cols, (rows9, perm), D, "lookup")
    rows16_np = g.normal(size=(16, D)).astype(np.float32)
    rows16 = t(rows16_np)
    _op(recs, "gather (16, 2.56M) by perm", gather_cols, (rows16, perm), D, "lookup")
    _op(recs, "gather (1, 2.56M) by perm", gather_1d, (rows9[0], perm), D, "lookup")
    # The transposed layout: rows of (D, 9) gathered by the permutation.
    _op(recs, "gather (2.56M, 9) rows by perm", gather_rows,
        (t(np.ascontiguousarray(rows9_np.T)), perm), D, "lookup")
    _op(recs, "gather (2.56M, 16) rows by perm", gather_rows,
        (t(np.ascontiguousarray(rows16_np.T)), perm), D, "lookup")
    del rows16
    release()
    # The segment starts: searchsorted at segment-start scale.
    q = torch.arange(N + 1, dtype=torch.int32, device=keys.device)
    _op(recs, "searchsorted 2.56M keys / 1M q (sort)", searchsorted_left,
        (torch.sort(keys).values, q), N + 1, "query")
    # An int32 bit-packed gather: 5 rows instead of 9.
    rows5 = t(g.integers(0, 2**30, (5, D), dtype=np.int32))
    _op(recs, "gather (5, 2.56M) int32 by perm", gather_cols, (rows5, perm), D, "lookup")
    return recs


def run_extra(g, t) -> list[dict]:
    recs = []
    g.integers(0, N, D)  # the JAX script's unused ascending gid: kept for the draw order
    perm_rand = t(g.permutation(D).astype(np.int32))
    rows9 = t(g.normal(size=(9, D)).astype(np.float32))
    _op(recs, "gather (9,D) ascending idx", gather_cols,
        (rows9, torch.arange(D, dtype=torch.int32, device=rows9.device)), D, "lookup")
    _op(recs, "gather (9,D) sorted-val idx", gather_cols,
        (rows9, t(np.sort(g.integers(0, D, D)).astype(np.int32))), D, "lookup")
    _op(recs, "gather (9,D) random idx", gather_cols, (rows9, perm_rand), D, "lookup")
    keys = t(g.integers(0, N, D, dtype=np.int32))
    _op(recs, "sort key + 9 f32 payload 2.56M", sort_payload_rows, (keys, rows9), D, "key")
    _op(recs, "sort key + 4 f32 payload 2.56M", sort_payload_rows, (keys, rows9[:4]), D, "key")
    _op(recs, "sort pair + gather (9,D) real perm", sort_pair_then_gather, (keys, rows9), D, "key")
    return recs


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="main", choices=["main", "extra"])
    a = ap.parse_args(argv)
    require_cuda("microbench_sort")
    card = card_line()
    print(f"microbench_sort ({a.mode}) on {card}", flush=True)
    g = np.random.default_rng(0)

    def t(x):
        return torch.as_tensor(x, device="cuda")

    recs = (run_extra if a.mode == "extra" else run_main)(g, t)
    release()
    return recs


if __name__ == "__main__":
    main()
