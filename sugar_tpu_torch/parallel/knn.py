"""Exact k-NN with the references passed around a ring of ranks.

Port of ``sugar_tpu/parallel/knn.py`` (``knn_sharded``). Queries and
references are split over the ranks of one axis. Each of the ``size`` ring
steps searches this rank's queries against the reference shard it holds
(the single-device search of ``fields.knn``, chunk by chunk), merges the
candidates into a running top-k, and passes the shard and its mask one hop
on (``comm.ring_shift``; after t hops rank i holds the shard that started
on rank i - t). Every rank meets every reference once and holds no more
than 1/size of them at a time. Counts that do not divide by the axis size
are padded (padded references are masked, padded query rows dropped).

The result is ``fields.knn.knn``'s on the whole arrays, exactly: the
running top-k keeps the k smallest (distance, index) pairs in
lexicographic order, and the distances are the same float32 values. Where
fewer than k references are unmasked, the slots left hold (+inf, 0), the
single-device answer; the JAX ring returns padded indices >= R there
(``sugar_tpu/parallel/knn.py:90``, ROADMAP queue 3).
"""

from __future__ import annotations

import torch

from sugar_tpu_torch.fields.knn import _candidates, _lexsort_top, finish, masked_refs
from sugar_tpu_torch.parallel import comm
from sugar_tpu_torch.parallel.mesh import Axis


def _pad_rows(x: torch.Tensor, mult: int, fill=0) -> torch.Tensor:
    r = (-x.shape[0]) % mult
    if r == 0:
        return x
    return torch.cat([x, x.new_full((r,) + tuple(x.shape[1:]), fill)])


@torch.no_grad()
def knn_sharded(
    axis: Axis,
    queries: torch.Tensor,  # (Q, 3), the whole array on every rank
    refs: torch.Tensor,  # (R, 3)
    k: int,
    ref_mask: torch.Tensor | None = None,  # (R,) bool
    q_chunk: int = 4096,
    r_chunk: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sq_dists (Q, k) float32, global idx (Q, k) int64) sorted
    ascending, the whole result on every rank; each rank searches its own
    rows of the queries."""
    s = axis.size
    q_n = queries.shape[0]
    if ref_mask is None:
        ref_mask = torch.ones(refs.shape[0], dtype=torch.bool, device=refs.device)
    queries = _pad_rows(queries, s)
    refs = _pad_rows(refs, s)
    mask = _pad_rows(ref_mask.to(torch.uint8), s)
    ql, shard = queries.shape[0] // s, refs.shape[0] // s
    q_loc = queries[axis.index * ql:(axis.index + 1) * ql]
    r_cur = refs[axis.index * shard:(axis.index + 1) * shard].contiguous()
    m_cur = mask[axis.index * shard:(axis.index + 1) * shard].contiguous()

    # Running top-k; the initial entries lose to any real pair.
    sentinel = refs.shape[0]
    best_d = q_loc.new_full((ql, k), float("inf"))
    best_i = torch.full((ql, k), sentinel, dtype=torch.int64, device=q_loc.device)
    qq = (q_loc * q_loc).sum(-1, keepdim=True)
    for step in range(s):
        base = ((axis.index - step) % s) * shard
        refs_safe, rr = masked_refs(r_cur, m_cur.to(torch.bool))
        for q0 in range(0, ql, q_chunk):
            sl = slice(q0, q0 + q_chunk)
            d_c, i_c = _candidates(q_loc[sl], qq[sl], refs_safe, rr, k, r_chunk)
            best_d[sl], best_i[sl] = _lexsort_top(torch.cat([best_d[sl], d_c], 1),
                                                  torch.cat([best_i[sl], i_c + base], 1), k)
        if step < s - 1:
            r_cur = comm.ring_shift(r_cur, axis)
            m_cur = comm.ring_shift(m_cur, axis)
    d = comm.all_gather(best_d, axis)[:q_n]
    i = comm.all_gather(best_i, axis)[:q_n]
    return finish(d, i)
