"""Exact k-nearest-neighbor search.

Port of ``sugar_tpu/fields/knn.py`` (which replaces PyTorch3D
``knn_points``, sugar_model.py:49, 1028, and simple-knn). Brute force over
reference chunks: squared distances ||q||^2 - 2 q.r + ||r||^2 per (query
chunk, reference chunk) block, a top-k per block, and a merge of the
blocks' candidates. Masked (dead or padded) references get +inf distance,
so fixed-capacity model buffers can be passed directly.

The result is the JAX package's exactly, whatever the chunk sizes: the k
smallest (distance, index) pairs in lexicographic order, so that equal
distances (the exact duplicate points densify's clones leave) list the
lower index first, as ``lax.top_k`` and the JAX merge order do. Slots with
no alive reference left hold (+inf, 0), as the JAX carry's initial value
does, and distances are clamped at 0. The 3-term dot is written out
elementwise, so the result does not depend on the matmul precision
setting (TF32).

Plain torch ops; a hand-written kernel is for when an H100 profile shows
it pays (PERF.md).
"""

from __future__ import annotations

import torch


def _sq_dists(qc: torch.Tensor, qq: torch.Tensor, rc: torch.Tensor, rr: torch.Tensor) -> torch.Tensor:
    """(Qc, Rc) squared distances, (||q||^2 - 2 q.r) + ||r||^2 in the JAX
    package's order; +inf where ``rr`` is (a masked reference)."""
    dot = qc[:, 0:1] * rc[:, 0]
    dot.addcmul_(qc[:, 1:2], rc[:, 1])
    dot.addcmul_(qc[:, 2:3], rc[:, 2])
    return torch.sub(qq, dot, alpha=2.0).add_(rr)


def _lexsort_top(d: torch.Tensor, i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (d, i) pairs of each row, in lexicographic order
    (indices unique within a row)."""
    o = torch.argsort(i, dim=1)
    d, i = d.gather(1, o), i.gather(1, o)
    o = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return d.gather(1, o), i.gather(1, o)


def _candidates(qc, qq, refs_safe, rr_all, k: int, r_chunk: int):
    """(Qc, >= k) candidate (distance, index) pairs of the query chunk
    ``qc`` against every reference, holding the k smallest pairs of each
    row in lexicographic order: each reference chunk's k + 1 smallest,
    with the chunk redone by a stable sort on the rows where the k-th and
    (k+1)-th tie; padded with (+inf, 0) up to k columns."""
    dev = qc.device
    r_n = refs_safe.shape[0]
    pool_d, pool_i, ties = [], [], []
    for r0 in range(0, r_n, r_chunk):
        d = _sq_dists(qc, qq, refs_safe[r0:r0 + r_chunk], rr_all[r0:r0 + r_chunk])
        if d.shape[1] <= k + 1:  # a narrow last chunk: keep every column
            v, p = d, torch.arange(d.shape[1], device=dev).expand_as(d)
            ties.append(torch.zeros(d.shape[0], dtype=torch.bool, device=dev))
        else:
            # The block's k + 1 smallest. When the k-th and (k+1)-th are
            # equal (and finite), the k smallest are ambiguous: that
            # row of the block is redone by a stable sort below.
            v, p = torch.topk(d, k + 1, dim=1, largest=False, sorted=True)
            ties.append((v[:, k - 1] == v[:, k]) & torch.isfinite(v[:, k]))
        pool_d.append(v)
        pool_i.append(p + r0)
    ties = torch.stack(ties)
    for b in ties.any(1).nonzero()[:, 0].tolist():  # one device read per query chunk
        rows = ties[b].nonzero()[:, 0]
        r0 = b * r_chunk
        d = _sq_dists(qc[rows], qq[rows], refs_safe[r0:r0 + r_chunk], rr_all[r0:r0 + r_chunk])
        v, p = torch.sort(d, dim=1, stable=True)
        pool_d[b][rows] = v[:, :k + 1]
        pool_i[b][rows] = p[:, :k + 1] + r0
    d_all, i_all = torch.cat(pool_d, 1), torch.cat(pool_i, 1)
    if d_all.shape[1] < k:
        pad = k - d_all.shape[1]
        d_all = torch.cat([d_all, d_all.new_full((d_all.shape[0], pad), float("inf"))], 1)
        i_all = torch.cat([i_all, i_all.new_zeros(i_all.shape[0], pad)], 1)
    return d_all, i_all


def masked_refs(refs: torch.Tensor, ref_mask: torch.Tensor):
    """(refs with masked rows zeroed, ||r||^2 with +inf on masked rows)."""
    inf = torch.tensor(float("inf"), device=refs.device)
    return torch.where(ref_mask[:, None], refs, 0.0), torch.where(ref_mask, (refs * refs).sum(-1),
                                                                   inf)


def finish(d: torch.Tensor, i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's carry starts at (+inf, 0) and wins every tie at +inf; distances
    are clamped at 0."""
    return torch.clamp_min(d, 0.0), torch.where(torch.isinf(d), 0, i)


@torch.no_grad()
def knn(
    queries: torch.Tensor,  # (Q, 3)
    refs: torch.Tensor,  # (R, 3)
    k: int,
    ref_mask: torch.Tensor | None = None,  # (R,) bool
    q_chunk: int = 4096,
    r_chunk: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sq_dists (Q, k) float32, idx (Q, k) int64) sorted ascending,
    like pytorch3d.ops.knn_points (self-matches included when queries ==
    refs), on the queries' device."""
    dev = queries.device
    q_n, r_n = queries.shape[0], refs.shape[0]
    if ref_mask is None:
        ref_mask = torch.ones(r_n, dtype=torch.bool, device=dev)
    refs_safe, rr_all = masked_refs(refs, ref_mask)
    out_d, out_i = [], []
    for q0 in range(0, q_n, q_chunk):
        qc = queries[q0:q0 + q_chunk]
        qq = (qc * qc).sum(-1, keepdim=True)
        d_k, i_k = _lexsort_top(*_candidates(qc, qq, refs_safe, rr_all, k, r_chunk), k)
        out_d.append(d_k)
        out_i.append(i_k)
    if not out_d:
        return (torch.zeros((0, k), device=dev),
                torch.zeros((0, k), dtype=torch.int64, device=dev))
    return finish(torch.cat(out_d), torch.cat(out_i))
