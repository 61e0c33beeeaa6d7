"""Dup-gather layouts and binning sorts at bench scale on the card: the port
of the JAX package's ``scripts/microbench_gather.py``, with its shapes,
seed and labels.

The forward gather of the (9-row, 2.23M-slot) dup view as a column gather
of (9, N), a row gather of (N, 16) or (N, 8), and a row gather plus
transpose; the backward's sort of the slots by Gaussian id plus a gather
of the cotangent; the 16M and 8M binning sorts with and without a
payload; a 1-D gather at D. ``jax.lax.sort`` with payloads is
``torch.sort`` plus a gather of each payload by its indices (torch sorts
one key and returns the permutation); a sort "with 9 payloads" is one sort
and a 9-row gather.

Times are CUDA events over ``REPS`` calls after two warm-ups (the 16M and
8M sorts over ``SORT_REPS``), each beside its cost per sorted key or per
lookup. The first line is the card's name and power limit.

    python -m sugar_tpu_torch.scripts.microbench_gather
"""

from __future__ import annotations

import numpy as np
import torch

from sugar_tpu_torch.utils.profiling import card_line, op_line, release, require_cuda

N = 1_000_000
D = 2_230_000  # ~ num_rendered at bench scale
E = 16_000_000  # dense expansion N * tile_cap
REPS = 5
SORT_REPS = 3
WARMUP = 2


def col_gather(p, i):
    return p[:, i]


def row_gather(p, i):
    return p[i, :]


def row_gather_transposed(p, i):
    return p[i, :].T.contiguous()


def sort_slots_col_gather(c, i):
    """The backward's order: slots sorted by Gaussian id (unstable), the
    cotangent columns gathered into it."""
    s = torch.sort(i)
    slot = torch.arange(i.shape[0], dtype=torch.int32, device=i.device)
    return s.values, c[:, slot[s.indices]]


def sort_slots_row_gather(c, i):
    s = torch.sort(i)
    slot = torch.arange(i.shape[0], dtype=torch.int32, device=i.device)
    return s.values, c[slot[s.indices], :]


def sort_payload_rows(c, i):
    """Sort the ids carrying every row of ``c`` as a payload; returns the
    first payload, as the JAX script does."""
    return c[:, torch.sort(i).indices][0]


def sort_key_payload(k, p, stable: bool = False):
    s = torch.sort(k, stable=stable)
    return s.values, p[s.indices]


def sort_key(k):
    return torch.sort(k).values


def sort_key_then_gather(k, gs):
    """Sort packed keys alone, keep the first D, and read each one's rank
    (low 20 bits) to gather its Gaussian id. A rank past the end of ``gs``
    reads its last entry, as JAX clamps a gather's indices (and torch
    would fault)."""
    sk = torch.sort(k).values[:D]
    rank = torch.clamp(sk & ((1 << 20) - 1), max=gs.shape[0] - 1)
    return sk >> 20, gs[rank]


def gather_1d(m, r):
    return m[r]


def main() -> list[dict]:
    require_cuda("microbench_gather")
    card = card_line()
    print(f"microbench_gather on {card}", flush=True)
    g = np.random.default_rng(0)
    dev = "cuda"

    def t(x):
        return torch.as_tensor(x, device=dev)

    gid = t(g.integers(0, N, D, dtype=np.int32))
    packed_cm = t(g.normal(size=(9, N)).astype(np.float32))
    packed_rm16 = t(g.normal(size=(N, 16)).astype(np.float32))
    packed_rm8 = t(g.normal(size=(N, 8)).astype(np.float32))
    ct = t(g.normal(size=(9, D)).astype(np.float32))
    ct_rm = t(g.normal(size=(D, 16)).astype(np.float32))
    recs = []

    def op(label, fn, args, count, unit, reps=REPS):
        recs.append(op_line(label, fn, args, count, unit, reps, WARMUP))

    # Forward gather layouts.
    op("col gather (9,N)[:,gid] -> (9,D)", col_gather, (packed_cm, gid), D, "lookup")
    op("row gather (N,16)[gid] -> (D,16)", row_gather, (packed_rm16, gid), D, "lookup")
    op("row gather (N,8)[gid] -> (D,8)", row_gather, (packed_rm8, gid), D, "lookup")
    op("row gather (N,16) + transpose -> (16,D)", row_gather_transposed, (packed_rm16, gid), D,
       "lookup")
    # Backward: sort by gid + gather, against a sort carrying the payload.
    op("bwd: sort(gid,slot) + col gather ct", sort_slots_col_gather, (ct, gid), D, "key")
    op("bwd: sort(gid,slot) + row gather ct_rm", sort_slots_row_gather, (ct_rm, gid), D, "key")
    op("bwd: sort gid + 9 f32 payloads", sort_payload_rows, (ct, gid), D, "key")
    del packed_cm, packed_rm16, packed_rm8, ct, ct_rm
    release()

    # Binning sorts at expansion scale.
    key_e = t(g.integers(0, 2**30, E, dtype=np.int32))
    pay_e = t(g.integers(0, N, E, dtype=np.int32))
    op("16M sort key+payload", sort_key_payload, (key_e, pay_e), E, "key", SORT_REPS)
    op("16M sort key only", sort_key, (key_e,), E, "key", SORT_REPS)
    op("16M sort key only + gather gid at D", sort_key_then_gather,
       (key_e, t(g.integers(0, N, N, dtype=np.int32))), E, "key", SORT_REPS)
    # The 8M variant (tile_cap 8).
    op("8M sort key+payload", sort_key_payload, (key_e[:8_000_000], pay_e[:8_000_000]),
       8_000_000, "key", SORT_REPS)
    del key_e, pay_e
    release()

    # 1-D gather at D scale (rank -> gid map).
    rank = t(g.integers(0, N, D, dtype=np.int32))
    gmap = t(g.integers(0, N, N, dtype=np.int32))
    op("1D gather gmap[rank] (D,)", gather_1d, (gmap, rank), D, "lookup")
    return recs


if __name__ == "__main__":
    main()
