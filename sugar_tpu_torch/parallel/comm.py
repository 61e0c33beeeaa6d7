"""The collectives of the sharded paths, written out.

In the JAX package ``shard_map`` and GSPMD insert the collectives; here
each sharded module calls them by name, on an :class:`~sugar_tpu_torch.
parallel.mesh.Axis` (a process group with this rank's place in it):

- :func:`all_gather` along dim 0 or 1, with one of two backwards that the
  caller chooses. ``"partitioned"``: the ranks consume the gathered tensor
  differently (each composites its own band), so the cotangents are summed
  and each rank keeps its slice (a reduce-scatter). ``"replicated"``: every
  rank computes the same loss on the gathered tensor, so each rank's
  cotangent is already the whole one and it keeps its slice alone (a sum
  would give ``size`` times the gradient).
- :func:`all_to_all` of equal blocks along dim 0; its backward is the
  reverse exchange, which is the same exchange.
- the partitioned backward's reduce-scatter (sum): every rank sends each
  other rank that rank's slice and sums what it receives in rank order,
  so the result is the same on every backend.
- :func:`all_reduce` (sum or max), without gradient: the overflow
  counters, the losses reported, the data-parallel gradient sum.
- :func:`ring_shift`: one hop around the group (JAX's ``ppermute``).

Under ``gloo`` a CUDA tensor always travels through a pinned host buffer
and comes back to its card: that is the rule for ranks that share a card
(NCCL refuses them), not a reaction to an error. The computation stays on
the card either way.

Every op adds the bytes of its result on this rank to its counter (the
convention of ``scripts/scaling_report.py``, which sums the output bytes
of each collective in the compiled graph), and ``host_staged`` counts the
bytes copied through host buffers. :func:`counters` reads them,
:func:`reset_counters` sets them to 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

OPS = ("all_gather", "all_to_all", "reduce_scatter", "all_reduce", "ring_shift")
_counts = dict.fromkeys(OPS + ("host_staged",), 0)


def counters() -> dict[str, int]:
    """Bytes per op since the last reset, and the host-staged bytes."""
    return dict(_counts)


def reset_counters() -> None:
    for k in _counts:
        _counts[k] = 0


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count(op: str, x: torch.Tensor) -> None:
    _counts[op] += _nbytes(x)


def _staged(axis) -> bool:
    return axis.backend == "gloo"


def _host(x: torch.Tensor, axis) -> torch.Tensor:
    """The tensor a collective takes: ``x`` itself, or under gloo a CUDA
    tensor's copy in a pinned host buffer."""
    x = x.contiguous()
    if x.is_cuda and _staged(axis):
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        _counts["host_staged"] += _nbytes(x)
        return buf
    return x


def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if y.device != like.device:
        _counts["host_staged"] += _nbytes(y)
        return y.to(like.device, non_blocking=True)
    return y


def _gather_raw(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    if x.numel() == 0:  # e.g. sh_rest at SH degree 0: nothing to send
        shape = list(x.shape)
        shape[dim] *= axis.size
        return x.new_empty(shape)
    h = _host(x, axis)
    parts = [torch.empty_like(h) for _ in range(axis.size)]
    dist.all_gather(parts, h, group=axis.group)
    out = _back(torch.cat(parts, dim=dim), x)
    _count("all_gather", out)
    return out


def _all_to_all_raw(x: torch.Tensor, axis, op: str = "all_to_all") -> torch.Tensor:
    if x.shape[0] % axis.size:
        raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) must divide by {axis.size}")
    h = _host(x, axis)
    out = torch.empty_like(h)
    dist.all_to_all_single(out, h, group=axis.group)
    out = _back(out, x)
    if op == "all_to_all":
        _count(op, out)
    return out


def _reduce_scatter_raw(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    if x.shape[dim] % axis.size:
        raise ValueError(f"reduce_scatter: dim {dim} ({x.shape[dim]}) must divide by "
                         f"{axis.size}")
    if x.numel() == 0:
        return _slice(x, axis, dim).contiguous()
    blocks = torch.stack(torch.chunk(x, axis.size, dim=dim))  # block r goes to rank r
    got = _all_to_all_raw(blocks, axis, op="reduce_scatter")  # got[r]: rank r's block for me
    out = got[0]
    for r in range(1, axis.size):
        out = out + got[r]
    _count("reduce_scatter", out)
    return out


def _slice(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, backward):
        ctx.axis, ctx.dim, ctx.backward = axis, dim, backward
        return _gather_raw(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "partitioned":
            return _reduce_scatter_raw(g, ctx.axis, ctx.dim), None, None, None
        return _slice(g, ctx.axis, ctx.dim).contiguous(), None, None, None


def all_gather(x: torch.Tensor, axis, dim: int = 0, backward: str = "partitioned"):
    """Concatenate every rank's ``x`` along ``dim`` (0 or 1) in rank
    order. ``backward`` says how the ranks use the result (module
    docstring): ``"partitioned"`` or ``"replicated"``."""
    if backward not in ("partitioned", "replicated"):
        raise ValueError(f"backward must be 'partitioned' or 'replicated', got {backward!r}")
    if dim not in (0, 1):
        raise ValueError(f"dim must be 0 or 1, got {dim}")
    return _AllGather.apply(x, axis, dim, backward)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_to_all_raw(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_raw(g, ctx.axis), None


def all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    """Dim 0 of ``x`` holds ``size`` equal blocks; block r goes to rank r,
    and block r of the result came from rank r."""
    return _AllToAll.apply(x, axis)


@torch.no_grad()
def all_reduce(x: torch.Tensor, axis, op: str = "sum") -> torch.Tensor:
    """The sum or max of every rank's ``x`` (a new tensor; no gradient)."""
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    h = _host(x, axis)
    if h is x:
        h = x.clone()
    dist.all_reduce(h, op=ops[op], group=axis.group)
    out = _back(h, x)
    _count("all_reduce", out)
    return out


@torch.no_grad()
def ring_shift(x: torch.Tensor, axis) -> torch.Tensor:
    """Send ``x`` to the next rank of the group and return the previous
    rank's (rank i receives from rank i - 1, mod size)."""
    h = _host(x, axis)
    out = torch.empty_like(h)
    nxt = axis.ranks[(axis.index + 1) % axis.size]
    prv = axis.ranks[(axis.index - 1) % axis.size]
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, h, nxt, group=axis.group),
        dist.P2POp(dist.irecv, out, prv, group=axis.group),
    ])
    for r in reqs:
        r.wait()
    out = _back(out, x)
    _count("ring_shift", out)
    return out
