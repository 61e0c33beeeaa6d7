"""Device mesh topology for the sharded paths.

Port of ``sugar_tpu/parallel/mesh.py``. Axes, as in the JAX package:

- ``data``: camera parallelism; each data group renders its own views and
  the gradients are summed over the group.
- ``gauss``: Gaussian sharding (the tensor-parallel analog); parameter
  buffers, Adam moments and densify statistics are split along the
  capacity axis and gathered where the render needs them.

Here a mesh is made of ``torch.distributed`` process groups, one rank per
process (``parallel.launch``). Ranks follow JAX's device order: rank
``data_i * n_gauss + gauss_j`` sits at (data_i, gauss_j)
(``mesh.py:44-45`` reshapes the device list row-major). Each :class:`Axis`
is one process group with this rank's place in it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from sugar_tpu_torch.parallel import comm
from sugar_tpu_torch.parallel.launch import rank_device


@dataclasses.dataclass(frozen=True)
class Axis:
    """A process group and this rank's place in it."""

    group: Any  # torch.distributed ProcessGroup
    ranks: tuple[int, ...]  # global ranks, in group order
    index: int  # this rank's position in ``ranks``
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, gauss) mesh over every rank of the default group, with
    the whole group as ``world`` (the 1-D axis of the tile-sharded render
    and the ring KNN)."""

    data: Axis
    gauss: Axis
    world: Axis
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data.size, "gauss": self.gauss.size}


def new_axis(ranks) -> Axis | None:
    """An axis over the global ``ranks``; every rank of the default group
    must call this, in the same order. None on ranks outside it."""
    ranks = tuple(int(r) for r in ranks)
    group = dist.new_group(list(ranks))
    me = dist.get_rank()
    if me not in ranks:
        return None
    return Axis(group, ranks, ranks.index(me), dist.get_backend(group))


def world_axis() -> Axis:
    world = dist.get_world_size()
    return Axis(dist.group.WORLD, tuple(range(world)), dist.get_rank(), dist.get_backend())


def make_mesh(n_data: int | None = None, n_gauss: int | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """A (data, gauss) mesh over every rank; every rank must call it.
    Defaults: all ranks on ``data`` (pure camera parallelism), and this
    rank's CUDA card (``launch.rank_device``) as the device."""
    n = dist.get_world_size()
    if n_data is None and n_gauss is None:
        n_data, n_gauss = n, 1
    elif n_data is None:
        n_data = n // n_gauss
    elif n_gauss is None:
        n_gauss = n // n_data
    if n_data * n_gauss != n:
        raise ValueError(f"mesh {n_data} x {n_gauss} does not cover {n} ranks")
    gauss = data = None
    for i in range(n_data):
        a = new_axis(i * n_gauss + j for j in range(n_gauss))
        gauss = a or gauss
    for j in range(n_gauss):
        a = new_axis(i * n_gauss + j for i in range(n_data))
        data = a or data
    if device is None:
        device = rank_device(dist.get_rank(), "cuda")
    return Mesh(data=data, gauss=gauss, world=world_axis(), device=torch.device(device))


def rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's rows [index * N / size, (index + 1) * N / size) of a
    whole (N, ...) tensor."""
    if x.shape[0] % axis.size:
        raise ValueError(f"{x.shape[0]} rows do not divide by the axis size {axis.size}")
    n = x.shape[0] // axis.size
    return x[axis.index * n:(axis.index + 1) * n]


def _map(fn, tree):
    """``fn`` over every tensor of at least one dimension inside ``tree``
    (dataclasses, dicts); 0-d tensors (Adam's count) and other leaves are
    kept, as the JAX package replicates them."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.dim() >= 1 else tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree) if f.init
        })
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def shard_params(tree, axis: Axis):
    """Rank j's rows [j*cap/size, (j+1)*cap/size) of every (capacity, ...)
    leaf of a param / Adam / stats tree (JAX's ``gauss_sharding``)."""
    return _map(lambda x: rows(x, axis).contiguous(), tree)


def gather_params(tree, axis: Axis, backward: str = "partitioned"):
    """The whole (capacity, ...) leaves of a tree (or one tensor) from
    every rank's rows; see ``comm.all_gather`` for ``backward``. Bool
    leaves (alive masks) travel as uint8."""
    def one(x):
        if x.dtype == torch.bool:
            return comm.all_gather(x.to(torch.uint8), axis).to(torch.bool)
        return comm.all_gather(x, axis, 0, backward)

    return _map(one, tree)
