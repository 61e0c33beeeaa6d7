"""Starting the ranks of a sharded run: one process per rank.

The JAX package is single-controller: one process drives every device of
a ``jax.sharding.Mesh``. The port runs one process per rank under
``torch.distributed`` instead, and the caller stays single-controller
through :func:`run_ranks`: it starts ``world`` processes, runs the same
function in each, and returns rank 0's result.

- Backend rule: ``nccl`` when the ranks run on CUDA and each has a card of
  its own (``world <= torch.cuda.device_count()``); ``gloo`` otherwise,
  that is on the CPU or when ranks share a card. NCCL refuses two ranks on
  one device.
- Devices: rank ``r`` runs on ``cuda:(r % device_count)``, or on the CPU.
- The process group meets through a ``file://`` store in a temporary
  directory, so no port is chosen. The ranks of a run are processes of
  one host, so ``gloo`` is configured to talk over the loopback interface
  (``GLOO_SOCKET_IFNAME=lo`` unless the environment names another).
- If any rank raises, every other rank is torn down and the caller gets a
  :class:`RankError` carrying the failed rank's traceback.

``fn`` is called as ``fn(device, *args)`` in each rank and must be
importable by module path (a function of this package, or of the main
script under its ``if __name__ == "__main__"`` guard): the children start
from a fresh interpreter and re-import it. Arguments and results cross as
pickles (through a file in the temporary directory, with tensors on the
host); :func:`to_device` moves the tensors inside dataclasses, dicts,
lists and tuples.

Each rank entry of the package reports its ranks' launches of the three
compositing CUDA kernels, of the binning kernels and of the preprocess
kernel (:func:`launches_by_rank`), so a caller can tell that a sharded
stage ran them.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from sugar_tpu_torch.raster.fused import bin_fused_cuda
from sugar_tpu_torch.raster.preprocess import (preprocess_fields_bwd_cuda,
                                                 preprocess_fields_cuda)
from sugar_tpu_torch.raster.segsum import segment_sum_cuda
from sugar_tpu_torch.raster.tile_composite import tile_composite_bwd_cuda, tile_composite_cuda


class RankError(RuntimeError):
    """A rank of :func:`run_ranks` raised; the message holds its traceback."""


def choose_backend(world: int, device: str) -> str:
    """``nccl`` when every rank has a CUDA card of its own, else ``gloo``."""
    if device == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device: str) -> torch.device:
    if device == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("device 'cuda' asked for, but there is no CUDA card")
        return torch.device("cuda", rank % count)
    if device == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")


def to_device(obj: Any, device) -> Any:
    """``obj`` with every tensor inside it (through dataclasses, dicts,
    lists and tuples) moved to ``device``; other leaves are kept."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init
        })
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


def kernel_launches() -> tuple[int, int, int, int, int, int]:
    """This process's launches so far of K1, K2, K3 (the compositing
    forward and backward and the gradient segment-sum), of the binning
    kernels (one a ``bin_fused`` call on the card) and of the preprocess
    kernels (the forward one a ``preprocess_fields`` render on the card,
    the backward one a backward through such a render)."""
    return (tile_composite_cuda.launches, tile_composite_bwd_cuda.launches,
            segment_sum_cuda.launches, bin_fused_cuda.launches,
            preprocess_fields_cuda.launches, preprocess_fields_bwd_cuda.launches)


def launches_by_rank(since: tuple[int, ...]) -> list[tuple[int, int, int, int, int, int]]:
    """Every rank's K1-K3, binning and preprocess launches since its own
    ``since`` (an earlier :func:`kernel_launches`), gathered over the world
    in rank order."""
    mine = tuple(a - b for a, b in zip(kernel_launches(), since))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def _record_failure(tmp: str, rank: int) -> None:
    """Note the time and traceback of this rank's failure: the first one is
    the cause, the ranks left waiting on it fail after it."""
    with open(os.path.join(tmp, f"error_rank{rank}.txt"), "w") as f:
        f.write(f"{time.time()!r}\n{traceback.format_exc()}")


def _rank_main(rank, fn, world, backend, device, tmp, threads):
    torch.set_num_threads(threads)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share one host
    try:
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=rank, world_size=world)
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    except BaseException:
        _record_failure(tmp, rank)
        raise
    try:
        out = fn(dev, *args)
        if rank == 0:
            torch.save(to_device(out, "cpu"), os.path.join(tmp, "rank0.pt"))
    except BaseException:
        _record_failure(tmp, rank)  # before the group closes under the others
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(tmp: str) -> str | None:
    """The traceback of the rank that failed first, naming the ranks that
    failed after it."""
    found = []
    for name in os.listdir(tmp):
        if name.startswith("error_rank"):
            with open(os.path.join(tmp, name)) as f:
                when, tb = f.read().split("\n", 1)
            found.append((float(when), int(name[len("error_rank"):-len(".txt")]), tb))
    if not found:
        return None
    found.sort()
    _, rank, tb = found[0]
    later = ", ".join(str(r) for _, r, _ in found[1:]) or "none"
    return f"rank {rank} raised first (ranks that failed after it: {later}):\n{tb}"


def run_ranks(
    fn: Callable,
    world: int,
    *,
    device: str = "cuda",
    args: tuple = (),
    threads: int | None = None,
) -> Any:
    """Run ``fn(device, *args)`` in ``world`` processes that form one
    ``torch.distributed`` group; returns rank 0's result with its tensors
    on the CPU. ``threads`` sets each rank's intra-op threads (default:
    the host's cores shared out among the ranks). Raises :class:`RankError`
    when a rank raises or dies."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks(device='cuda') needs a CUDA card")
    backend = choose_backend(world, device)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    tmp = tempfile.mkdtemp(prefix="sugar_ranks_")
    try:
        # The arguments go through a file, not spawn's pipe: a child reads
        # the pipe only once its interpreter is up, so a large pickle there
        # would start the children one after another.
        torch.save(to_device(args, "cpu"), os.path.join(tmp, "args.pt"))
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(fn, world, backend, device, tmp, threads))
        return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
    except ProcessException as e:
        raise RankError(_first_failure(tmp) or str(e)) from e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
