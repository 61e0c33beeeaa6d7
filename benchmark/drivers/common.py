"""Helpers the traffic drivers share."""

from __future__ import annotations

import torch


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(dev) -> int:
    """The process's peak of allocated device memory since the start."""
    if torch.device(dev).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def release(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def offload(inp: dict, keys: tuple) -> None:
    """Move the benchmark's own copies of the inputs that the program has
    taken over to the host, so that the device's peak is the program's."""
    for k in keys:
        v = inp[k]
        inp[k] = {a: b.cpu() for a, b in v.items()} if isinstance(v, dict) else v.cpu()


def new_count(cfg: dict) -> dict:
    """An empty least-work count for one view of ``cfg``'s size."""
    return dict(pixels=cfg["height"] * cfg["width"])


def reference_precision() -> None:
    """The reference computes in full float32: no TF32 in matrix products
    or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Marks:
    """Seconds from the process start at each named point of a run, the
    device synchronized first (for the run's details)."""

    def __init__(self, dev, t_start: float):
        self.dev, self.t_start, self.done, self.last = dev, t_start, {}, 0.0

    def __call__(self, name: str) -> None:
        import time

        sync(self.dev)
        self.last = time.perf_counter() - self.t_start
        self.done[name] = self.last
