"""Lightweight profiling/telemetry.

Port of ``sugar_tpu/utils/profiling.py``, which replaces the reference's
CUDA-event timing + tensorboard iter_time (gaussian_splatting/train.py:
44-67, 160): a stage timer that waits for the card where the work ran
(CUDA launches return before the work is done), and a ``torch.profiler``
trace written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _wait_for(block_on) -> None:
    """Synchronize each CUDA device that holds a tensor of ``block_on`` (a
    tensor or a dict/list/tuple of them); CPU tensors are ready already."""
    for dev in {t.device for t in _tensors(block_on) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates wall-clock per named stage; waits for the card's results
    so timings are real (launches are asynchronous)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _wait_for(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: dict(total_s=self.totals[k], count=self.counts[k],
                    mean_ms=1e3 * self.totals[k] / max(self.counts[k], 1))
            for k in self.totals
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block (the CPU, and the card when there
    is one), written to ``<log_dir>/trace.json`` (chrome://tracing,
    Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
