"""Lightweight profiling/telemetry.

Port of ``sugar_tpu/utils/profiling.py``, which replaces the reference's
CUDA-event timing + tensorboard iter_time (gaussian_splatting/train.py:
44-67, 160): a stage timer that waits for the card where the work ran
(CUDA launches return before the work is done), a ``torch.profiler``
trace written as a Chrome trace, and the helpers of the measurement entry
points (``scripts/bench.py``, ``profile_*``, ``microbench_*``): the card's
name and power limit, a refusal to measure without a card, and a kernel
time from CUDA events.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
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


def require_cuda(tool: str) -> None:
    """Raise unless a CUDA card is present: a measurement never falls back
    to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool} measures the CUDA card; torch.cuda.is_available() is False")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over ``reps`` back-to-back calls, from two
    CUDA events around them, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_line(name: str, fn, reps: int, warmup: int = 1, width: int = 40) -> float:
    """``cuda_ms`` of fn(), printed as one ``name  ms`` line; returns the ms."""
    ms = cuda_ms(fn, reps, warmup)
    print(f"{name:{width}s} {ms:10.4f} ms", flush=True)
    return ms


def op_line(label: str, fn, args: tuple, count: int, unit: str, reps: int, warmup: int,
            width: int = 44) -> dict:
    """``cuda_ms`` of fn(*args), printed with its cost per ``unit`` (``count``
    of them per call: keys sorted, lookups, added elements, queries);
    returns {label, ms, count, unit, ns_per}."""
    ms = cuda_ms(lambda: fn(*args), reps, warmup)
    ns = ms * 1e6 / count
    print(f"{label:{width}s} {ms:10.4f} ms {ns:9.4f} ns/{unit}", flush=True)
    return dict(label=label, ms=ms, count=count, unit=unit, ns_per=ns)


def release() -> None:
    """Return the caching allocator's free blocks to the card between
    measurements, so a later one times its own allocations."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
