"""Reading a ``torch.profiler`` window: device activities by kernel, the
busy time, the kernels of K1, K2 and K3, the longest idle gaps labelled by
what the host was doing, and the contract's ``breakdown``.

Busy time is the union of the device activities' intervals. K1 is the
compositing forward's sub-kernels (``fwd_local``, ``fwd_scan``,
``fwd_cross``), K2 the backward's (``bwd_total``, ``bwd_grad``), K3
``segment_sum_kernel``; both K1 and K2 start with the shared
``build_items`` launch, which is given to the kernel launched after it.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark.frozen import kernel_name

K1_PARTS = ("fwd_local", "fwd_scan", "fwd_cross")
K2_PARTS = ("bwd_total", "bwd_grad")
K3_PARTS = ("segment_sum_kernel",)
SHARED = "build_items"


def _kernel_of(name: str) -> str | None:
    for key, parts in (("k1", K1_PARTS), ("k2", K2_PARTS), ("k3", K3_PARTS)):
        if any(p in name for p in parts):
            return key
    return None


@contextlib.contextmanager
def profiled(enabled: bool, dev="cuda"):
    """Yields a dict that holds, after the block, the profile summary of the
    block (or nothing when not enabled). The device is synchronized before
    and after the block, and the wall time taken between the two."""
    box: dict = {}
    if not enabled:
        yield box
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(dev).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield box
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    box.update(summarize(prof.events(), wall))


def summarize(events, wall_s: float) -> dict:
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, kernel_name(e.name)))
        else:
            host.append((tr.start, tr.end, e.name))
    dev.sort()
    kernels = [d for d in dev if not d[2].startswith(("Memcpy", "Memset"))]
    by_name: dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    parts = {"k1": 0.0, "k2": 0.0, "k3": 0.0}
    for i, (s, e, n) in enumerate(kernels):
        key = _kernel_of(n)
        if key is None and SHARED in n and i + 1 < len(kernels):
            key = _kernel_of(kernels[i + 1][2])
        if key is not None:
            parts[key] += (e - s) / 1e6
    busy, gaps, end = 0.0, [], None
    for s, e, _ in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_host_label(host, g0), (g1 - g0) / 1e6] for g0, g1 in gaps[:10]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy / 1e6, window_s=wall_s, launches=len(kernels), k1_s=parts["k1"],
                k2_s=parts["k2"], k3_s=parts["k3"],
                breakdown=dict(device_ops=[[n, t] for n, t in ops], idle_gaps=idle))


def _host_label(host, t) -> str:
    """The innermost host event open at time ``t``."""
    best = None
    for s, e, n in host:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return best[2] if best else "host idle"
