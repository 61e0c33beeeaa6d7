"""What the per-layer metrics read from a traced run's context.

The context (``layer_ctx`` of a driver's outcome) holds the profile of a
few steps or views (``prof``, from ``trace.summarize``), how many
(``units``), the reference's least-work count of each (``counts``), the
operations each needs (``ops``), the time one takes in the window
(``unit_s``) and its ``role``, ``train`` or ``serve``. A reader returns
None where its role or its kernel does not occur, and the harness then
leaves the metric out of the line.
"""

from __future__ import annotations

from benchmark import counts as C
from benchmark.frozen import PEAK_FP32_PER_S


def _mine(ctx: dict, role: str) -> bool:
    return ctx.get("role") == role and bool(ctx.get("prof"))


def launches_per_unit(ctx: dict, role: str):
    if not _mine(ctx, role):
        return None
    return ctx["prof"]["launches"] / ctx["units"]


def idle_share(ctx: dict, role: str):
    if not _mine(ctx, role):
        return None
    p = ctx["prof"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def mfu(ctx: dict, role: str):
    """The needed fp32 operations of a step or view over its time in the
    window, as a share of the fp32 peak."""
    if not _mine(ctx, role) or not ctx.get("counts"):
        return None
    ops = sum(ctx["ops"]) / len(ctx["ops"])
    return 100.0 * ops / ctx["unit_s"] / PEAK_FP32_PER_S


def torch_ops_ms(ctx: dict, role: str):
    """Device ms per step or view in every kernel but K1, K2 and K3."""
    if not _mine(ctx, role):
        return None
    p = ctx["prof"]
    return 1e3 * (p["busy_s"] - p["k1_s"] - p["k2_s"] - p["k3_s"]) / ctx["units"]


_LEAST = dict(k1=C.k1_least_s, k2=C.k2_least_s, k3=C.k3_least_s)


def roofline(ctx: dict, role: str, kernel: str):
    """The least time of the kernel's needed work on the profiled steps or
    views over the kernel's device time on them (every sub-kernel)."""
    if not _mine(ctx, role) or not ctx.get("counts"):
        return None
    spent = ctx["prof"][f"{kernel}_s"]
    if spent <= 0:
        return None
    least = sum(_LEAST[kernel](c, ctx["ch"]) for c in ctx["counts"])
    return 100.0 * least / spent
