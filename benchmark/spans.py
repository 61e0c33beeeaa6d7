"""What the per-layer metrics read from the program's own spans and
counters (``sugar_tpu_torch.utils.profiling``), recorded while the traced
run's profiler collected.

Every number is per step or per view: a sum over the recorded spans or
counters divided by the context's ``units``. A reader returns None where
its role does not match, where nothing was recorded (a program without
the recorder), and for a device time where no span has a device interval
(a CPU run).
"""

from __future__ import annotations

# The spans of a whole step or view; every other span is a stage.
TOP = ("train.step", "refine.step", "render.model")


def _recorded(ctx: dict, role: str):
    if ctx.get("role") != role or not ctx.get("units"):
        return None
    from sugar_tpu_torch.utils import profiling

    read = getattr(profiling, "recorded", None)
    rec = read() if read is not None else None
    return rec if rec and rec["spans"] else None


def _device_spans(ctx: dict, role: str):
    rec = _recorded(ctx, role)
    if rec is None or any(s["device_ms"] is None for s in rec["spans"]):
        return None
    return rec["spans"]


def device_ms(ctx: dict, role: str, names: tuple, self_only: bool = True):
    """Device ms per unit in the spans ``names``: their self time (less
    their children's), or with ``self_only`` False their whole interval."""
    spans = _device_spans(ctx, role)
    if spans is None:
        return None
    key = "device_self_ms" if self_only else "device_ms"
    return sum(s[key] for s in spans if s["name"] in names) / ctx["units"]


def host_ms(ctx: dict, role: str, names: tuple):
    """Host ms per unit in the spans ``names``."""
    rec = _recorded(ctx, role)
    if rec is None:
        return None
    return sum(s["host_ms"] for s in rec["spans"] if s["name"] in names) / ctx["units"]


def outside_stages_ms(ctx: dict, role: str):
    """Device ms per unit, from the first span's start to the last span's
    end, that lies in no stage's span (only in ``TOP`` spans or none)."""
    spans = _device_spans(ctx, role)
    if spans is None:
        return None
    start = min(s["device_start_ns"] for s in spans)
    end = max(s["device_end_ns"] for s in spans)
    covered, reach = 0.0, start
    stages = sorted((s["device_start_ns"], s["device_end_ns"]) for s in spans
                    if s["name"] not in TOP)
    for s0, s1 in stages:
        s0 = max(s0, reach)
        if s1 > s0:
            covered += s1 - s0
            reach = s1
    return (end - start - covered) / 1e6 / ctx["units"]


def bin_yield(ctx: dict, role: str):
    """100 x the slots binning kept over the slots its expansion tested."""
    rec = _recorded(ctx, role)
    if rec is None:
        return None
    total = {"raster.slots_kept": 0, "raster.slots_tested": 0}
    for c in rec["counters"]:
        if c["name"] in total:
            total[c["name"]] += c["value"]
    if total["raster.slots_tested"] == 0:
        return None
    return 100.0 * total["raster.slots_kept"] / total["raster.slots_tested"]
