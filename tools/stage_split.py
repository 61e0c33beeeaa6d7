"""Per-stage split of one traced run of a benchmark cell, from the port's
own spans and counters (``sugar_tpu_torch.utils.profiling``).

It runs the cell as ``python3 -m benchmark.run --trace 1`` does
(``benchmark.run.run_cell``) and prints one JSON object: the result line's
metrics and device fields; for each span name its count, host ms, device
ms and self device ms per step or view, and the device's busy ms inside
its interval (the union of the profiler's device activities, whole and
less its children's: the interval less busy is the device waiting on the
host); the counters; the sum check (the
self device ms of every span but the top ones, plus the device ms outside
every stage, against the profiled window per step or view); and for the
``--gaps`` longest device idle gaps of the window, their ms, the
innermost host event open when each began and the innermost span open
then.

Run from the repository root on a machine with a CUDA card:

    python3 tools/stage_split.py --workload train_vanilla_7k --seed 7 [--seconds 30]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def gap_spans(events, names: set, k: int) -> list:
    """The ``k`` longest gaps between device activities of a profile: ms,
    the innermost host event open at each gap's start, and the innermost
    host event among ``names`` (the spans) open then."""
    import torch

    dev, host = [], []
    for e in events:
        tr = e.time_range
        (dev if e.device_type == torch.autograd.DeviceType.CUDA else host).append(
            (tr.start, tr.end, e.name))
    dev.sort()
    gaps, end = [], None
    for s, e, _ in dev:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])

    def innermost(t, pool):
        best = None
        for s, e, n in pool:
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best[2] if best else None

    named = [h for h in host if h[2] in names]
    return [dict(ms=(g1 - g0) / 1e3, host=innermost(g0, host), span=innermost(g0, named))
            for g0, g1 in gaps[:k]]


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ms(events, spans: list) -> dict:
    """Per span id, the ms inside its device interval during which the
    profiler saw a device activity. The profiler's clock is put on the
    spans' host clock by the median offset between each span's host start
    and its record function's in the trace."""
    import bisect
    import statistics

    import torch

    marks: dict = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            marks.setdefault(e.name, []).append(e.time_range.start)
    offsets = []
    for name in {s["name"] for s in spans}:
        mine = sorted(s["host_start_ns"] for s in spans if s["name"] == name)
        theirs = sorted(marks.get(name, []))
        if len(mine) == len(theirs):
            offsets += [1e3 * t - m for t, m in zip(theirs, mine)]
    if not offsets:
        return {}
    off = statistics.median(offsets)
    dev = _merged([(1e3 * e.time_range.start - off, 1e3 * e.time_range.end - off)
                   for e in events if e.device_type == torch.autograd.DeviceType.CUDA])
    starts = [d[0] for d in dev]
    cum = [0.0]
    for s, e in dev:
        cum.append(cum[-1] + e - s)

    def covered(t):  # busy ns before t
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0.0
        s, e = dev[i - 1]
        return cum[i - 1] + min(t, e) - s

    return {s["id"]: (covered(s["device_end_ns"]) - covered(s["device_start_ns"])) / 1e6
            for s in spans}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--gaps", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    from benchmark import run, spans, trace
    from benchmark.frozen import card_line, require_cuda
    from sugar_tpu_torch.utils import profiling

    require_cuda("stage_split")
    spec = run.load_spec()
    kept = {}
    summarize = trace.summarize

    def keep_events(events, wall_s):
        kept["events"] = list(events)
        return summarize(events, wall_s)

    trace.summarize = keep_events
    torch.cuda.reset_peak_memory_stats()
    profiling.reset()
    line = run.run_cell(spec, args.workload, args.seed, args.seconds, True, "cuda", T_START)
    rec = profiling.recorded()
    summ = profiling.summary(rec)
    units = sum(1 for s in rec["spans"] if s["name"] in spans.TOP)
    role = "serve" if run.cell_parts(spec, args.workload)[2]["kind"] == "serve_orbit" else "train"
    ctx = dict(role=role, units=units)
    stage_self = sum(s["device_self_ms"] for s in rec["spans"] if s["name"] not in spans.TOP)
    outside = spans.outside_stages_ms(ctx, role)
    window_ms = 1e3 * line["device"]["window_s"] / units
    per_unit = {name: {k: v / units for k, v in a.items()} for name, a in summ["spans"].items()}
    busy = busy_ms(kept.get("events", []), rec["spans"])
    if busy:
        kids: dict = {}
        for sp in rec["spans"]:
            if sp["parent"] is not None:
                kids[sp["parent"]] = kids.get(sp["parent"], 0.0) + busy[sp["id"]]
        for sp in rec["spans"]:
            a = per_unit[sp["name"]]
            a["busy_ms"] = a.get("busy_ms", 0.0) + busy[sp["id"]] / units
            a["busy_self_ms"] = (a.get("busy_self_ms", 0.0)
                                 + (busy[sp["id"]] - kids.get(sp["id"], 0.0)) / units)
    out = dict(
        workload=args.workload, seed=args.seed, card=card_line(), units=units,
        metrics={k: v["value"] for k, v in line["metrics"].items()},
        correct=line["correct"], failed=line["failed"],
        busy_ms=1e3 * line["device"]["busy_s"] / units, window_ms=window_ms,
        spans=per_unit, counters=summ["counters"], dropped=summ["dropped"],
        sum_check=dict(stages_self_ms=stage_self / units, outside_ms=outside,
                       total_ms=stage_self / units + outside, window_ms=window_ms,
                       ratio=(stage_self / units + outside) / window_ms),
        gaps=gap_spans(kept.get("events", []), set(summ["spans"]), args.gaps),
    )
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
