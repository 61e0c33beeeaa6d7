"""Profiling: the program's spans and counters, the Chrome-trace exporter
and the helpers of the measurement entry points.

Port of ``sugar_tpu/utils/profiling.py``, which replaces the reference's
CUDA-event timing + tensorboard iter_time (gaussian_splatting/train.py:
44-67, 160).

- ``span(name)`` marks a stage of the hot path (``layer.stage``: the
  train step's render, loss, backward and optimizer, the served view's
  render, the raster stages inside them) and ``count(name, value)`` a
  number a stage produces. Both record only while a ``torch.profiler``
  collects on the process (``trace`` below, or a caller's own profiler);
  otherwise each costs one flag check. A recorded span opens a
  function-scope record function of its name, so it lies in the
  profiler's trace on the kernels' clock as an operator does (a
  ``torch.profiler.record_function`` is a user annotation, to which the
  profiler adds a device-side event per span: a reader of the trace would
  count it as a kernel and as busy time), and keeps its host interval
  and, on a CUDA device, a pair of CUDA events on the current stream. Nothing is read from the
  device until ``recorded()`` collects: it synchronises once, anchors the
  events to the host clock by one more event, and gives every span its
  device interval and its self device time (the interval less its
  children's). Counters hold device tensors unread until then.
- ``trace(log_dir)``: the block under ``torch.profiler``, written as
  ``trace.json`` (chrome://tracing, Perfetto) and the block's spans and
  counters summed by name as ``spans.json``.
- the helpers of the measurement entry points (``scripts/bench.py``,
  ``profile_*``, ``microbench_*``): the card's name and power limit, a
  refusal to measure without a card, and a kernel time from CUDA events.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import subprocess
import threading
import time

import torch

# Spans and counters kept until ``reset()``; those beyond are dropped (and
# counted in ``recorded()["dropped"]``).
MAX_RECORDS = 1 << 17

_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class _Record:
    __slots__ = ("name", "id", "parent", "top", "t0", "t1", "ev0", "ev1", "dev")

    def __init__(self, name, parent):
        self.name = name
        self.id = next(_REC.ids)
        self.parent = None if parent is None else parent.id
        self.top = self.id if parent is None else parent.top
        self.ev0 = self.ev1 = self.dev = None


class _Recorder:
    """The process's spans and counters: the open spans of each thread, the
    finished ones not yet collected, and the collected ones."""

    def __init__(self):
        self.ids = itertools.count()
        self.local = threading.local()
        self.open = []  # open spans of every thread, in the order opened
        self.pool = {}  # CUDA events by device, recorded again after collection
        self.reset()

    def reset(self):
        self.done, self.counts = [], []
        self.spans, self.counters = [], []
        self.child_dev = {}
        self.dropped = 0

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def event(self, dev: int):
        free = self.pool.get(dev)
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def keep(self, box: list, item) -> None:
        held = len(self.done) + len(self.counts) + len(self.spans) + len(self.counters)
        if held < MAX_RECORDS:
            box.append(item)
        else:
            self.dropped += 1

    def collect(self) -> None:
        """Give every finished span its intervals and read the counters.

        Per device: one synchronise, then an anchor event recorded at a
        known host time places the earliest span's start event on the host
        clock; every other event is timed from that start event, so the
        intervals keep the events' resolution however long ago they ran."""
        done, counts = self.done, self.counts
        self.done, self.counts = [], []
        bases = {}
        for dev in sorted({r.dev for r in done if r.dev is not None}):
            first = min((r for r in done if r.dev == dev), key=lambda r: r.t0).ev0
            with torch.cuda.device(dev):
                torch.cuda.synchronize()
                anchor = torch.cuda.Event(enable_timing=True)
                anchor.record()
                t = time.perf_counter_ns()
                anchor.synchronize()
            bases[dev] = (first, t - first.elapsed_time(anchor) * 1e6)
        for r in done:  # children finish, and are collected, before parents
            host_ms = (r.t1 - r.t0) / 1e6
            span = dict(name=r.name, id=r.id, parent=r.parent, top=r.top, host_start_ns=r.t0,
                        host_end_ns=r.t1, host_ms=host_ms, device_start_ns=None,
                        device_end_ns=None, device_ms=None, device_self_ms=None)
            if r.dev is not None:
                first, t = bases[r.dev]
                d0 = t + first.elapsed_time(r.ev0) * 1e6
                d1 = t + first.elapsed_time(r.ev1) * 1e6
                dev_ms = (d1 - d0) / 1e6
                span.update(device_start_ns=d0, device_end_ns=d1, device_ms=dev_ms,
                            device_self_ms=dev_ms - self.child_dev.pop(r.id, 0.0))
                if r.parent is not None:
                    self.child_dev[r.parent] = self.child_dev.get(r.parent, 0.0) + dev_ms
            self.spans.append(span)
        for r in done:
            if r.dev is not None:
                self.pool.setdefault(r.dev, []).extend((r.ev0, r.ev1))
        for name, span_id, top, value in counts:
            v = int(value.item()) if isinstance(value, torch.Tensor) else int(value)
            self.counters.append(dict(name=name, span=span_id, top=top, value=v))


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _REC.stack()
        # A span opened on another thread (the autograd engine's) while
        # this thread has none open is a child of the innermost open span.
        parent = st[-1] if st else (_REC.open[-1] if _REC.open else None)
        r = self.rec = _Record(self.name, parent)
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            r.dev = torch.cuda.current_device()
            r.ev0 = _REC.event(r.dev)
            r.ev0.record()
        r.t0 = time.perf_counter_ns()
        st.append(r)
        _REC.open.append(r)
        return r

    def __exit__(self, *exc):
        r = self.rec
        r.t1 = time.perf_counter_ns()
        if r.dev is not None:
            r.ev1 = _REC.event(r.dev)
            r.ev1.record()
        _REC.stack().pop()
        _REC.open.remove(r)
        self.rf.__exit__(*exc)
        _REC.keep(_REC.done, r)
        return False


def span(name: str, outermost: bool = False):
    """Context manager marking the stage ``name`` while a profiler collects;
    with ``outermost``, only when no span is open on this thread (an entry
    point that is also called from inside a step)."""
    if not _profiling() or (outermost and _REC.stack()):
        return _NULL
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function is a ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def collecting() -> bool:
    """Whether a profiler collects: spans and counters record only then."""
    return _profiling()


def count(name: str, value) -> None:
    """Record ``value`` (a host int or a device scalar, held unread until
    ``recorded()``) under ``name`` while a profiler collects."""
    if not _profiling():
        return
    st = _REC.stack()
    inner = st[-1] if st else None
    _REC.keep(_REC.counts, (name, inner and inner.id, inner and inner.top, value))


def recorded() -> dict:
    """The spans and counters recorded since the last ``reset()``:
    dict(spans=[...], counters=[...], dropped=n). A span holds its name,
    id, parent and top-level span ids, host start and end
    (``time.perf_counter_ns``), host ms, and device start and end on the
    same clock, device ms and self device ms (None without a CUDA device).
    A counter holds its name, its innermost span's and top span's ids and
    its value."""
    _REC.collect()
    return dict(spans=list(_REC.spans), counters=list(_REC.counters), dropped=_REC.dropped)


def reset() -> None:
    """Forget every recorded span and counter (open spans still close)."""
    _REC.reset()


def summary(rec: dict | None = None) -> dict:
    """``recorded()`` (or ``rec``) summed by name: spans[name] = count,
    host ms, device ms and self device ms (None without a device);
    counters[name] = count, total."""
    rec = recorded() if rec is None else rec
    spans: dict = {}
    for s in rec["spans"]:
        a = spans.setdefault(s["name"], dict(count=0, host_ms=0.0, device_ms=None,
                                             device_self_ms=None))
        a["count"] += 1
        a["host_ms"] += s["host_ms"]
        if s["device_ms"] is not None:
            a["device_ms"] = (a["device_ms"] or 0.0) + s["device_ms"]
            a["device_self_ms"] = (a["device_self_ms"] or 0.0) + s["device_self_ms"]
    counters: dict = {}
    for c in rec["counters"]:
        a = counters.setdefault(c["name"], dict(count=0, total=0))
        a["count"] += 1
        a["total"] += c["value"]
    return dict(spans=spans, counters=counters, dropped=rec["dropped"])


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block (the CPU, and the card when there
    is one), written to ``<log_dir>/trace.json`` (chrome://tracing,
    Perfetto) with the program's spans in it, and the block's spans and
    counters summed by name (``summary``) to ``<log_dir>/spans.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(summary(), f, indent=2)


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
