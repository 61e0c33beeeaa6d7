"""Traffic kind ``serve_orbit``: one client in a closed loop, a viewer
that waits for each frame. Request i renders view i mod ``views`` of a
circle of ``radius`` around the scene at ``elevation_deg`` and copies the
image as uint8 into the client's frame buffer of that view (pinned host
memory, allocated in set-up); its latency runs from the request to the
image in the buffer.

Set-up builds the served model, settles the raster caps by one forward
pass over the orbit's views and renders one frame to the host. After the
window the last answer of a sample of the views, drawn from the seed with
the view of the slowest request in it, is compared with the reference's
image.
"""

from __future__ import annotations

import gc
import math
import random
import time

import torch

from benchmark import checks, counts, scenes, trace
from benchmark.drivers import common

OVERFLOW = ("bin_overflow", "big_overflow", "cap_overflow", "tile_overflow")
SAMPLE = 6  # views compared after the window
PROFILED = 3  # of them rendered again under the profiler in a traced run


def _bad(out: dict) -> torch.Tensor:
    ovf = torch.stack([out[k].to(torch.int64) for k in OVERFLOW if k in out]).sum() > 0
    return ovf | ~torch.isfinite(out["image"]).all()


def run(model, cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool, dev,
        t_start: float) -> dict:
    marks = common.Marks(dev, t_start)
    inp = model.build(cfg, seed, dev, "serve")
    views = [v.to(dev) for v in scenes.orbit_views(cfg, traffic)]
    marks("inputs")
    server = model.Server(inp)
    common.offload(inp, model.HOST_KEYS)
    marks("program")
    server.settle_caps(views)
    marks("settle_caps")
    n = len(views)
    pin = torch.device(dev).type == "cuda"
    frames = [torch.empty((cfg["height"], cfg["width"], 3), dtype=torch.uint8, pin_memory=pin)
              for _ in range(n)]
    frames[0].copy_(server.render(views[0])[0])
    marks("warm_up")
    setup_s = marks.last

    lat, bad = [], []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        v = len(lat) % n
        img, out = server.render(views[v])
        frames[v].copy_(img)
        lat.append(time.perf_counter() - t)
        bad.append(_bad(out))
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(dev)
    window_s = time.perf_counter() - t0
    failed = int(torch.stack(bad).sum())
    peak = common.peak_bytes(dev)
    caps = str(server.caps)
    marks("window")

    # The sample of views: the slowest request's and others drawn from the
    # seed among the views served; each view's buffer holds its last answer.
    rng = random.Random(seed)
    slowest = max(range(len(lat)), key=lat.__getitem__) % n
    others = [v for v in range(min(n, len(lat))) if v != slowest]
    rng.shuffle(others)
    sample = [slowest] + others[:SAMPLE - 1]
    prof = {}
    if traced:
        with trace.profiled(True, dev) as prof:
            for v in sample[:PROFILED]:
                frames[v].copy_(server.render(views[v])[0])
    del server, bad
    gc.collect()
    common.release(dev)

    common.reference_precision()
    pairs, cnts = [], []
    for j, v in enumerate(sample):
        c = common.new_count(cfg) if traced and j < PROFILED else None
        ref = model.reference_image(inp, views[v], dev, count=c)
        pairs.append((frames[v], ref.cpu()))
        if c is not None:
            cnts.append(c)
        del ref
    numbers = checks.serve_numbers(pairs)
    marks("reference")
    srt = sorted(lat)
    p95 = srt[max(0, math.ceil(0.95 * len(srt)) - 1)]
    out = dict(
        attempted=len(lat), failed=failed, numbers=numbers, peak_bytes=peak,
        e2e=dict(views_per_s=len(lat) / window_s, view_ms_p95=p95 * 1e3, peak_gb=peak / 1e9,
                 setup_s=setup_s),
        details=dict(window_s=window_s, view_ms_median=srt[len(srt) // 2] * 1e3,
                     sample=sample, marks=marks.done, caps=caps),
    )
    if traced:
        ch = 3
        per_view = {}
        for i, l in enumerate(lat):
            per_view.setdefault(i % n, []).append(l)
        unit_s = sum(sorted(per_view[v])[len(per_view[v]) // 2]
                     for v in sample[:PROFILED]) / len(cnts)
        ops = [counts.k1_ops(c, ch) + model.serve_extra_ops(inp, c) for c in cnts]
        out["details"].update(counts.frame_use(cnts))
        out["layer_ctx"] = dict(role="serve", units=len(cnts), prof=prof, counts=cnts, ch=ch,
                                unit_s=unit_s, ops=ops)
    return out
