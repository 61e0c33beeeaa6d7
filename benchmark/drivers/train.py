"""Traffic kind ``train``: the trainer loop of a configuration from a
start iteration, one image a step, the targets on the device.

Set-up builds the model's training object once, settles the raster caps
by one forward pass over the distinct views, warms the step up with one
call whose outputs are dropped, and drives the same object through its
first three steps, which the reference follows after the window. The
window then runs the loop's own iterations for the run's seconds.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import checks, counts, trace
from benchmark.drivers import common

FIRST = 3  # steps the reference follows
OVERFLOW = ("bin_overflow", "big_overflow", "cap_overflow", "tile_overflow")
# What the trainer loops fix (trainers/vanilla.py, refine/trainer.py): the
# camera schedule's seed, and the lagged overflow check every step for
# HOT_STEPS iterations after the start or a cap change, then every
# CHECK_EVERY-th.
SCHEDULE_SEED = 0
HOT_STEPS = 50
CHECK_EVERY = 10


def _host(d: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in d.items()}


def lagged_check(prog, it: int, aux: dict) -> None:
    """The loops' lagged overflow check of ``prog`` (a model's ``Program``)
    on the previous step's counters; a growth drops the cached steps."""
    if prog.prev_aux is not None and (it < prog.hot_until or it % CHECK_EVERY == 0):
        if prog.cap_state.observe(prog.prev_aux):
            prog.step_cache.clear()
            prog.hot_until = it + HOT_STEPS
    prog.prev_aux = aux


def reference_steps(model, inp: dict, it0: int, views: list, dev, cnts: list | None = None,
                    **variant) -> dict:
    """Losses, first gradient and the change over the steps of the
    reference (``variant``: the control's or a fault's keywords) on
    ``views``, from iteration ``it0``; ``cnts`` gathers each step's
    least-work count."""
    ref = model.Reference(inp, dev, **variant)
    p0 = _host(ref.params)
    losses = []
    for k, vi in enumerate(views):
        loss, grads = ref.step(it0 + k, vi, None if cnts is None else cnts[k])
        losses.append(loss)
        if k == 0:
            g1 = _host(grads)
        del grads
    return dict(losses=losses, g1=g1, change={k: v.cpu() - p0[k] for k, v in ref.params.items()})


def run(model, cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool, dev,
        t_start: float) -> dict:
    marks = common.Marks(dev, t_start)
    inp = model.build(cfg, seed, dev, "train")
    marks("inputs")
    prog = model.Program(inp, traffic)
    common.offload(inp, model.HOST_KEYS)
    marks("program")
    prog.settle_caps()
    marks("settle_caps")
    it0 = traffic["start_iteration"]
    prog.warm_up(it0)
    marks("warm_up")
    p0 = _host(prog.leaves())
    losses, views = [], []
    with trace.profiled(traced, dev) as prof:
        t0 = time.perf_counter()
        for k in range(FIRST):
            ci, aux = prog.iterate(it0 + k)
            views.append(ci)
            losses.append(aux["loss"])
            if k == 0:
                # The traced run keeps the state's tensors and copies them
                # after the profile, so that the copy is not profiled.
                g1 = prog.first_grad() if traced else _host(prog.first_grad())
        common.sync(dev)
        first_s = time.perf_counter() - t0
    g1 = _host(g1)
    change = {k: v.cpu() - p0[k] for k, v in prog.leaves().items()}
    del p0
    losses = [float(x) for x in losses]
    marks("first_steps")
    setup_s = marks.last

    auxes = []
    it = it0 + FIRST
    t0 = time.perf_counter()
    while True:
        _, aux = prog.iterate(it)
        auxes.append({k: aux[k] for k in OVERFLOW + ("loss",) if k in aux})
        it += 1
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(dev)
    window_s = time.perf_counter() - t0

    steps = len(auxes)
    bad = torch.stack([
        torch.stack([a[k].to(torch.int64) for k in OVERFLOW if k in a]).sum() > 0
        for a in auxes]) | ~torch.isfinite(torch.stack([a["loss"] for a in auxes]))
    failed = int(bad.sum())
    peak = common.peak_bytes(dev)
    caps = str(prog.cap_state.caps)
    marks("window")
    del prog, auxes, aux
    gc.collect()
    common.release(dev)

    common.reference_precision()
    cnts = [common.new_count(cfg) for _ in views] if traced else None
    ref = reference_steps(model, inp, it0, views, dev, cnts)
    marks("reference")
    numbers = checks.train_numbers(dict(losses=losses, g1=g1, change=change), ref)
    step_ms = window_s / steps * 1e3
    out = dict(
        attempted=steps, failed=failed, numbers=numbers, peak_bytes=peak,
        e2e=dict(step_ms=step_ms, peak_gb=peak / 1e9, setup_s=setup_s),
        details=dict(first_steps_s=first_s, window_s=window_s, views=views, losses=losses,
                     ref_losses=ref["losses"], marks=marks.done, caps=caps),
    )
    if traced:
        ch = 3
        ops = [counts.k1_ops(c, ch) + counts.k2_ops(c, ch) + counts.loss_ops(c["pixels"], ch)
               + model.extra_ops(inp, c) for c in cnts]
        out["details"].update(counts.frame_use(cnts))
        out["layer_ctx"] = dict(role="train", units=FIRST, prof=prof, counts=cnts, ch=ch,
                                unit_s=step_ms / 1e3, ops=ops)
    return out
