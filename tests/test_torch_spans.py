"""The port's spans and counters (``sugar_tpu_torch.utils.profiling``): the
span tree of a vanilla step, a refine step and a served view while a
profiler collects, as operators of the trace and not user annotations (to
which the profiler adds a device-side event that the benchmark would count
as a kernel); nothing recorded, no record function entered and bitwise the
same outputs without one; binning's slot counters against the
render and a count by hand; the benchmark's readers of them
(``benchmark/spans.py``) on hand-built records; and one traced benchmark
cell on the CPU.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from test_torch_refine import grid_mesh
from test_torch_render import CAM, model_arrays
from benchmark import run
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.interop import params_from_numpy
from sugar_tpu_torch.models import densifier as dens
from sugar_tpu_torch.models.gaussians import GaussianModel
from sugar_tpu_torch.models.render import render_model
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.refine import bound as B
from sugar_tpu_torch.refine import trainer
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.trainers import vanilla
from sugar_tpu_torch.utils import profiling

torch.set_num_threads(1)

CAPS = adaptive.RasterCaps(tile_cap=16, dup_capacity=8192, k_max=512, cap_a=4, big_cap=64)
RASTER = ("raster.preprocess", "raster.binning", "raster.gather", "raster.k1")
BACKWARD = {"raster.k2": "train.backward", "raster.gather_bwd": "train.backward",
            "raster.k3": "raster.gather_bwd"}


def vanilla_case():
    d, alive = model_arrays()
    n = alive.shape[0]
    gt = torch.as_tensor(np.random.default_rng(8).uniform(0, 1, (CAM["height"], CAM["width"], 3)),
                         dtype=torch.float32)
    cfg = vanilla.TrainConfig(sh_degree=3, capacity=n)
    step = vanilla.make_train_step(cfg, opt.group_lrs(cfg.optim, 2.0), 3, CAPS)
    p = params_from_numpy(d, device="cpu")
    args = (p, torch.tensor(alive), opt.init_adam(p), dens.DensifyStats.zeros(n, "cpu"),
            make_camera(**CAM, device="cpu"), gt, 5)
    return step, args


def refine_case():
    verts, faces = grid_mesh(n=6, bumpy=True)
    colors = np.random.default_rng(3).uniform(0.2, 0.8, verts.shape).astype(np.float32)
    params, bm = B.init_bound_params(verts, faces, colors, n_gaussians_per_triangle=1,
                                     extent=2.0, sh_degree=1, device="cpu")
    pairs = torch.as_tensor(B.normal_consistency_pairs(faces).astype(np.int64))
    cfg = trainer.RefineConfig(sh_degree=1)
    caps = adaptive.RasterCaps(tile_cap=16, dup_capacity=8 * faces.shape[0], k_max=512)
    step = trainer.make_refine_step(cfg, bm, pairs, trainer.bound_lrs(cfg, 0.5), 1, caps)
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.2, height=40, width=40,
                      device="cpu")
    gt = torch.full((40, 40, 3), 0.5)
    return step, (params, trainer.init_bound_adam(params), cam, gt, 5)


def serve_case():
    d, alive = model_arrays()
    model = GaussianModel(params=params_from_numpy(d, device="cpu"), sh_degree=3,
                          alive=torch.tensor(alive))
    cam = make_camera(**CAM, device="cpu")
    return lambda: render_model(model, cam, **dataclasses.asdict(CAPS))


def traced(fn):
    profiling.reset()
    with torch.profiler.profile() as prof:
        out = fn()
    return out, profiling.recorded(), prof


def tree(rec) -> dict:
    """{span name: its parent's name} (one entry per name)."""
    by_id = {s["id"]: s for s in rec["spans"]}
    return {s["name"]: by_id[s["parent"]]["name"] if s["parent"] is not None else None
            for s in rec["spans"]}


def expected(top: str, *extra: str) -> dict:
    want = {top: None, "render.setup": top, "loss": top, "train.backward": top,
            "optimizer": top, **{r: top for r in RASTER}, **BACKWARD}
    want.update({e: top for e in extra})
    return want


def test_vanilla_step_records_its_span_tree():
    step, args = vanilla_case()
    _, rec, prof = traced(lambda: step(*args))
    assert tree(rec) == expected("train.step", "densify.stats")
    top = rec["spans"][-1]
    assert top["name"] == "train.step" and all(s["top"] == top["id"] for s in rec["spans"])
    assert all(s["device_ms"] is None for s in rec["spans"])  # no CUDA device here
    assert rec["dropped"] == 0


def test_refine_step_records_its_span_tree():
    step, args = refine_case()
    _, rec, _ = traced(lambda: step(*args))
    want = expected("refine.step", "bound.gaussians")
    want["loss.normal"] = "loss"
    assert tree(rec) == want


def test_served_view_records_its_span_tree_and_nests_in_a_step():
    render = serve_case()
    _, rec, _ = traced(render)
    assert tree(rec) == {"render.model": None, "render.setup": "render.model",
                         **{r: "render.model" for r in RASTER}}
    profiling.reset()
    with torch.profiler.profile():
        with profiling.span("train.step"):
            render()
    names = [s["name"] for s in profiling.recorded()["spans"]]
    assert "render.model" not in names and names[-1] == "train.step"


@pytest.mark.parametrize("case", ["vanilla", "refine", "serve"])
def test_spans_lie_in_the_profiler_trace_around_their_ops(case):
    if case == "serve":
        fn = serve_case()
    else:
        step, args = vanilla_case() if case == "vanilla" else refine_case()
        fn = lambda: step(*args)  # noqa: E731
    _, rec, prof = traced(fn)
    events = prof.events()
    recorded = {}
    for s in rec["spans"]:
        recorded[s["name"]] = recorded.get(s["name"], 0) + 1
    for name, n in recorded.items():
        spans = [e for e in events if e.name == name]
        assert len(spans) == n, name
        assert not any(getattr(e, "is_user_annotation", False) for e in spans), name
        inside = [c for e in spans for c in e.cpu_children]
        assert inside, name
        for e in spans:
            for c in e.cpu_children:
                assert e.time_range.start <= c.time_range.start <= c.time_range.end \
                    <= e.time_range.end, (name, c.name)

    def below(e):
        for c in e.cpu_children:
            yield c.name
            yield from below(c)

    ops = {name: {o for e in events if e.name == name for o in below(e)} for name in recorded}
    assert "aten::sort" in ops["raster.binning"]
    assert "aten::index_select" in ops["raster.gather"]
    if case != "serve":
        assert "aten::sort" in ops["raster.gather_bwd"]


def tensors(x):
    """Every tensor of a step's outputs (tuples, dicts, dataclasses)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from tensors(v)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from tensors(getattr(x, f.name))


def test_nothing_recorded_without_a_profiler(monkeypatch):
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    step, args = vanilla_case()
    profiling.reset()
    off = step(*args)
    assert profiling.recorded() == dict(spans=[], counters=[], dropped=0)
    assert entered == []
    on, rec, _ = traced(lambda: step(*args))
    assert len(entered) == len(rec["spans"]) > 0
    a, b = list(tensors(off)), list(tensors(on))
    assert len(a) == len(b) > 20
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_binning_counts_its_slots():
    render = serve_case()
    out, rec, _ = traced(render)
    counters = {c["name"]: c for c in rec["counters"]}
    binning = next(s for s in rec["spans"] if s["name"] == "raster.binning")
    assert counters["raster.slots_kept"]["value"] == int(out["num_rendered"]) > 0
    n = model_arrays()[1].shape[0]
    # The full capped rect of every row (16 slots), then bucket B's 64 rows
    # past cap_a (12 slots each).
    assert counters["raster.slots_tested"]["value"] == 16 * n + 12 * 64
    assert counters["raster.slots_kept"]["span"] == binning["id"]
    assert counters["raster.slots_kept"]["top"] == binning["top"]


# --- the benchmark's readers ------------------------------------------------

NEW = ("preprocess_ms.train", "preprocess_ms.serve", "binning_ms.train", "binning_ms.serve",
       "gather_ms.train", "gather_ms.serve", "loss_ms.train", "backward_ops_ms.train",
       "optimizer_ms.train", "bound_ms.train", "host_wait_ms.train", "outside_stages_ms.train",
       "outside_stages_ms.serve", "bin_yield.train", "bin_yield.serve")
HOST_READ = ("host_wait_ms.train", "bin_yield.train", "bin_yield.serve")


def hand_record(device: bool = True) -> dict:
    """Two refine steps of hand-set intervals (ms on both clocks), one
    overflow read between them, and their binning counters."""
    spans = []

    def add(name, parent, top, t0, t1):
        i = len(spans)
        d0, d1 = (t0 * 1e6, t1 * 1e6) if device else (None, None)
        spans.append(dict(name=name, id=i, parent=parent, top=top, host_start_ns=t0 * 1e6,
                          host_end_ns=t1 * 1e6, host_ms=t1 - t0, device_start_ns=d0,
                          device_end_ns=d1, device_ms=t1 - t0 if device else None,
                          device_self_ms=None))
        return i

    for k, base in enumerate((0.0, 100.0)):
        top = add("refine.step", None, None, base, base + 90)
        spans[top]["top"] = top
        for name, a, b in (("bound.gaussians", 1, 3), ("render.setup", 3, 4),
                           ("raster.preprocess", 4, 10), ("raster.binning", 10, 30),
                           ("raster.gather", 30, 33), ("raster.k1", 33, 40),
                           ("loss", 40, 45), ("train.backward", 45, 80),
                           ("optimizer", 81, 88)):
            i = add(name, top, top, base + a, base + b)
            if name == "loss":
                add("loss.normal", i, top, base + 43, base + 45)
            if name == "train.backward":
                add("raster.k2", i, top, base + 50, base + 55)
                g = add("raster.gather_bwd", i, top, base + 60, base + 70)
                add("raster.k3", g, top, base + 66, base + 68)
    add("caps.read", None, None, 92, 96)
    kids = {}
    for s in spans:
        if s["parent"] is not None:
            kids[s["parent"]] = kids.get(s["parent"], 0.0) + s["host_ms"]
    for s in spans:
        if device:
            s["device_self_ms"] = s["device_ms"] - kids.get(s["id"], 0.0)
    counters = [dict(name="raster.slots_kept", span=None, top=None, value=v) for v in (30, 50)]
    counters += [dict(name="raster.slots_tested", span=None, top=None, value=400)] * 2
    return dict(spans=spans, counters=counters, dropped=0)


WANT = {  # per step of hand_record
    "preprocess_ms.train": 7.0, "binning_ms.train": 20.0, "gather_ms.train": 3.0 + 8.0,
    "loss_ms.train": 5.0, "backward_ops_ms.train": 35.0 - 5.0 - 10.0,
    "optimizer_ms.train": 7.0, "bound_ms.train": 2.0, "host_wait_ms.train": 2.0,
    # 0-1, 80-81, 88-92, 96-101, 180-181, 188-190 of 190 ms lie in no stage.
    "outside_stages_ms.train": (1 + 1 + 4 + 5 + 1 + 2) / 2, "bin_yield.train": 10.0,
    # The readers of serving read the same record (they do not look at the
    # top spans' names); serving's gather has no backward.
    "preprocess_ms.serve": 7.0, "binning_ms.serve": 20.0, "gather_ms.serve": 3.0,
    "outside_stages_ms.serve": 7.0, "bin_yield.serve": 10.0,
}


@pytest.mark.parametrize("metric", NEW)
def test_span_readers(metric, monkeypatch):
    read = run.reader(metric)
    role = metric.rsplit(".", 1)[1]
    other = "serve" if role == "train" else "train"
    monkeypatch.setattr(profiling, "recorded", lambda: hand_record())
    assert read(dict(role=other, units=2)) is None
    assert read(dict(role=role, units=2)) == pytest.approx(WANT[metric])
    monkeypatch.setattr(profiling, "recorded", lambda: dict(spans=[], counters=[], dropped=0))
    assert read(dict(role=role, units=2)) is None
    monkeypatch.setattr(profiling, "recorded", lambda: hand_record(device=False))
    value = read(dict(role=role, units=2))
    if metric in HOST_READ:
        assert value == pytest.approx(WANT[metric])
    else:
        assert value is None
    monkeypatch.delattr(profiling, "recorded")  # a program without the recorder
    assert read(dict(role=role, units=2)) is None


def test_a_traced_serving_cell_on_the_cpu_reads_bin_yield():
    profiling.reset()
    line = run.run_cell(run.load_spec(), "serve_refined_highpoly", 5, 0.2, True, "cpu",
                        time.perf_counter(), dict(rings=12, segments=24, height=32, width=48))
    metrics = line["metrics"]
    assert 0 < metrics["bin_yield.serve"]["value"] <= 100
    device_metrics = {"preprocess_ms.serve", "binning_ms.serve", "gather_ms.serve",
                      "outside_stages_ms.serve"}
    assert not device_metrics & set(metrics)
    profiling.reset()
