"""What a run loads: none of jax, jaxlib, flax or the JAX package
``sugar_tpu`` (top-level names compared whole: ``sugar_tpu_torch`` begins
with ``sugar_tpu``); the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import run

REF = os.path.join(run.ROOT, "benchmark", "reference")

DRIVE = r"""
import sys, time, json
import torch
torch.set_num_threads(2)
from benchmark import run
line = run.run_cell(run.load_spec(), "serve_refined_highpoly", 5, 0.2, True, "cpu",
                    time.perf_counter(), dict(rings=12, segments=24, height=32, width=48))
import benchmark.control, benchmark.readers
for m in run.load_spec()["per_layer"]:
    run.reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=run.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "sugar_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "sugar_tpu"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for m in [k for k in sys.modules if k.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "sugar_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sugar_tpu.raster", object())
    assert run.forbidden_modules() == ["sugar_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    for name in os.listdir(REF):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] in ("torch", "math", "dataclasses", "__future__"), (name, m)
    code = ("import sys, benchmark.reference.raster, benchmark.reference.losses, "
            "benchmark.reference.bound; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "sugar_tpu_torch" not in out.stdout and "'sugar_tpu'" not in out.stdout
