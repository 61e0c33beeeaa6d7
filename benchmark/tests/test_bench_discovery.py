"""Configurations, cells, traffic, limits and per-layer readers are found
by name from files; BENCHMARK.json keeps to the contract's shape."""

import json
import os
import re
import shutil

from benchmark import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_an_added_config_and_cell_are_found_from_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    metric as new files and entries only."""
    root = tmp_path
    shutil.copytree(os.path.join(run.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = run.load_spec()
    with open(os.path.join(run.ROOT, "benchmark", "configs", "vanilla_7k.json")) as f:
        cfg = json.load(f)
    cfg.update(name="vanilla_sfm", alive=200000, capacity=262144)
    (root / "benchmark" / "configs" / "vanilla_sfm.json").write_text(json.dumps(cfg))
    (root / "benchmark" / "traffic" / "train_from_0.json").write_text(json.dumps(
        {"kind": "train", "start_iteration": 0, "tile_cap": 16}))
    (root / "benchmark" / "limits" / "train_vanilla_sfm.json").write_text(
        json.dumps({"loss_gap": 1.0}))
    (root / "benchmark" / "metrics" / "new_metric.train.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    spec["configs"].append({"name": "vanilla_sfm", "source": "x",
                            "file": "benchmark/configs/vanilla_sfm.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "train_vanilla_sfm", "config": "vanilla_sfm",
                              "traffic": "train_from_0", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    spec2 = run.load_spec(str(root))
    cell, cfg2, traffic, limits = run.cell_parts(spec2, "train_vanilla_sfm", str(root))
    assert cfg2["alive"] == 200000 and cfg2["model"] == "free_gaussians"
    assert traffic["kind"] == "train" and traffic["start_iteration"] == 0
    assert limits == {"loss_gap": 1.0}
    assert run.reader("new_metric.train", str(root))({}) == 42.0


def test_benchmark_json_keeps_the_contract_shape():
    spec = run.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))
        names.add(c["name"])
    used = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        used.add(w["config"])
        run.cell_parts(spec, w["name"])  # its traffic and limits exist
    assert used == names
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(run.ROOT, "benchmark", "metrics", m["name"] + ".py"))
        moved = next(x for x in spec["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    cells = {w["name"] for w in spec["workloads"]}
    for w in cells:
        # Every cell reports setup_s, another end-to-end metric and a
        # per-layer metric.
        got = [m for m in spec["end_to_end"] if w in m.get("workloads", [w])]
        assert len(got) >= 2
        assert any(w in m["workloads"] for m in spec["per_layer"])


def test_without_a_card_the_run_prints_no_result(capsys):
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "train_vanilla_7k", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
