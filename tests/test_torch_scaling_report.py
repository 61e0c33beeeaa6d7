"""The port's ``scripts.scaling_report`` with its bench-scale section (the
JAX script's ``--bench-scale``, scripts/scaling_report.py:230-258,
300-313), run as ``main([...], device="cpu")`` over 2 gloo ranks at a
reduced size set through the module's ``BENCH_*`` constants: capacity
4,096, a 64-pixel-wide tile-sharded view, 64 x 64 coarse views and 4,096
SDF samples (the JAX script's toy sizes; the constants hold its bench
sizes).

One run of ``main`` per module; the checks: the written table has its
heading and one row per step and rank count, each step's collectives
report nonzero bytes (and the ops it does not use none), and the totals
add up.
"""

import pytest
import torch

from sugar_tpu_torch.parallel import comm
from sugar_tpu_torch.scripts import scaling_report as sr

torch.set_num_threads(1)
SMALL = dict(BENCH_WORLDS=(2,), BENCH_CAPACITY=4096, BENCH_WIDTH=64, BENCH_RES=64, BENCH_SAMPLES=4096)
# The collectives each sharded step calls (parallel/render.py, train.py,
# coarse.py): the tile-sharded step routes rects (all_to_all), gathers the
# image bands and sums the overflow counters, and its backward
# reduce-scatters; the coarse step gathers the Gaussians and sums the
# gradients.
USES = {"tile-sharded": {"all_gather", "all_to_all", "reduce_scatter", "all_reduce"},
        "coarse-sdf": {"all_gather", "all_reduce"}}
_cache = {}


def report(tmp_path_factory):
    if "run" not in _cache:
        out = tmp_path_factory.mktemp("scaling") / "SCALING_torch.md"
        with pytest.MonkeyPatch.context() as mp:
            for name, value in SMALL.items():
                mp.setattr(sr, name, value)
            toy, bench = sr.main(["--out", str(out), "--worlds", "2", "--iters", "1"],
                                 device="cpu")
        _cache["run"] = (toy, bench, out.read_text())
    return _cache["run"]


def test_bench_sizes_are_the_jax_scripts():
    assert (sr.BENCH_WORLDS, sr.BENCH_CAPACITY, sr.BENCH_WIDTH, sr.BENCH_RES,
            sr.BENCH_SAMPLES) == ((2, 8), 2**20, 512, 512, 262_144)


def test_table_has_its_heading_and_a_row_per_step_and_rank_count(tmp_path_factory):
    _, bench, text = report(tmp_path_factory)
    assert "## BENCH SCALE (4,096-slot capacity" in text
    section = text.split("## BENCH SCALE")[1]
    rows = [ln for ln in section.splitlines()
            if ln.startswith("| tile-sharded |") or ln.startswith("| coarse-sdf |")]
    assert len(rows) == 2
    assert rows[0].startswith("| tile-sharded | 2 | 64x64 |")
    assert rows[1].startswith("| coarse-sdf | 2 | 1 x 64x64, 4,096 SDF samples, mesh 1x2 |")
    assert all(r.endswith("| 2 CPU processes, gloo |") for r in rows)
    assert [(r["step"], r["world"]) for r in bench] == [("tile-sharded", 2), ("coarse-sdf", 2)]


@pytest.mark.parametrize("step", sorted(USES))
def test_each_step_reports_bytes_for_the_ops_it_uses(tmp_path_factory, step):
    _, bench, _ = report(tmp_path_factory)
    (row,) = [r for r in bench if r["step"] == step]
    used = {op for op in comm.OPS if row["counts"][op] > 0}
    assert used == USES[step]
    assert row["total"] == sum(row["counts"][op] for op in comm.OPS)
    assert row["counts"]["host_staged"] == 0  # CPU tensors are not staged
    assert row["peak_gb"] is None and row["ms"] > 0.0
    assert row["launches"] == [(0,) * 6, (0,) * 6]  # the plain versions on the CPU


def test_the_toy_section_still_runs(tmp_path_factory):
    toy, _, text = report(tmp_path_factory)
    assert [r["world"] for r in toy] == [2]
    for name in ("tile", "coarse", "knn"):
        counts, times, _ = toy[0][name]
        assert sum(counts[op] for op in comm.OPS) > 0 and len(times) == 1
    assert "## Ring KNN" in text
