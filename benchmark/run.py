"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything is found by name from
``BENCHMARK.json``: the cell's configuration ``benchmark/configs/
<config>.json`` (its ``model`` names ``benchmark/models/<model>.py``), its
traffic ``benchmark/traffic/<traffic>.json`` (its ``kind`` names
``benchmark/drivers/<kind>.py``), the limits of its comparison
``benchmark/limits/<cell>.json``, and each per-layer metric's reader
``benchmark/metrics/<metric>.py``.

The run refuses without a CUDA card (or with fewer cards than the cell
asks for), and when, after the window, a module of JAX or of the JAX
package is loaded in this process. The last lines of standard error give
each compared number beside its limit; the last line of standard output
is the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "sugar_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell_parts(spec: dict, name: str, root: str = ROOT) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration, traffic, limits) of workload ``name``, from the
    files under ``root``."""
    here = os.path.join(root, "benchmark")
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(here, "traffic", f"{cell['traffic']}.json"))
    limits = _json(os.path.join(here, "limits", f"{name}.json"))
    return cell, cfg, traffic, limits


def reader(metric: str, root: str = ROOT):
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def run_cell(spec: dict, name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, cfg_override: dict | None = None) -> dict:
    """Run workload ``name`` on ``device`` and return (result line,
    compared numbers with their limits). ``cfg_override`` changes keys of
    the configuration (the CPU tests' small sizes)."""
    cell, cfg, traffic, limits = cell_parts(spec, name)
    cfg = dict(cfg, **(cfg_override or {}))
    from benchmark import checks

    model = importlib.import_module(f"benchmark.models.{cfg['model']}")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    out = driver.run(model, cfg, traffic, seed, seconds, traced, device, t_start)
    correct, compared = checks.judge(out["numbers"], limits)
    if traced:
        ctx = out.get("layer_ctx", {})
        metrics = {}
        for m in spec["per_layer"]:
            if _applies(m, name):
                v = reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        metrics = {m["name"]: dict(value=out["e2e"][m["name"]], unit=m["unit"])
                   for m in spec["end_to_end"] if _applies(m, name)}
    dev = dict(platform="gpu", kind=None, count=cell["chips"], memory_peak_bytes=out["peak_bytes"])
    line = dict(correct=correct, attempted=out["attempted"], failed=out["failed"],
                metrics=metrics, device=dev)
    if traced:
        prof = out.get("layer_ctx", {}).get("prof") or {}
        dev.update(busy_s=prof.get("busy_s"), window_s=prof.get("window_s"))
        if prof:
            line["breakdown"] = prof["breakdown"]
    line["checks"] = compared
    line["_details"] = out.get("details", {})
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_spec()
    cell = cell_parts(spec, args.workload)[0]

    import torch

    from benchmark.frozen import card_line, require_cuda

    try:
        require_cuda("benchmark.run")
    except RuntimeError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA cards; "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    line = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                    T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package is loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    line["device"]["kind"] = torch.cuda.get_device_name(0)
    details = line.pop("_details")
    checks = line.pop("checks")
    line["checks"] = checks
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"details: {json.dumps(details)}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
