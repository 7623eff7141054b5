"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file (``configs/``), its traffic mix (``traffic/<mix>.json``,
whose ``kind`` names the window loop in ``drivers/<kind>.py``), its
correctness limits (``limits/<cell>.json``) and, with ``--trace 1``, a
reader for each per-layer metric (``metrics/<metric>.py``).  The run
measures ``repro_torch`` on the card; it refuses to run without one.
Standard output ends with one JSON line; standard error ends with each
number compared beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# Python's bytecode of torch and the port, compiled once a checkout: the
# card's Python writes none beside its sources, and compiling the torch
# modules a first training step imports took 7 s of every run's set-up.
sys.pycache_prefix = str(ROOT / ".perfbench-cache" / "pyc")
sys.dont_write_bytecode = False

#: modules whose presence after the window means the run measured JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """What a driver runs: one workload of ``BENCHMARK.json``."""

    name: str
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    fault: str | None = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench: dict, name: str, seed: int, seconds: float,
              trace: bool, device) -> Cell:
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name, load_json(ROOT / conf["file"]),
                load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"),
                seed, seconds, trace, device)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    """``read(window, cell)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def jax_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip()


def is_correct(checks) -> bool:
    """Every compared number within its limit (a NaN is not)."""
    return all(v <= lim for _, v, lim in checks)


def result_line(bench: dict, cell: Cell, out: dict, chips: int) -> dict:
    import torch

    from perfbench import trace as trace_lib

    values = dict(out["e2e"], setup_s=out["window_start"] - T_START)
    metrics = {}
    w = out["window"]
    if cell.trace:
        for m in bench["per_layer"]:
            if applies(m, cell.name):
                v = reader(m["name"])(w, cell)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, cell.name):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(cell.device),
              "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": is_correct(out["checks"]),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if cell.trace:
        device.update(busy_s=w.busy_s(), window_s=w.seconds)
        line["breakdown"] = {"device_ops": trace_lib.top_ops(w),
                             "idle_gaps": trace_lib.idle_gaps(w)}
    line["checks"] = {name: {"value": v if math.isfinite(v) else None,
                             "limit": lim}
                      for name, v, lim in out["checks"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload, 1)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell = load_cell(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0))
    driver = importlib.import_module(f"perfbench.drivers.{cell.mix['kind']}")
    ready = time.perf_counter()
    out = driver.run(cell)
    out["setup_parts"]["imports_s"] = ready - T_START
    found = jax_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    line = result_line(bench, cell, out, chips)
    parts = {k: round(v, 3) for k, v in out["setup_parts"].items()}
    print(f"perfbench: {cell.name} seed {cell.seed} setup {parts} "
          f"card {power_limit()}", file=sys.stderr)
    for name, v, lim in out["checks"]:
        ok = "ok" if v <= lim else "FAIL"
        print(f"check {name}: {v!r} limit {lim!r} {ok}", file=sys.stderr)
    print(json.dumps(line, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
