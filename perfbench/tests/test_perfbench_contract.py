"""``BENCHMARK.json`` and the files it names: the contract's shapes, the
lookup by name, and what the harness may import."""

import ast
import importlib.util
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _run_module(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name, root / "perfbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs_resolve():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf["published"]
            assert not key.endswith(("_dim", "_rank"))


def test_cells_resolve():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        mix = json.loads(
            (ROOT / "perfbench/traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench/drivers" / f"{mix['kind']}.py").exists()
        limits = json.loads(
            (ROOT / "perfbench/limits" / f"{w['name']}.json").read_text())
        assert limits and all(v > 0 for v in limits.values())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_enough(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, cell) for m in BENCH["per_layer"])


def test_metric_shapes():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert (ROOT / "perfbench/metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    cells = metric.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        assert cell in {w["name"] for w in BENCH["workloads"]}
        assert _reports(moves, cell)


def test_new_files_alone_are_picked_up(tmp_path):
    """A configuration, a mix, a cell's limits and a per-layer metric
    added as files of their own, with entries in BENCHMARK.json, are
    found without editing any file the benchmark has."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    bench = json.loads(json.dumps(BENCH))
    conf = dict(bench["configs"][0], name="tiny",
                file="perfbench/configs/tiny.json")
    cfile = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    cfile["sizes"]["n_layers"] = 1
    (tmp_path / conf["file"]).write_text(json.dumps(cfile))
    mix = json.loads((ROOT / "perfbench/traffic/train-moment.json")
                     .read_text())
    mix["seq"] = 64
    (tmp_path / "perfbench/traffic/train-short.json").write_text(
        json.dumps(mix))
    (tmp_path / "perfbench/limits/train-short.tiny.json").write_text(
        json.dumps({"loss": 1.0, "grad": 1.0, "change": 1.0}))
    (tmp_path / "perfbench/metrics/steps_seen.train.py").write_text(
        "def read(window, cell):\n    return window.info['steps']\n")
    bench["configs"].append(conf)
    bench["workloads"].append({"name": "train-short.tiny", "config": "tiny",
                               "traffic": "train-short", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    prefix = sys.pycache_prefix
    run = _run_module(tmp_path, "perfbench_run_copy")
    try:
        cell = run.load_cell(bench, "train-short.tiny", 7, 1.0, False, "cpu")
        assert cell.config["sizes"]["n_layers"] == 1
        assert cell.mix["seq"] == 64
        info = type("W", (), {"info": {"steps": 3}})()
        assert run.reader("steps_seen.train")(info, cell) == 3
    finally:
        sys.path[:] = [p for p in sys.path if str(tmp_path) not in p]
        sys.pycache_prefix = prefix


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize(
    "path", sorted((ROOT / "perfbench").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_a_plain_reference(path):
    names = _imports(path)
    assert not names & FORBIDDEN
    if "ref" in path.relative_to(ROOT / "perfbench").parts:
        assert "repro_torch" not in names


def test_jax_guard_compares_whole_names(monkeypatch):
    run = _run_module(ROOT, "perfbench_run_guard")
    before = {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "repro_torch.probe", object())
    found = run.jax_modules()
    assert ("repro" in found) == ("repro" in before)
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.jax_modules()


def test_refuses_without_a_card(monkeypatch, capsys):
    import torch

    run = _run_module(ROOT, "perfbench_run_nocard")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                   "3000000000", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err
