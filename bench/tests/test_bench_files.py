"""BENCHMARK.json against the benchmark's contract, every piece found by
name, and the imports that the benchmark must not make."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchlib import cells

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_units_and_lines(bench):
    assert set(bench) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert bench["paths"] == ["bench"]
    assert all(_line(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert bench[group]
        for e in bench[group]:
            extra = {"workloads"} if group in ("end_to_end",
                                               "per_layer") else set()
            assert KEYS[group] <= set(e) <= KEYS[group] | extra, e
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and group in ("configs", "workloads",
                                        "per_layer"):
                    assert _line(e[k]), (e["name"], k)
    assert len(names) == len(set(names))


def test_configs_and_cells(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert c["file"].startswith("bench/configs/")
        cfg = cells.config(bench, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["kernel"]["gamma"] == 1.0 / cfg["d"]
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] == 1 for w in bench["workloads"])
    n = len(bench["workloads"])
    assert 1 <= n <= 24
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells_ = [w["name"] for w in bench["workloads"]]
    for cell in cells_:
        reported = [m["name"] for m in cells.metrics_of(bench, cell, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert cells.metrics_of(bench, cell, True)
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in cells_
            assert cell in e2e[m["moves"]].get("workloads", cells_)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "whole step" in layers


def test_every_piece_is_found_by_name(bench):
    for w in bench["workloads"]:
        trf = cells.traffic(w["traffic"])
        assert hasattr(cells.module("drivers", trf["loop"]), "window")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.module("metrics", m["name"]).read)
    for c in bench["configs"]:
        cells.config(bench, c["name"])
    with pytest.raises(FileNotFoundError):
        cells.module("metrics", "no_such_metric")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    seen = set()
    for p in sorted(BENCH_DIR.rglob("*.py")):
        tops = set(_imports(p))
        seen |= tops
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)
    assert "repro_torch" in seen      # whole names: not taken for repro


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "typing", "math", "numpy", "torch",
               "reference"}
    for p in sorted((BENCH_DIR / "reference").rglob("*.py")):
        assert set(_imports(p)) <= allowed, p


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(BENCH_DIR / 'tests')!r}, "
        f"{str(BENCH_DIR)!r}, {str(ROOT / 'src')!r}]\n"
        "import torch, conftest, run\n"
        "from benchlib import harness\n"
        "r = harness.run('sift128.online', 5, 0.2, True, "
        "torch.device('cpu'), config=conftest.small_config("
        "'slab-sift128-f32'), traffic=conftest.small_traffic('online'))\n"
        "print(json.dumps([r['correct'], run.loaded_forbidden()]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "sift128.bulk", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"
                              ":/bin:/usr/local/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
