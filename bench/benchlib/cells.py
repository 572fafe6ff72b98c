"""Finding the pieces of a cell by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic mix; everything else is found from those names:

* a configuration: the ``file`` its entry in ``configs`` gives;
* a traffic mix: ``bench/traffic/<traffic>.json``, whose ``loop`` names
  its driver, ``bench/drivers/<loop>.py``;
* a metric, end-to-end or per-layer: ``bench/metrics/<name>.py``, a
  reader with ``read(ctx) -> float | None``.

A new cell with an existing driver is new data files and readers, and an
entry in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    mod_name = f"bench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: with ``traced`` the
    per-layer ones, else the end-to-end ones; each where its
    ``workloads`` list names the cell, or has no such list."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
