"""The port's serving CLI (``repro_torch.launch.serve_slab``) held against
the JAX package's ``repro.launch.serve_slab``, on the CPU
(``--device cpu``).

* The reference's quota regression (tests/test_async_serving.py), through
  the port: the CLI sheds load instead of crashing.
* The JSON stats have the reference CLI's schema at the same flags
  (single-model and ``--models``); bucket keys stand for any bucket,
  since which buckets a deadline-driven window fills depends on the
  clock.
* ``--driver`` admits and serves every request, and its inside-slab count
  equals scoring the same requests in process with ``repro_torch.serve``.
* ``--shm-attach`` of a model published here scores the stream bitwise
  like the publisher's own service.
* ``--sharded-devices 2`` runs the stream over two gloo rank processes:
  rank 0 alone prints and writes the JSON, with the single-process run's
  counts.
"""
import argparse
import json
import re

import numpy as np
import pytest

from repro.launch import serve_slab as jcli
import repro_torch
from repro_torch.core import SlabSpec, rbf
from repro_torch.data import make_toy
from repro_torch.launch import serve_slab
from repro_torch.serve import ScoringService, publish, run_request_stream

SMALL = ["--m", "48", "--requests", "6", "--min-batch", "8",
         "--max-batch", "64", "--tol", "1e-2"]
# No quota: which requests a quota sheds depends on when windows flush.
FLEET = ["--models", "a=rbf:0.5", "--models", "b=linear",
         "--deadline-ms", "20"]


def _schema(obj):
    """Keys and value types, every all-digit key (a bucket) as one."""
    if isinstance(obj, dict):
        return {("<bucket>" if str(k).isdigit() else k): _schema(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_schema(x) for x in obj]
    return type(obj).__name__


def _run(main, argv, path):
    main(argv + ["--json", str(path)])
    with open(path) as f:
        return json.load(f)


def _inside(out: str) -> tuple:
    (got,) = re.findall(r"^decisions: (\d+)/(\d+) inside the slab$", out,
                        re.M)
    return int(got[0]), int(got[1])


@pytest.fixture(scope="module")
def reference_stats(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    return {"single": _run(jcli.main, SMALL, d / "single.json"),
            "multi": _run(jcli.main, SMALL + FLEET, d / "multi.json")}


def test_cli_quota_shed_does_not_crash(tmp_path):
    stats = _run(serve_slab.main, [
        "--m", "48", "--requests", "8", "--min-batch", "8", "--max-batch",
        "64", "--models", "a=rbf:0.5", "--quota", "6", "--tol", "1e-2",
        "--device", "cpu"], tmp_path / "stats.json")
    assert stats["rejected"] >= 1           # quota actually bound
    assert stats["admitted"] + stats["rejected"] == 8


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_json_schema_matches_reference(reference_stats, tmp_path, mode):
    argv = SMALL + (FLEET if mode == "multi" else []) + ["--device", "cpu"]
    stats = _run(serve_slab.main, argv, tmp_path / "stats.json")
    ref = reference_stats[mode]
    assert _schema(stats) == _schema(ref)
    for key in ("m", "requests", "queries", "precision"):
        assert stats[key] == ref[key]
    if mode == "multi":
        assert stats["models"] == ref["models"] == ["a", "b"]
        assert (stats["quota"], stats["deadline_ms"]) == (None, 20.0)
        assert stats["admitted"] == ref["admitted"] == 6


def test_driver_serves_every_request_like_in_process_serve(tmp_path, capfd):
    flags = ["--m", "64", "--requests", "8", "--min-batch", "8",
             "--max-batch", "128", "--tol", "1e-2", "--seed", "3"]
    stats = _run(serve_slab.main, flags + [
        "--models", "a=rbf:0.5", "--models", "b=linear", "--deadline-ms",
        "20", "--driver", "--device", "cpu"], tmp_path / "stats.json")
    inside, total = _inside(capfd.readouterr().out)
    assert stats["admitted"] == 8 and stats["rejected"] == 0
    X = make_toy(3, 64)[0]
    defaults = argparse.Namespace(gamma=0.5, nu1=0.5, nu2=0.05, eps=0.5)
    models = {}
    for flag in ("a=rbf:0.5", "b=linear"):
        name, spec = serve_slab._parse_model_flag(flag, defaults)
        models[name] = repro_torch.serve(X, spec, tol=1e-2, P=16,
                                         precision="f32", device="cpu")
    rng = np.random.default_rng(3)
    sizes = rng.integers(8, 129, size=8)
    want = 0
    for i, n in enumerate(sizes):
        q = make_toy(1000 + i, int(n))[0]
        want += int((models["ab"[i % 2]].score(q) >= 0).sum())
    assert total == stats["queries"] == int(sizes.sum())
    assert inside == want


def test_shm_attach_scores_bitwise_like_the_publisher(tmp_path,
                                                      monkeypatch):
    X = make_toy(0, 48)[0]
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=rbf(0.5))
    sm = repro_torch.serve(X, spec, tol=1e-2, P=16, device="cpu")
    streams = []

    def spy(svc, requests, coalesce=None):
        out = run_request_stream(svc, requests, coalesce=coalesce)
        streams.append((requests, out))
        return out
    monkeypatch.setattr(serve_slab, "run_request_stream", spy)
    key = f"{tmp_path}/k"
    with publish(sm, key):
        stats = _run(serve_slab.main, SMALL + [
            "--shm-attach", key, "--device", "cpu"], tmp_path / "s.json")
    (requests, got), = streams
    want = run_request_stream(ScoringService(sm.scorer()), requests,
                              coalesce=8)
    assert stats["n_sv"] == sm.n_sv
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]


def test_sharded_devices_over_gloo_ranks(tmp_path, capfd):
    single = _run(serve_slab.main, SMALL + ["--device", "cpu"],
                  tmp_path / "single.json")
    one = _inside(capfd.readouterr().out)
    sharded = _run(serve_slab.main, SMALL + [
        "--device", "cpu", "--sharded-devices", "2"],
        tmp_path / "sharded.json")
    out = capfd.readouterr().out
    assert out.count("sharded scoring over 2 devices (axis 'data')") == 1
    assert out.count("decisions: ") == 1
    assert _inside(out) == one
    assert _schema(sharded) == _schema(single)
    for key in ("m", "n_sv", "precision", "requests", "queries"):
        assert sharded[key] == single[key]
    # per rank, each request's rows split in two: smaller buckets
    assert max(map(int, sharded["buckets"])) <= max(map(int,
                                                        single["buckets"]))
