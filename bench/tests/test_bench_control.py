"""The check refuses the control and every planted fault, and passes the
program: whole runs of each cell on the CPU at a small size (the card's
look skipped), the program's kernels in their plain versions."""
import pytest
import torch
from conftest import small_config, small_traffic

from benchlib import cells, faults, harness, model

CPU = torch.device("cpu")
SEED = 2 ** 31 + 29


def _cells():
    bench = cells.load_benchmark()
    return [(w["name"], w["config"], w["traffic"])
            for w in bench["workloads"]]


def _run(cell, cfg, trf, seed=SEED):
    return harness.run(cell, seed, 0.3, False, CPU, config=cfg, traffic=trf)


@pytest.mark.parametrize("cell,config,traffic", _cells())
def test_the_program_is_correct(cell, config, traffic):
    r = _run(cell, small_config(config), small_traffic(traffic))
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("cell,config,traffic", _cells())
def test_the_control_is_not_correct(cell, config, traffic):
    cfg, trf = small_config(config), small_traffic(traffic)
    slab, _ = model.draw(SEED, cfg, trf, CPU)
    with faults.control(slab, cfg["check"]["control"]):
        r = _run(cell, cfg, trf)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("kind", faults.FAULTS)
@pytest.mark.parametrize("cell,config,traffic", _cells())
def test_a_planted_fault_is_not_correct(cell, config, traffic, kind):
    with faults.fault(kind):
        r = _run(cell, small_config(config), small_traffic(traffic))
    assert not r["correct"], (kind, r["check"])


def test_an_answer_that_never_comes_is_not_correct():
    from repro_torch.serve.scorer import BatchScorer
    cfg = small_config("slab-sift128-f32")
    orig = BatchScorer._score_once
    BatchScorer._score_once = lambda self, q: orig(self, q)[:-1]
    try:
        for cell, trf in (("sift128.bulk", "bulk"),
                          ("sift128.online", "online")):
            r = _run(cell, cfg, small_traffic(trf))
            assert not r["correct"] and r["check"]["missing"]["value"] > 0
    finally:
        BatchScorer._score_once = orig
