"""On a card: one short run of each cell through ``bench/run.py``'s path,
correct, with its metrics. Skips without a card."""
import pytest
import torch

from benchlib import cells, harness


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  cells.load_benchmark()["workloads"]])
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch.api as api
    dev = api.resolve_device("cuda")
    r = harness.run(cell, 7, 1.0, False, dev)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu"
    assert "setup_s" in r["metrics"]
