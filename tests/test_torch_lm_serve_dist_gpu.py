"""Sharded LM serving on the card.

    python -m pytest -m gpu tests/test_torch_lm_serve_dist_gpu.py

Two gloo ranks sharing the card on a (1, 2) ("data", "model") mesh, the
"tp" layout with fsdp: reduced llama (head-parallel attention, its
positions over "model") and reduced jamba (its Mamba states gathered at
use, the expert-parallel MoE) prefill 2 x 16 tokens and decode 4 steps
greedily, held against the single-device run on the card: the logits
within rtol 1e-5 and atol 1e-5 x the largest |logit|, the tokens equal.

Every test needs a CUDA card and skips without one (the ``cuda`` fixture
decides). The file imports nothing of JAX.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch.api import resolve_device

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")   # and TF32 off


@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-1.5-large-398b"])
def test_sharded_serving_on_the_card_matches_one_device(cuda, tmp_path,
                                                        arch):
    from repro_torch.launch import spawn_ranks
    case = dict(key=arch, arch=arch, mesh=[(1, 2), ("data", "model")],
                fsdp=True, batch=2, prompt=16, steps=4, cache_len=24)
    got = spawn_ranks(R.lm_serve_steps, 2, backend="gloo",
                      args=(dict(device="cuda", seed=0, cases=[case]),),
                      timeout_s=240, dir=str(tmp_path))
    want = R.lm_serve_oracle(case, "cuda", 0)
    for r in got:
        res = r[arch]
        for g, w in zip(res["logits"], want["logits"]):
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))
        np.testing.assert_array_equal(res["tokens"], want["tokens"])
        assert r["launches"] == {"fupdate": 0, "decision": 0, "gram": 0}
