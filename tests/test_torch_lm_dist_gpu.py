"""The sharded LM path's collectives on CUDA tensors, on the card.

    python -m pytest -m gpu tests/test_torch_lm_dist_gpu.py

* Two gloo ranks sharing the card and one NCCL rank run every collective
  the sharded step makes (``MeshComm``'s psum, all_gather along a dim,
  reduce_scatter, all_to_all; ``ShardCtx``'s gather, copy_to,
  reduce_from and pmean with their backward passes) on CUDA tensors,
  against the same arithmetic done on one tensor: exact, since the
  operands are small integers in f32. No operand leaves the card in the
  port's code (gloo stages CUDA tensors through the host itself).
* The sharded step of reduced mixtral (tp with fsdp; the expert-parallel
  MoE) on the two gloo ranks, held against the single-device step on
  the card: loss and grad norm within rtol 1e-5.

Every test needs a CUDA card and skips without one (the ``cuda``
fixture decides). The file imports nothing of JAX.
"""
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


@pytest.mark.parametrize("backend,ranks", [("gloo", 2), ("nccl", 1)])
def test_collectives_on_cuda_tensors(cuda, tmp_path, backend, ranks):
    from repro_torch.launch import spawn_ranks
    out = spawn_ranks(R.collectives_on_card, ranks, backend=backend,
                      timeout_s=120, dir=str(tmp_path))
    for r in out:
        assert r["device"] == "cuda"
        assert r["failed"] == [], r["failed"]


def test_sharded_step_on_the_card_matches_one_device(cuda, tmp_path):
    from repro_torch.launch import spawn_ranks
    case = dict(key="mixtral", arch="mixtral-8x22b",
                mesh=[(1, 2), ("data", "model")], layout="tp", fsdp=True,
                steps=1, batch=2, seq=16,
                step_kw=dict(peak_lr=1e-3, warmup_steps=2, total_steps=10))
    got = spawn_ranks(R.lm_dist_steps, 2, backend="gloo",
                      args=(dict(device="cuda", seed=0, cases=[case]),),
                      timeout_s=240, dir=str(tmp_path))
    want, _ = R.lm_oracle(case, "cuda", 0)
    for r in got:
        m = r["mixtral"]["metrics"][0]
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert m[k] == pytest.approx(want[0][k], rel=1e-5), k
