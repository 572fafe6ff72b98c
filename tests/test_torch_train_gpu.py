"""The training step on the card held against the same step on the CPU:
every arch at its ``reduced()`` size, f32 with TF32 off, one
``make_train_step`` step from the same parameters and batch.

    python -m pytest -m gpu tests/test_torch_train_gpu.py

Loss, ce and aux within atol 1e-5 / rtol 1e-4, the grad norm within rtol
1e-4, the lr equal (0 at step 0, so the parameters stay bitwise what
they were); the optimizer state (AdamW's m and v, Adafactor's vr and vc:
functions of the gradients alone at step 1) within rtol 1e-3 and an atol
of 1e-5 of the leaf's largest value (the summation order of the
backward differs). Every test needs a CUDA card and skips without one
(the ``cuda`` fixture decides). The file imports nothing of JAX.
"""
import pytest
import torch

from repro_torch.api import resolve_device
from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import SyntheticPipeline
from repro_torch.models.transformer import init_params
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.utils.tree import leaves, map_tree

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")   # and TF32 off


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_train_step_on_the_card_matches_the_cpu(cuda, arch):
    cfg = ARCHS[arch].reduced()
    cpu = init_train_state(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    card = map_tree(lambda t: t.to(cuda, copy=True), cpu)
    batch = SyntheticPipeline(cfg, batch=2, seq_len=16, device="cpu") \
        .next_batch()
    step = make_train_step(cfg, peak_lr=1e-3, warmup_steps=2,
                           total_steps=10)
    before = [t.clone() for t in leaves(cpu.params)]
    cpu, m_cpu = step(cpu, batch)
    card, m_card = step(card, {k: v.to(cuda) for k, v in batch.items()})
    for k in ("loss", "ce", "aux"):
        torch.testing.assert_close(m_card[k].cpu(), m_cpu[k], atol=1e-5,
                                   rtol=1e-4)
    torch.testing.assert_close(m_card["grad_norm"].cpu(),
                               m_cpu["grad_norm"], atol=0, rtol=1e-4)
    assert float(m_card["lr"]) == float(m_cpu["lr"]) == 0.0
    for a, b, c in zip(leaves(card.params), leaves(cpu.params), before):
        assert a.is_cuda and torch.equal(a.cpu(), b) and torch.equal(b, c)
    for a, b in zip(leaves(card.opt_state), leaves(cpu.opt_state)):
        b = b.float()
        torch.testing.assert_close(a.cpu().float(), b, rtol=1e-3,
                                   atol=1e-5 * float(b.abs().max()))
