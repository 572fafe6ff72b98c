"""The LM serving path on the card held against the same parameters on
the CPU (reduced archs, f32 with TF32 off: within atol 5e-4 / rtol 1e-3,
``tests/test_arch_smoke.py``'s tolerance), and greedy decoding on the
card against the CPU's tokens.

    python -m pytest -m gpu tests/test_torch_lm_gpu.py

Every test needs a CUDA card and skips without one (the ``cuda`` fixture
decides). The file imports nothing of JAX.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.api import resolve_device
from repro_torch.configs import ARCHS
from repro_torch.models.transformer import forward, init_cache, init_params
from repro_torch.train.serve_step import greedy_generate

pytestmark = pytest.mark.gpu
ATOL, RTOL = 5e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")   # and TF32 off


def _pair(arch, dev):
    cfg = ARCHS[arch].reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, cpu, copy.deepcopy(cpu).to(dev)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_forward_and_decode_on_the_card_match_the_cpu(cuda, arch):
    cfg, cpu, card = _pair(arch, cuda)
    rng = np.random.default_rng(1)
    kw = {}
    if cfg.frontend == "audio":
        kw["embeds"] = rng.standard_normal((2, 12, cfg.d_model)) \
            .astype(np.float32)
        key = "embeds"
    else:
        kw["tokens"] = rng.integers(0, cfg.vocab_size, (
            2, 12 - cfg.n_frontend_tokens)).astype(np.int32)
        key = "tokens"
        if cfg.n_frontend_tokens:
            kw["vision_embeds"] = rng.standard_normal(
                (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        t = {k: torch.as_tensor(v, device=dev) for k, v in kw.items()}
        logits, _, aux = forward(params, cfg, **t)
        cache = init_cache(cfg, 2, 12, dtype=torch.float32, device=dev)
        head = dict(t, **{key: t[key][:, :-1]})
        _, cache, _ = forward(params, cfg, cache=cache, **head)
        last, _, _ = forward(params, cfg, cache=cache,
                             **{key: t[key][:, -1:]})
        if dev == "cpu":
            want = (logits, aux, last)
    for got, ref in zip((logits, aux, last), want):
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-1.5-large-398b"])
def test_greedy_generate_on_the_card_matches_the_cpu(cuda, arch):
    cfg, cpu, card = _pair(arch, cuda)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32))
    want = greedy_generate(cfg, cpu, prompt, n_new=6)
    got = greedy_generate(cfg, card, prompt.to(cuda), n_new=6)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
