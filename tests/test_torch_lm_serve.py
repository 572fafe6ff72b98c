"""The port's LM serving path held against the JAX package's: greedy
generation (``repro_torch.train.serve_step``), the synthetic data
pipeline (``repro_torch.data.synthetic``), the ``launch.serve`` CLI, and
the paper's slab head on backbone features (``tests/test_system.py``'s
protocol through both packages).

Weights cross as numpy (``convert.lm_params_from_numpy``). Logits and
features agree within atol 5e-4 / rtol 1e-3; greedy tokens and data
batches are equal. The slab heads are fitted by each package on its own
features and held as ``tests/test_torch_head.py`` holds fits: the port's
scores within the f32 ``truth_tolerance`` of the JAX head's (atol scaled
by the largest score) and both AUCs above 0.8.
"""
import re

import jax
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.configs import ARCHS as JARCHS
from repro.data.synthetic import SyntheticPipeline as JPipeline
from repro.kernels.precision import truth_tolerance
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import init_params as jinit
from repro.train.serve_step import greedy_generate as jgreedy
from repro.train.serve_step import make_prefill as jprefill
import repro_torch.core as tc
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import IGNORE_LABEL, SyntheticPipeline
from repro_torch.launch import serve as serve_cli
from repro_torch.models.transformer import forward, init_cache
from repro_torch.train.serve_step import (greedy_generate, make_decode,
                                          make_prefill)

ATOL, RTOL = 5e-4, 1e-3


def _pair(arch, seed=0):
    jcfg, cfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    p = jinit(jcfg, jax.random.PRNGKey(seed))
    return jcfg, p, cfg, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, p), cfg, device="cpu")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "musicgen-large"])
def test_greedy_generate_tokens_equal(arch):
    jcfg, p, cfg, params = _pair(arch)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    out = greedy_generate(cfg, params, torch.from_numpy(prompt), n_new=6)
    ref = jgreedy(jcfg, p, prompt, n_new=6)
    assert out.shape == (2, 6) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(out.max()) < cfg.padded_vocab


def test_prefill_returns_the_last_logits_and_decode_steps():
    jcfg, p, cfg, params = _pair("llama3.2-3b")
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    cache = init_cache(cfg, 2, 12, device="cpu")
    logits, cache = make_prefill(cfg)(params, cache,
                                      {"tokens": torch.from_numpy(prompt)})
    jl, jcache = jprefill(jcfg)(p, jinit_cache(jcfg, 2, 12), {
        "tokens": prompt})
    assert logits.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    logits, cache = make_decode(cfg)(params, cache, tok)
    assert cache["pos"] == 10 and logits.shape == (2, 1, cfg.padded_vocab)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "musicgen-large",
                                  "internvl2-26b"])
def test_synthetic_batches_bitwise_and_resume(arch):
    cfg, jcfg = ARCHS[arch].reduced(), JARCHS[arch].reduced()
    pipe = SyntheticPipeline(cfg, 3, 16, seed=5, device="cpu")
    ref = JPipeline(jcfg, 3, 16, seed=5)
    batches = []
    for _ in range(3):
        b, rb = pipe.next_batch(), ref.next_batch()
        assert sorted(b) == sorted(rb)
        for k in b:
            assert b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(rb[k]))
        batches.append(b)
    assert pipe.state_dict() == ref.state_dict() == {"seed": 5, "step": 3}
    # resume from step 1: the same stream
    again = SyntheticPipeline(cfg, 3, 16, seed=0, device="cpu")
    again.load_state_dict({"seed": 5, "step": 1})
    for want in batches[1:]:
        got = again.next_batch()
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert IGNORE_LABEL == -1


def test_cli_reduced_on_the_cpu(capsys):
    serve_cli.main(["--arch", "musicgen-large", "--reduced", "--batch", "2",
                    "--prompt-len", "16", "--new-tokens", "8",
                    "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert re.fullmatch(r"generated \(2, 8\) in \d+ ms \([\d.]+ ms/token\)",
                        lines[0]), lines[0]
    toks = re.fullmatch(r"first sequence: \[([\d, ]+)\]", lines[1])
    assert toks and len(toks.group(1).split(",")) == 8
    # the same run again: the same tokens (seeded generators)
    serve_cli.main(["--arch", "musicgen-large", "--reduced", "--batch", "2",
                    "--prompt-len", "16", "--new-tokens", "8",
                    "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[1] == lines[1]


def test_slab_head_on_backbone_features():
    """``tests/test_system.py::test_ocssvm_head_on_backbone_features``
    through both packages: mean-pooled first 64 logits of in-distribution
    token ids (< 40) fit the slab head; held-out in-distribution text
    scores above OOD text (the top 40 ids)."""
    jcfg, p, cfg, params = _pair("llama3.2-3b")
    rng = np.random.default_rng(0)
    toks_in = rng.integers(0, 40, (96, 16)).astype(np.int32)
    toks_in2 = rng.integers(0, 40, (48, 16)).astype(np.int32)
    toks_out = rng.integers(cfg.vocab_size - 40, cfg.vocab_size,
                            (48, 16)).astype(np.int32)

    def jfeat(toks):
        logits, _, _ = jforward(p, jcfg, tokens=toks)
        return jc.pool_features(logits[..., :64], "mean")

    def tfeat(toks):
        logits, _, _ = forward(params, cfg, tokens=torch.from_numpy(toks))
        return tc.pool_features(logits[..., :64], "mean")

    for toks in (toks_in, toks_in2, toks_out):
        np.testing.assert_allclose(tfeat(toks).numpy(),
                                   np.asarray(jfeat(toks)), atol=ATOL,
                                   rtol=RTOL)
    jhead = jc.fit_head(jfeat(toks_in), jc.SlabSpec(
        nu1=0.2, nu2=0.1, eps=0.3, kernel=jc.rbf(gamma=0.05)),
        solver="blocked", tol=1e-3)
    head = tc.fit_head(tfeat(toks_in), tc.SlabSpec(
        nu1=0.2, nu2=0.1, eps=0.3, kernel=tc.rbf(gamma=0.05)),
        solver="blocked", tol=1e-3, device="cpu")
    for toks in (toks_in2, toks_out):
        ref = np.asarray(jhead.score(jfeat(toks)))
        tol = truth_tolerance("f32", ref)
        np.testing.assert_allclose(head.score(tfeat(toks)).numpy(), ref,
                                   rtol=tol["rtol"], atol=tol["atol"])
    for h, feat in ((head, tfeat), (jhead, jfeat)):
        s_in = np.asarray(h.score(feat(toks_in2)))
        s_out = np.asarray(h.score(feat(toks_out)))
        auc = float(np.mean(s_in[:, None] > s_out[None, :]))
        assert auc > 0.8, f"AUC={auc}"
