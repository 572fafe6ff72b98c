"""The port's decoder stack (``repro_torch.models.transformer``) and LM
configs held against the JAX package's, for all ten architectures at
their ``reduced()`` sizes.

The JAX package's ``init_params`` tree crosses as numpy through
``convert.lm_params_from_numpy``; inputs are made from a numpy seed.
Logits, hidden states, aux losses, prefill caches and decode logits agree
within atol 5e-4 / rtol 1e-3 (``tests/test_arch_smoke.py``'s decode
tolerance; f32 on both sides, summation order only). Where the JAX
package is wrong (ROADMAP C.12, C.13) the port is held against its own
full forward instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import ARCHS, LayerSpec, get_arch
from repro_torch.configs import base as tbase
from repro_torch.models import transformer as ttr

ATOL, RTOL = 5e-4, 1e-3
ARCH_IDS = sorted(JARCHS)


def _close(port, ref, **kw):
    np.testing.assert_allclose(
        port.detach().numpy() if isinstance(port, torch.Tensor) else port,
        np.asarray(ref), atol=ATOL, rtol=RTOL, **kw)


def _pair(arch, seed=0, **kw):
    """(JAX cfg, JAX params, port cfg, port params) with the same
    weights."""
    jcfg = dataclasses.replace(JARCHS[arch].reduced(), **kw)
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **kw)
    p = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, p, cfg, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, p), cfg, device="cpu")


def _inputs(cfg, seed, B, S):
    """The same inputs as numpy (for JAX) and as tensors (for the port)."""
    rng = np.random.default_rng(seed)
    kw = {}
    if cfg.frontend == "audio":
        kw["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        nv = cfg.n_frontend_tokens
        kw["tokens"] = rng.integers(0, cfg.vocab_size,
                                    (B, S - nv)).astype(np.int32)
        if nv:
            kw["vision_embeds"] = rng.standard_normal(
                (B, nv, cfg.d_model)).astype(np.float32)
    return kw, {k: torch.from_numpy(v) for k, v in kw.items()}


def _last(kw, n):
    """The inputs with only their last n text positions (no vision)."""
    key = "embeds" if "embeds" in kw else "tokens"
    return {key: kw[key][:, -n:]}


def _head(kw, n):
    """The inputs without their last n text positions."""
    out = dict(kw)
    key = "embeds" if "embeds" in kw else "tokens"
    out[key] = kw[key][:, :-n]
    return out


# -- configs ---------------------------------------------------------------

def test_registry_has_the_ten_archs():
    assert sorted(ARCHS) == ARCH_IDS
    with pytest.raises(KeyError):
        get_arch("gpt-5")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_fields_and_counts_match(arch):
    for reduce in (False, True):
        j = JARCHS[arch].reduced() if reduce else JARCHS[arch]
        t = ARCHS[arch].reduced() if reduce else ARCHS[arch]
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert td == jd
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert t.padded_vocab == j.padded_vocab
        assert tbase.is_subquadratic(t) == jbase.is_subquadratic(j)
        assert tbase.long_context_capable(t) == \
            jbase.long_context_capable(j)
        assert t.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[t.param_dtype]
    assert tbase.SHAPES == jbase.SHAPES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_has_the_jax_tree_shapes(arch):
    cfg = ARCHS[arch].reduced()
    gen = torch.Generator().manual_seed(3)
    params = ttr.init_params(cfg, gen, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    mine = convert.lm_params_to_numpy(params, cfg)
    ref = jtr.init_params(JARCHS[arch].reduced(), jax.random.PRNGKey(0))
    assert jax.tree.structure(mine) == jax.tree.structure(
        jax.tree.map(np.asarray, ref))
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == np.dtype(b.dtype)
    # the same generator seed draws the same parameters
    again = ttr.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(params.parameters(), again.parameters()))


def test_params_round_trip_through_numpy():
    jcfg, p, cfg, params = _pair("jamba-1.5-large-398b")
    back = convert.lm_params_to_numpy(params, cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # layer j of the stack is period position j % period of period
    # j // period (reduced gemma: 6 layers a period, 8 layers: 2 of tail)
    jcfg, p, cfg, params = _pair("gemma3-27b", n_layers=8)
    assert (cfg.n_repeats, cfg.n_tail) == (1, 2)
    np.testing.assert_array_equal(
        params.layers[4]["attn"]["wq"].numpy(),
        np.asarray(p["segments"]["l4"]["attn"]["wq"][0]))
    np.testing.assert_array_equal(params.layers[7]["mlp"]["w2"].numpy(),
                                  np.asarray(p["tail"][1]["mlp"]["w2"]))


# -- forward ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches(arch):
    jcfg, p, cfg, params = _pair(arch)
    kw, tkw = _inputs(cfg, 1, 2, 16)
    logits, cache, aux = ttr.forward(params, cfg, **tkw)
    ref, _, raux = jtr.forward(p, jcfg, **kw)
    assert cache is None and logits.shape == (2, 16, cfg.padded_vocab)
    _close(logits, ref)
    _close(aux, raux)
    # the module runs the same function
    assert torch.equal(params(**tkw)[0], logits)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-26b"])
def test_forward_hidden_matches(arch):
    jcfg, p, cfg, params = _pair(arch)
    kw, tkw = _inputs(cfg, 2, 2, 12)
    hidden, _, _ = ttr.forward(params, cfg, return_hidden=True, **tkw)
    ref, _, _ = jtr.forward(p, jcfg, return_hidden=True, **kw)
    assert hidden.shape == (2, 12, cfg.d_model)
    _close(hidden, ref)


def test_padded_vocab_columns_never_win():
    jcfg, p, cfg, params = _pair("llama3.2-3b", vocab_size=500)
    assert cfg.padded_vocab == 512
    _, tkw = _inputs(cfg, 3, 1, 8)
    logits, _, _ = ttr.forward(params, cfg, **tkw)
    assert torch.all(logits[..., 500:] == -1e30)
    assert int(logits.argmax(-1).max()) < 500


def test_q_chunk_does_not_change_the_forward():
    _, _, cfg, params = _pair("gemma3-27b")
    _, tkw = _inputs(cfg, 4, 2, 20)
    a, _, _ = ttr.forward(params, cfg, **tkw)
    b, _, _ = ttr.forward(params, cfg, q_chunk=6, **tkw)
    _close(b, a.numpy())


# -- prefill, decode -------------------------------------------------------

def _layers_close(port_layers, jax_cache, cfg):
    ref_layers = convert.layers_of(jax.tree.map(np.asarray, jax_cache), cfg)
    assert len(port_layers) == len(ref_layers) == cfg.n_layers
    for mine, ref in zip(port_layers, ref_layers):
        assert mine._fields == ref._fields
        for name in mine._fields:
            _close(getattr(mine, name), getattr(ref, name), err_msg=name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode_matches(arch):
    """Prefill S - 1 positions, then decode the last one: the prefill
    logits, every layer's cache buffers and the decode logits agree."""
    jcfg, p, cfg, params = _pair(arch, seed=42)
    B, S = 2, 20
    kw, tkw = _inputs(cfg, 5, B, S)
    jc = jtr.init_cache(jcfg, B, S, dtype=jnp.float32)
    tc = ttr.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    out, tc, _ = ttr.forward(params, cfg, cache=tc, **_head(tkw, 1))
    ref, jc, _ = jtr.forward(p, jcfg, cache=jc, **_head(kw, 1))
    _close(out, ref)
    assert tc["pos"] == int(jc["pos"]) == S - 1
    _layers_close(tc["layers"], jc, cfg)
    out, tc, _ = ttr.forward(params, cfg, cache=tc, **_last(tkw, 1))
    ref, jc, _ = jtr.forward(p, jcfg, cache=jc, **_last(kw, 1))
    _close(out, ref)
    _layers_close(tc["layers"], jc, cfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_full_forward(arch):
    """The port's own invariant (``tests/test_arch_smoke.py``'s): prefill
    then one decode step gives the full forward's last logits. MoE
    capacity is raised so no slot drops between the two batch shapes."""
    kw = {}
    if ARCHS[arch].n_experts:
        kw["capacity_factor"] = float(ARCHS[arch].reduced().n_experts)
    _, _, cfg, params = _pair(arch, seed=42, **kw)
    B, S = 2, 20
    _, tkw = _inputs(cfg, 6, B, S)
    full, _, _ = ttr.forward(params, cfg, **tkw)
    cache = ttr.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    _, cache, _ = ttr.forward(params, cfg, cache=cache, **_head(tkw, 1))
    last, cache, _ = ttr.forward(params, cfg, cache=cache, **_last(tkw, 1))
    assert cache["pos"] == S
    _close(last[:, 0], full[:, -1].numpy())


def _swa_cfg():
    return dataclasses.replace(ARCHS["mixtral-8x22b"].reduced(),
                               n_experts=0, layer_pattern=(LayerSpec("swa"),))


def test_ring_prompt_shorter_than_window_decodes_like_the_full_forward():
    """ROADMAP C.12: a 5-token prompt into window-8 rings (cache of 12);
    the JAX package raises on the shapes. Three decode steps follow, the
    last ones past the window."""
    cfg = _swa_cfg()
    params = ttr.init_params(cfg, torch.Generator().manual_seed(7),
                             device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 12)).astype(np.int32))
    full, _, _ = ttr.forward(params, cfg, tokens=toks)
    cache = ttr.init_cache(cfg, 1, 12, device="cpu")
    assert cache["layers"][0].k.shape[1] == cfg.window == 8
    _, cache, _ = ttr.forward(params, cfg, tokens=toks[:, :5], cache=cache)
    for t in range(5, 12):
        last, cache, _ = ttr.forward(params, cfg, tokens=toks[:, t:t + 1],
                                     cache=cache)
        _close(last[:, 0], full[:, t].numpy(), err_msg=f"position {t}")


@pytest.mark.parametrize("s", [20, 128, 130, 256])
def test_rwkv_prefill_state_at_any_length(s):
    """ROADMAP C.13: the wkv state after a prefill of s tokens. At
    s <= 128 and s = 256 the JAX package's chunked scan pads nothing and
    is right: the port's state and decode match it. At s = 130 it pads
    with zero steps that wipe the state; the port's decode matches its
    own full forward there."""
    cfg = ARCHS["rwkv6-7b"].reduced()
    cfg = dataclasses.replace(cfg, n_layers=1)
    jcfg = dataclasses.replace(JARCHS["rwkv6-7b"].reduced(), n_layers=1)
    p = jtr.init_params(jcfg, jax.random.PRNGKey(8))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, p), cfg,
                                          device="cpu")
    toks = np.random.default_rng(s).integers(
        0, cfg.vocab_size, (1, s + 1)).astype(np.int32)
    tt = torch.from_numpy(toks)
    full, _, _ = ttr.forward(params, cfg, tokens=tt)
    cache = ttr.init_cache(cfg, 1, s + 1, device="cpu")
    _, cache, _ = ttr.forward(params, cfg, tokens=tt[:, :s], cache=cache)
    last, _, _ = ttr.forward(params, cfg, tokens=tt[:, s:], cache=cache)
    _close(last[:, 0], full[:, -1].numpy())
    if s % 128 and s > 128:
        return
    jc = jtr.init_cache(jcfg, 1, s + 1, dtype=jnp.float32)
    _, jc, _ = jtr.forward(p, jcfg, tokens=toks[:, :s], cache=jc)
    _layers_close(cache["layers"], jc, cfg)
    jlast, _, _ = jtr.forward(p, jcfg, tokens=toks[:, s:], cache=jc)
    _close(last, jlast)


def test_moe_forward_is_reproducible():
    _, _, cfg, params = _pair("arctic-480b")
    _, tkw = _inputs(cfg, 9, 2, 16)
    a, _, aux_a = ttr.forward(params, cfg, **tkw)
    b, _, aux_b = ttr.forward(params, cfg, **tkw)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
