"""The port's LM building blocks (``repro_torch.models.{layers,attention,
moe,mamba,rwkv}``) held against the JAX package's on the same numpy
inputs and weights.

Weights come from the JAX package's initialisers and cross as numpy;
inputs are made from a numpy seed. Every comparison is within
atol 5e-4 / rtol 1e-3 (the tolerance of ``tests/test_arch_smoke.py``'s
decode check): both sides compute in f32 and differ in summation order
only. KV caches are compared buffer for buffer after prefill and decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import attention as jatt
from repro.models import layers as jlay
from repro.models import mamba as jmam
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro_torch.configs import ARCHS
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlay
from repro_torch.models import mamba as tmam
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv

ATOL, RTOL = 5e-4, 1e-3


def _close(port, ref, **kw):
    np.testing.assert_allclose(
        port.detach().numpy() if isinstance(port, torch.Tensor) else port,
        np.asarray(ref), atol=ATOL, rtol=RTOL, **kw)


def _t(tree):
    """A JAX tree of arrays -> the same tree of CPU tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _cfgs(name, **kw):
    return (dataclasses.replace(JARCHS[name].reduced(), **kw),
            dataclasses.replace(ARCHS[name].reduced(), **kw))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def test_rms_norm():
    x, scale = _x(0, 3, 5, 64), 0.1 * _x(1, 64)
    _close(tlay.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jlay.rms_norm(x, scale))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_rotates_halves(theta):
    x = _x(2, 2, 7, 3, 16)
    pos = np.tile(np.arange(40, 47, dtype=np.int32), (2, 1))
    _close(tlay.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           theta),
           jlay.apply_rope(x, pos, theta))


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_forward(mlp_type):
    p = jlay.mlp_init(jax.random.PRNGKey(3), 64, 128, mlp_type, jnp.float32)
    x = _x(4, 2, 5, 64)
    _close(tlay.mlp_forward(_t(p), torch.from_numpy(x), mlp_type),
           jlay.mlp_forward(p, x, mlp_type))


@pytest.mark.parametrize("window,q_chunk,q_offset",
                         [(0, 2048, 0), (4, 2048, 0), (0, 4, 0), (5, 4, 0),
                          (0, 4, 3)],
                         ids=["full", "swa", "chunked-padded",
                              "swa-chunked-padded", "offset"])
def test_chunked_causal_attention(window, q_chunk, q_offset):
    q, k, v = _x(5, 2, 13, 4, 16), _x(6, 2, 16, 4, 16), _x(7, 2, 16, 4, 16)
    out = tatt.chunked_causal_attention(
        *map(torch.from_numpy, (q, k, v)), window=window, q_chunk=q_chunk,
        q_offset=q_offset)
    ref = jatt.chunked_causal_attention(q, k, v, window=window,
                                        q_chunk=q_chunk, q_offset=q_offset)
    assert out.shape == (2, 13, 4, 16)
    _close(out, ref)


def test_repeat_kv_is_repeat_interleave():
    x = _x(8, 1, 3, 2, 4)
    _close(tatt._repeat_kv(torch.from_numpy(x), 6), jatt._repeat_kv(x, 6))


def _cache_close(tc, jc):
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)


@pytest.mark.parametrize("arch,seq_len", [
    ("llama3.2-3b", 12),        # full attention, GQA 4:2
    ("mixtral-8x22b", 12),      # SWA on the window-sized ring (window 8)
    ("mixtral-8x22b", 6),       # SWA on a cache shorter than the window
])
def test_attention_forward_train_prefill_decode(arch, seq_len):
    jcfg, cfg = _cfgs(arch)
    mixer = jcfg.layer_pattern[0].mixer
    p = jatt.attn_init(jax.random.PRNGKey(9), jcfg.d_model, jcfg.n_heads,
                       jcfg.n_kv_heads, jcfg.head_dim, jnp.float32)
    tp = _t(p)
    x = _x(10, 2, seq_len, jcfg.d_model)
    s = seq_len - 1
    pos = np.tile(np.arange(seq_len, dtype=np.int32), (2, 1))

    # train
    out, none = tatt.attention_forward(
        tp, torch.from_numpy(x), cfg, mixer, positions=torch.from_numpy(pos))
    ref, _ = jatt.attention_forward(p, x, jcfg, mixer, positions=pos)
    assert none is None
    _close(out, ref)

    # prefill of s tokens, then one decode step at position s
    jc = jatt.make_kv_cache(jcfg, mixer, 2, seq_len, jnp.float32)
    tc = tatt.make_kv_cache(cfg, mixer, 2, seq_len, torch.float32, "cpu")
    assert tuple(tc.k.shape) == jc.k.shape
    out, tc2 = tatt.attention_forward(
        tp, torch.from_numpy(x[:, :s]), cfg, mixer,
        positions=torch.from_numpy(pos[:, :s]), cache=tc, cache_pos=0)
    ref, jc = jatt.attention_forward(p, x[:, :s], jcfg, mixer,
                                     positions=pos[:, :s], cache=jc,
                                     cache_pos=jnp.int32(0))
    assert tc2.k is tc.k                       # written in place
    _close(out, ref)
    _cache_close(tc, jc)
    out, tc = tatt.attention_forward(
        tp, torch.from_numpy(x[:, s:]), cfg, mixer,
        positions=torch.from_numpy(pos[:, s:]), cache=tc, cache_pos=s)
    ref, jc = jatt.attention_forward(p, x[:, s:], jcfg, mixer,
                                     positions=pos[:, s:], cache=jc,
                                     cache_pos=jnp.int32(s))
    _close(out, ref)
    _cache_close(tc, jc)


def test_ring_prefill_shorter_than_the_window():
    """ROADMAP C.12: a prompt of 5 tokens into a ring of window 8 (the
    JAX package raises on the shapes). The decode that follows matches
    the full forward of the same 6 tokens."""
    _, cfg = _cfgs("mixtral-8x22b")
    p = jatt.attn_init(jax.random.PRNGKey(11), cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim, jnp.float32)
    tp = _t(p)
    x = torch.from_numpy(_x(12, 1, 6, cfg.d_model))
    pos = torch.arange(6)[None]
    full, _ = tatt.attention_forward(tp, x, cfg, "swa", positions=pos)
    cache = tatt.make_kv_cache(cfg, "swa", 1, 12, torch.float32, "cpu")
    assert cache.k.shape[1] == cfg.window == 8
    tatt.attention_forward(tp, x[:, :5], cfg, "swa", positions=pos[:, :5],
                           cache=cache, cache_pos=0)
    last, _ = tatt.attention_forward(tp, x[:, 5:], cfg, "swa",
                                     positions=pos[:, 5:], cache=cache,
                                     cache_pos=5)
    _close(last[:, 0], full[:, -1].numpy())
    assert torch.count_nonzero(cache.k[:, 6:]) == 0   # slots 6, 7 unused


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5],
                         ids=["cf1.25", "drops"])
@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2"])
def test_moe_forward(capacity_factor, mlp_type):
    E, K = 4, 2
    p = jmoe.moe_init(jax.random.PRNGKey(13), 64, E, 64, mlp_type,
                      jnp.float32)
    x = _x(14, 2, 9, 64)
    out, aux = tmoe.moe_forward(_t(p), torch.from_numpy(x), n_experts=E,
                                top_k=K, capacity_factor=capacity_factor,
                                mlp_type=mlp_type)
    ref, raux = jmoe.moe_forward(p, x, n_experts=E, top_k=K,
                                 capacity_factor=capacity_factor,
                                 mlp_type=mlp_type)
    _close(out, ref)
    _close(aux, raux)
    if capacity_factor < 1:                # some slots were dropped
        C = int(18 * K * capacity_factor / E + 0.999)
        counts = np.bincount(np.asarray(jax.lax.top_k(jax.nn.softmax(
            x.reshape(18, 64) @ np.asarray(p["router"])), K)[1]).ravel(),
            minlength=E)
        assert counts.max() > C


def test_moe_top_k_breaks_ties_as_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    vals, ids = tmoe._top_k(torch.from_numpy(probs), 2)
    jvals, jids = jax.lax.top_k(probs, 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_forward(with_state):
    jcfg, cfg = _cfgs("jamba-1.5-large-398b")
    p = jmam.mamba_init(jax.random.PRNGKey(15), jcfg, jnp.float32)
    tp = _t(p)
    x = _x(16, 2, 7, jcfg.d_model)
    if not with_state:
        out, st = tmam.mamba_forward(tp, torch.from_numpy(x), cfg)
        ref, _ = jmam.mamba_forward(p, x, jcfg)
        assert st is None
        _close(out, ref)
        return
    js = jmam.make_mamba_state(jcfg, 2, jnp.float32)
    ts = tmam.make_mamba_state(cfg, 2, torch.float32, "cpu")
    for sl in (slice(0, 6), slice(6, 7)):     # prefill, then one step
        out, ts = tmam.mamba_forward(tp, torch.from_numpy(x[:, sl]), cfg,
                                     state=ts)
        ref, js = jmam.mamba_forward(p, x[:, sl], jcfg, state=js)
        _close(out, ref)
        _close(ts.conv, js.conv)
        _close(ts.h, js.h)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_time_and_channel_mix(with_state):
    jcfg, cfg = _cfgs("rwkv6-7b")
    p = jrwkv.rwkv_init(jax.random.PRNGKey(17), jcfg, jnp.float32)
    pc = jrwkv.channel_mix_init(jax.random.PRNGKey(18), jcfg, jnp.float32)
    tp, tpc = _t(p), _t(pc)
    x = _x(19, 2, 7, jcfg.d_model)
    if not with_state:
        out, xs, wkv = trwkv.rwkv_time_mix(tp, torch.from_numpy(x), cfg)
        ref, _, _ = jrwkv.rwkv_time_mix(p, x, jcfg)
        assert xs is None and wkv is None
        _close(out, ref)
        out, xc = trwkv.rwkv_channel_mix(tpc, torch.from_numpy(x))
        _close(out, jrwkv.rwkv_channel_mix(pc, x)[0])
        assert xc is None
        return
    js = jrwkv.make_rwkv_state(jcfg, 2, jnp.float32)
    ts = trwkv.make_rwkv_state(cfg, 2, torch.float32, "cpu")
    for sl in (slice(0, 6), slice(6, 7)):
        xt = torch.from_numpy(x[:, sl])
        out, x_tm, wkv = trwkv.rwkv_time_mix(tp, xt, cfg, state=ts)
        ref, jx_tm, jwkv = jrwkv.rwkv_time_mix(p, x[:, sl], jcfg, state=js)
        _close(out, ref)
        _close(x_tm, jx_tm)
        _close(wkv, jwkv)
        out, x_cm = trwkv.rwkv_channel_mix(tpc, xt, x_prev=ts.x_cm)
        ref, jx_cm = jrwkv.rwkv_channel_mix(pc, x[:, sl], x_prev=js.x_cm)
        _close(out, ref)
        _close(x_cm, jx_cm)
        ts = trwkv.RWKVState(x_tm=x_tm, x_cm=x_cm, wkv=wkv)
        js = jrwkv.RWKVState(x_tm=jx_tm, x_cm=jx_cm, wkv=jwkv)
