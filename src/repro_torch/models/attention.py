"""Causal GQA attention with full / sliding-window variants and KV caches
(the JAX package's ``repro.models.attention``, single device).

Train and prefill run over query chunks so the score tensor is at most
(B, H, q_chunk, S); the scores are formed in f32 from f32 copies of q and
k (the JAX einsums' ``preferred_element_type=float32``). Decode reads a
cache: full layers keep (B, S, Hkv, Dh) buffers; SWA layers whose cache
is the window-sized ring keep keys RoPE'd at insert. Prefill and decode
write the cache buffers in place (the JAX step donates them).

Unlike the JAX package, a ring prefill shorter than the window is
supported (ROADMAP C.12): it writes the last min(s, window) keys at their
position modulo the window.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models.layers import apply_rope, dense_init

Tensor = torch.Tensor
NEG_INF = -1e30


class KVCache(NamedTuple):
    k: Tensor  # (B, S_buf, Hkv, Dh)
    v: Tensor  # (B, S_buf, Hkv, Dh)


def attn_init(gen: torch.Generator, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, dtype) -> dict:
    return {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), dtype),
        "wk": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wv": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), dtype),
    }


def _split_heads(x: Tensor, n_heads: int, head_dim: int) -> Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def _repeat_kv(x: Tensor, n_heads: int) -> Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hq, Dh), each kv head repeated in place
    (``jnp.repeat``: kv head j serves query heads j*g .. j*g + g - 1)."""
    hkv = x.shape[2]
    if hkv == n_heads:
        return x
    return torch.repeat_interleave(x, n_heads // hkv, dim=2)


def _ring(cfg, mixer: str, s_buf: int) -> bool:
    return mixer == "swa" and bool(cfg.window) and s_buf == cfg.window


def chunked_causal_attention(q: Tensor, k: Tensor, v: Tensor, *,
                             window: int = 0, q_chunk: int = 2048,
                             q_offset: int = 0) -> Tensor:
    """Causal (optionally windowed) attention over query chunks.

    q: (B, S, H, Dh); k, v: (B, T, H, Dh) — kv already head-repeated.
    q_offset: absolute position of q[0] relative to k[0].
    """
    b, s, h, dh = q.shape
    t = k.shape[1]
    scale = dh ** -0.5
    qc = min(q_chunk, s)
    n_chunks = (s + qc - 1) // qc
    pad = n_chunks * qc - s
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    kf = k.float()
    kpos = torch.arange(t, device=q.device)
    outs = []
    for ci in range(n_chunks):
        qb = q[:, ci * qc:(ci + 1) * qc].float()
        qpos = q_offset + ci * qc + torch.arange(qc, device=q.device)
        scores = torch.einsum("bqhd,bkhd->bhqk", qb, kf) * scale
        mask = kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = scores.masked_fill(~mask[None, None], NEG_INF)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", w, v))
    return torch.cat(outs, dim=1)[:, :s]


def attention_forward(params, x: Tensor, cfg, mixer: str, *,
                      positions: Tensor,
                      cache: Optional[KVCache] = None,
                      cache_pos: Optional[int] = None,
                      q_chunk: int = 2048
                      ) -> Tuple[Tensor, Optional[KVCache]]:
    """Unified train/prefill/decode attention.

    * train:   cache=None                       -> (out, None)
    * prefill: cache=empty buffers, cache_pos=0 -> (out, filled cache)
    * decode:  x is (B, 1, d), cache_pos=pos    -> (out, updated cache)

    The cache's buffers are written in place and returned.
    """
    b, s, _ = x.shape
    window = cfg.window if mixer == "swa" else 0

    q = _split_heads(x @ params["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None or s > 1:
        out = chunked_causal_attention(
            q, _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads),
            window=window, q_chunk=q_chunk)
    if cache is not None and s > 1:
        # Prefill: write the (roped) keys/values of the fresh sequence.
        if _ring(cfg, mixer, cache.k.shape[1]):
            n = min(s, window)
            idx = torch.arange(s - n, s, device=x.device) % window
            cache.k[:, idx] = k[:, s - n:]
            cache.v[:, idx] = v[:, s - n:]
        else:
            cache.k[:, :s] = k
            cache.v[:, :s] = v
    elif cache is not None:
        # Decode: append one token, attend over the cache.
        s_buf = cache.k.shape[1]
        ring = _ring(cfg, mixer, s_buf)
        slot = cache_pos % window if ring else cache_pos
        cache.k[:, slot] = k[:, 0]
        cache.v[:, slot] = v[:, 0]
        # The grouped score einsum: the cache is never repeated to Hq.
        g = cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(b, 1, cfg.n_kv_heads, g, cfg.head_dim)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                              cache.k.float()) * (cfg.head_dim ** -0.5)
        kpos = torch.arange(s_buf, device=x.device)
        if ring:
            valid = (kpos <= cache_pos) | (cache_pos >= window)
        else:
            valid = kpos <= cache_pos
            if window:
                valid &= kpos > cache_pos - window
        scores = scores.masked_fill(~valid, NEG_INF)
        w = torch.softmax(scores, dim=-1).to(cache.v.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", w, cache.v).reshape(
            b, 1, cfg.n_heads, cfg.head_dim)

    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"], cache


def make_kv_cache(cfg, mixer: str, batch: int, seq_len: int, dtype,
                  device) -> KVCache:
    s_buf = (min(cfg.window, seq_len) if mixer == "swa" and cfg.window
             else seq_len)
    shape = (batch, s_buf, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
