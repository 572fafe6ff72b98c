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

Sharded (``attention_forward_sharded``, a cache under the "tp" layout,
or under "fsdp" on the cache's rows, ``transformer._regrouped``):
each rank's KV buffers are its shard under ``cache_spec_for_leaf`` —
rows over the batch axes, positions over "model" (over the batch axes
and "model" together when the batch does not split). It shares the
one-device path's projections, prefill attention, cache writes and
decode attention, and adds the slot window and the combine. Prefill runs
the training path's attention (local heads, or every head where they do
not divide "model"), then gathers the new keys and values over the heads
and the batch split and keeps its own positions. Decode is
flash-decoding over the ranks that hold the positions: the one-token
query gathered, each rank's softmax over its own slots, then one max
all-reduce and two sums to weigh and add the ranks' outputs
(``_combine``; on one rank it is the one-device decode, bitwise); the
rank whose slots hold the new token's writes it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.sharding.collectives import entry_axes, padded

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


def _decode_valid(kpos: Tensor, cache_pos: int, window: int,
                  ring: bool) -> Tensor:
    """Which buffer slots ``kpos`` a decode step at ``cache_pos`` reads: a
    ring's every written slot, else the positions up to ``cache_pos``
    (within the window)."""
    if ring:
        return (kpos <= cache_pos) | (cache_pos >= window)
    valid = kpos <= cache_pos
    if window:
        valid &= kpos > cache_pos - window
    return valid


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


def _qkv(params, x: Tensor, cfg, n_heads: int, n_kv_heads: int,
         positions: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The projections of ``x`` into ``n_heads`` query and ``n_kv_heads``
    key/value heads, q and k RoPE'd."""
    q = _split_heads(x @ params["wq"], n_heads, cfg.head_dim)
    k = _split_heads(x @ params["wk"], n_kv_heads, cfg.head_dim)
    v = _split_heads(x @ params["wv"], n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _write_prefill(cache: KVCache, k: Tensor, v: Tensor, window: int,
                   ring: bool, start: int = 0) -> None:
    """Prefill: the fresh sequence's (roped) keys/values that the cache
    keeps, written into its buffer, which holds the global slots
    ``start`` .. ``start`` + its length (the whole cache on one device).
    A ring keeps the last min(s, window) positions at their position
    modulo the window, a full buffer each position at its own."""
    s, n = k.shape[1], cache.k.shape[1]
    if not ring:
        hi = min(s, start + n)
        if start < hi:
            cache.k[:, :hi - start] = k[:, start:hi]
            cache.v[:, :hi - start] = v[:, start:hi]
        return
    pos = torch.arange(s - min(s, window), s)          # on the host
    slot = pos % window
    mine = (slot >= start) & (slot < start + n)
    pos, slot = pos[mine].to(k.device), (slot[mine] - start).to(k.device)
    cache.k[:, slot] = k[:, pos]
    cache.v[:, slot] = v[:, pos]


def _decode_attend(q: Tensor, cache: KVCache, valid: Tensor,
                   n_kv_heads: int) -> Tuple[Tensor, Tensor]:
    """One query token (B, 1, Hq, Dh) over a KV buffer's ``valid`` slots,
    by the grouped score einsum (the cache is never repeated to Hq):
    (the output (B, 1, Hkv, g, Dh) in the cache's dtype, the masked f32
    scores (B, Hkv, g, 1, S_buf))."""
    b, _, hq, dh = q.shape
    qg = q.reshape(b, 1, n_kv_heads, hq // n_kv_heads, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          cache.k.float()) * (dh ** -0.5)
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(cache.v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", w, cache.v), scores


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
    q, k, v = _qkv(params, x, cfg, cfg.n_heads, cfg.n_kv_heads, positions)

    if cache is None or s > 1:
        out = chunked_causal_attention(
            q, _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads),
            window=window, q_chunk=q_chunk)
    if cache is not None and s > 1:
        _write_prefill(cache, k, v, window,
                       _ring(cfg, mixer, cache.k.shape[1]))
    elif cache is not None:
        # Decode: append one token, attend over the cache.
        s_buf = cache.k.shape[1]
        ring = _ring(cfg, mixer, s_buf)
        slot = cache_pos % window if ring else cache_pos
        cache.k[:, slot] = k[:, 0]
        cache.v[:, slot] = v[:, 0]
        valid = _decode_valid(torch.arange(s_buf, device=x.device),
                              cache_pos, window, ring)
        out, _ = _decode_attend(q, cache, valid, cfg.n_kv_heads)
        out = out.reshape(b, 1, cfg.n_heads, cfg.head_dim)

    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"], cache


def kv_buffer_len(cfg, mixer: str, seq_len: int) -> int:
    """A KV buffer's positions: the window's ring for an SWA layer whose
    sequence is longer, else ``seq_len``."""
    return (min(cfg.window, seq_len) if mixer == "swa" and cfg.window
            else seq_len)


class KVSlots(NamedTuple):
    """Where a rank's shard of a KV buffer lies under
    ``cache_spec_for_leaf``; ``sharding.state`` works it out once a
    cache."""
    rows: Tuple[str, ...]   # the axes the buffer's rows split over
    seq: Tuple[str, ...]    # the axes its positions split over
    start: int              # this rank's first global slot
    n: int                  # its slot count
    length: int             # the whole buffer's slots


def kv_slots(spec, length: int, sh) -> KVSlots:
    """The ``KVSlots`` of a buffer of ``length`` slots whose k/v take
    ``spec`` (``cache_spec_for_leaf``), on ``sh``'s rank."""
    spec = padded(spec, 4)
    rows, seq = entry_axes(spec[0]), entry_axes(spec[1])
    n = length // sh.size(seq)
    return KVSlots(tuple(rows), tuple(seq), sh.index(seq) * n, n, length)


def _combine(out: Tensor, scores: Tensor, comm) -> Tensor:
    """Flash-decoding's combine over the ranks ``comm`` spans, each
    holding some of the slots: each rank's output over its own slots
    (``_decode_attend``, softmax-normalised there) weighted by its share
    of the softmax's mass, exp(m_r - m) l_r / sum_r' exp(m_r' - m) l_r'
    (m_r the rank's largest score, m the largest over the ranks, l_r the
    rank's sum of exp(score - m_r)), summed over the ranks in f32.

    A masked score is NEG_INF, as on one device: it adds exactly 0 to
    l_r, and a rank whose slots are all masked has m_r = NEG_INF, so its
    share is exp(NEG_INF - m) = 0 (m is finite: the new token's slot is
    valid) and its output, finite, adds 0: no NaN. On one rank the share
    is l / l = 1 exactly, so the output is the one-device decode's,
    bitwise."""
    top = scores.amax(dim=-1, keepdim=True)               # (B, Hkv, g, 1, 1)
    mass = torch.exp(scores - top).sum(dim=-1, keepdim=True)
    mass = torch.exp(top - comm.pmax(top)) * mass
    share = (mass / comm.psum(mass)).permute(0, 3, 1, 2, 4)
    return comm.psum(out.float() * share).to(out.dtype)


def attention_forward_sharded(params, x: Tensor, cfg, mixer: str, sh, *,
                              heads: int, slots: KVSlots, positions: Tensor,
                              cache: KVCache, cache_pos: int,
                              q_chunk: int = 2048
                              ) -> Tuple[Tensor, KVCache]:
    """``attention_forward``'s prefill or decode on this rank's rows
    (``sh.split``) with its shard of the KV buffers (``slots``), written
    in place. ``heads``: how many ways the query and kv heads are split
    over "model" (``params`` then hold this rank's heads of wq/wk/wv and
    its rows of wo); 1 where every rank computes every head. Returns (the
    output before any sum over "model", the cache)."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads // heads, cfg.n_kv_heads // heads, cfg.head_dim
    window = cfg.window if mixer == "swa" else 0
    ring = _ring(cfg, mixer, slots.length)
    if slots.rows and slots.rows != tuple(sh.split):
        raise ValueError(f"the cache's rows split over {slots.rows}, the "
                         f"batch over {sh.split}")
    q, k, v = _qkv(params, x, cfg, hq, hkv, positions)

    def whole(t: Tensor) -> Tensor:
        """Every head, and the cache's rows (all of them unless the
        cache's rows split as the batch does)."""
        if heads > 1:
            t = sh.comm(("model",)).all_gather(t, dim=2)
        return t if slots.rows else sh.gather_split(t)

    kk, vv = whole(k), whole(v)
    if s > 1:
        out = chunked_causal_attention(
            q, _repeat_kv(k, hq), _repeat_kv(v, hq), window=window,
            q_chunk=q_chunk)
        _write_prefill(cache, kk, vv, window, ring, slots.start)
        return out.reshape(b, s, hq * dh) @ params["wo"], cache

    # Decode: the owner of the new token's slot writes it.
    slot = cache_pos % window if ring else cache_pos
    if slots.start <= slot < slots.start + slots.n:
        cache.k[:, slot - slots.start] = kk[:, 0]
        cache.v[:, slot - slots.start] = vv[:, 0]
    valid = _decode_valid(slots.start + torch.arange(slots.n,
                                                     device=x.device),
                          cache_pos, window, ring)        # global slots
    out, scores = _decode_attend(whole(q), cache, valid, cfg.n_kv_heads)
    if slots.seq:
        out = _combine(out, scores, sh.comm(slots.seq))
    out = out.reshape(out.shape[0], 1, cfg.n_heads, dh)
    if not slots.rows:
        out = sh.split_slice(out)
    if heads > 1:
        out = out.narrow(2, sh.index(("model",)) * hq, hq)
    return out.reshape(b, 1, hq * dh) @ params["wo"], cache


def make_kv_cache(cfg, mixer: str, batch: int, seq_len: int, dtype,
                  device) -> KVCache:
    s_buf = kv_buffer_len(cfg, mixer, seq_len)
    shape = (batch, s_buf, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
