"""Serving steps: prefill (fill the KV/SSM caches) and decode (one token)
— the JAX package's ``repro.train.serve_step``.

Decode writes the KV buffers in place (the JAX step donates its cache):
at long contexts the cache is the memory footprint and a copy would
double it. Greedy decoding is a Python loop of decode steps.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import forward, init_cache

Tensor = torch.Tensor


def make_prefill(cfg: ArchConfig, *, q_chunk: int = 2048) -> Callable:
    def prefill(params, cache, batch: dict):
        kwargs = {}
        if "embeds" in batch:
            kwargs["embeds"] = batch["embeds"]
        else:
            kwargs["tokens"] = batch["tokens"]
        if "vision_embeds" in batch:
            kwargs["vision_embeds"] = batch["vision_embeds"]
        logits, cache, _ = forward(params, cfg, cache=cache,
                                   q_chunk=q_chunk, **kwargs)
        return logits[:, -1:], cache

    return prefill


def make_decode(cfg: ArchConfig) -> Callable:
    def decode(params, cache, token: Tensor):
        logits, cache, _ = forward(params, cfg, tokens=token, cache=cache)
        return logits, cache

    return decode


def greedy_generate(cfg: ArchConfig, params, prompt, n_new: int,
                    cache_len: Optional[int] = None) -> Tensor:
    """Greedy autoregressive loop on the parameters' device: (b, n_new)
    int32 tokens. ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    dev = params.embed.device
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    cache_len = cache_len or (s + n_new)
    cache = init_cache(cfg, b, cache_len, dtype=cfg.dtype, device=dev)
    prefill, decode = make_prefill(cfg), make_decode(cfg)
    logits, cache = prefill(params, cache, {"tokens": prompt})
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out = [tok]
    for _ in range(n_new - 1):
        logits, cache = decode(params, cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)
