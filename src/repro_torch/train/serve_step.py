"""Serving steps: prefill (fill the KV/SSM caches) and decode (one token)
— the JAX package's ``repro.train.serve_step``.

Decode writes the KV buffers in place (the JAX step donates its cache):
at long contexts the cache is the memory footprint and a copy would
double it. Greedy decoding is a Python loop of decode steps.

Sharded (``constrain`` from ``sharding.specs.make_constrain``, layout
"tp" or "fsdp"): every rank calls the step with the same global inputs,
its shard of the parameters (``init_params_sharded`` / ``shard_params``)
and its shard of the cache (``sharding.state.init_cache_sharded`` /
``shard_cache``; under either layout placed by ``cache_spec_for_leaf``,
as the JAX package's ``decode_specs`` places it); the logits come back
for the whole batch on every rank (its rows gathered over the batch
split, every axis of it under "fsdp"), as the JAX steps' global arrays
do.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import forward, init_cache

Tensor = torch.Tensor


def _whole_batch(logits: Tensor, constrain, cache: dict) -> Tensor:
    """A sharded forward's rows of the logits -> every row (gathered over
    the batch split the cache's layout records, the layout's own)."""
    sh = getattr(constrain, "sharding", None)
    return (logits if sh is None
            else sh.with_split(cache["split"]).gather_split(logits))


def make_prefill(cfg: ArchConfig, *, constrain=None,
                 q_chunk: int = 2048) -> Callable:
    def prefill(params, cache, batch: dict):
        kwargs = {}
        if "embeds" in batch:
            kwargs["embeds"] = batch["embeds"]
        else:
            kwargs["tokens"] = batch["tokens"]
        if "vision_embeds" in batch:
            kwargs["vision_embeds"] = batch["vision_embeds"]
        logits, cache, _ = forward(params, cfg, cache=cache,
                                   constrain=constrain, q_chunk=q_chunk,
                                   **kwargs)
        return _whole_batch(logits[:, -1:], constrain, cache), cache

    return prefill


def make_decode(cfg: ArchConfig, *, constrain=None) -> Callable:
    def decode(params, cache, token: Tensor):
        logits, cache, _ = forward(params, cfg, tokens=token, cache=cache,
                                   constrain=constrain)
        return _whole_batch(logits, constrain, cache), cache

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
