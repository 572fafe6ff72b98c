"""Shared neural building blocks: RMSNorm, rotary embeddings, the MLPs
and the initialisers (the JAX package's ``repro.models.layers``).

Initialisers draw from an explicit ``torch.Generator`` and build on its
device (or give shapes alone on the meta device). ``mlp_forward_tp`` is
the tensor-parallel MLP of the sharded path, on this rank's shards.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    """RMSNorm in f32 with the scale stored as an offset from 1."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, Dh); positions: (B, S) absolute token positions.
    Rotates the two halves of each head (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (Dh/2,)
    angles = positions[..., None].float() * freqs              # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_forward(params, x: Tensor, mlp_type: str) -> Tensor:
    """Gated / plain MLP. params: w1 (d, ff)[, w3 (d, ff)], w2 (ff, d)."""
    w3 = params["w3"] if mlp_type in ("swiglu", "geglu") else None
    return _mlp_hidden(x @ params["w1"], x, w3, mlp_type) @ params["w2"]


def _mlp_hidden(h1: Tensor, x: Tensor, w3, mlp_type: str) -> Tensor:
    """The MLP's hidden activation from h1 = x @ w1 (and x @ w3)."""
    if mlp_type == "swiglu":
        return F.silu(h1) * (x @ w3)
    if mlp_type == "geglu":
        return gelu(h1) * (x @ w3)
    if mlp_type == "relu2":
        return torch.square(F.relu(h1))
    if mlp_type == "gelu":
        return gelu(h1)
    raise ValueError(mlp_type)


def mlp_forward_tp(params, x: Tensor, mlp_type: str, ctx, specs) -> Tensor:
    """Megatron tensor-parallel MLP (the JAX package's ``mlp_forward_tp``):
    ``w1``/``w3`` column-parallel and ``w2`` row-parallel over "model",
    one psum of the activation-dtype partial over "model".

    ``params`` are this rank's shards, ``specs`` their PartitionSpecs and
    ``ctx`` the layout's ``sharding.collectives.ShardCtx``. With fsdp the
    weights' dmodel shards are gathered over "data" at use. The partial
    product is cast to the activation dtype BEFORE the all-reduce (the
    reference's reason for this path: GSPMD all-reduces the f32
    accumulator, twice the bytes); the backward's psum of dx at the
    column-parallel side is in the activation dtype too."""
    for name, dim in (("w1", 1), ("w2", 0)):
        if specs[name][dim:dim + 1] != ("model",):
            raise ValueError(f"mlp_forward_tp: {name} is not split over "
                             f"'model' on its ff dim: {specs[name]}")
    w = {k: ctx.gather(v, specs[k], keep=("model",))
         for k, v in params.items()}
    xl = ctx.copy_to(x, ("model",))
    h = _mlp_hidden(xl @ w["w1"], xl, w.get("w3"), mlp_type)
    part = (h @ w["w2"]).to(x.dtype)       # activation dtype BEFORE the psum
    return ctx.reduce_from(part, ("model",))


class MetaGenerator:
    """Stands in for a generator on the meta device: the initialisers then
    give shapes and dtypes, no values (``launch.specs.params_sds``)."""

    device = torch.device("meta")


def _gen(gen):
    return None if isinstance(gen, MetaGenerator) else gen


class Draw:
    """A draw recorded, not made: ``make(generator)`` makes it."""

    def __init__(self, make, shape):
        self.make, self.shape = make, tuple(shape)


class DeferredDraws:
    """Stands in for a generator: each draw of the initialisers becomes a
    ``Draw`` (recorded in ``draws``, in call order) in place of its
    tensor. Making the draws in that order with the generator gives the
    initialisers' values bitwise, one leaf at a time
    (``models.transformer.init_params_sharded``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.draws: list = []

    def defer(self, make, shape) -> Draw:
        d = Draw(make, shape)
        self.draws.append(d)
        return d


def normal(gen: torch.Generator, shape, scale: float, dtype) -> Tensor:
    """N(0, scale^2) drawn in f32 on the generator's device, then cast."""
    if isinstance(gen, DeferredDraws):
        return gen.defer(lambda g: normal(g, shape, scale, dtype), shape)
    return (torch.randn(shape, generator=_gen(gen), dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             dtype) -> dict:
    p = {"w1": normal(gen, (d_model, d_ff), d_model ** -0.5, dtype),
         "w2": normal(gen, (d_ff, d_model), d_ff ** -0.5, dtype)}
    if mlp_type in ("swiglu", "geglu"):
        p["w3"] = normal(gen, (d_model, d_ff), d_model ** -0.5, dtype)
    return p


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype) -> Tensor:
    return normal(gen, (vocab, d_model), d_model ** -0.5, dtype)


def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> Tensor:
    return normal(gen, shape, shape[0] ** -0.5 if scale is None else scale,
                  dtype)
