"""Shared neural building blocks: RMSNorm, rotary embeddings, the MLPs
and the initialisers (the JAX package's ``repro.models.layers``).

Initialisers draw from an explicit ``torch.Generator`` and build on its
device. The tensor-parallel MLP (``mlp_forward_tp``) belongs to the
sharding slice and is not here.
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
    if mlp_type == "swiglu":
        h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    elif mlp_type == "geglu":
        h = gelu(x @ params["w1"]) * (x @ params["w3"])
    elif mlp_type == "relu2":
        h = torch.square(F.relu(x @ params["w1"]))
    elif mlp_type == "gelu":
        h = gelu(x @ params["w1"])
    else:
        raise ValueError(mlp_type)
    return h @ params["w2"]


def normal(gen: torch.Generator, shape, scale: float, dtype) -> Tensor:
    """N(0, scale^2) drawn in f32 on the generator's device, then cast."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
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
