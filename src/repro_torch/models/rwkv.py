"""RWKV6 "Finch" block: time-mix with data-dependent decay + channel-mix
(the JAX package's ``repro.models.rwkv``).

Per head with dim D, the wkv state S in R^{DxD} evolves as

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

with the decay w_t = exp(-exp(wbase + lora(x_t))). Token-shift
interpolation feeds each projection a mix of x_t and x_{t-1}.

The recurrence runs in f32 as one operator, ``repro_torch::wkv6_fwd``
(``kernels.scan.ops``): a hand-written kernel on the card
(``csrc/wkv6.cu``), the plain loop over time on the CPU; its backward
keeps one (B, H, D, D) carry a chunk of 128 steps and recomputes each
chunk, as the JAX package's ``jax.checkpoint`` of each chunk does. It
scans the real steps only, so the returned state is the state after the
last token for any sequence length. (The JAX package pads its chunked
scan with zero steps, which wipe the state when the length is above 128
and no multiple of it: ROADMAP C.13.)

On a sharded layout both mixes get their weights gathered at use (the
heads and ff dims are "model"-sharded at rest) and run replicated over
"model": no tensor parallelism of their own in the port yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.scan.ops import wkv6
from repro_torch.models.layers import (DeferredDraws, _gen, dense_init,
                                       normal)

Tensor = torch.Tensor
LORA_R = 64


class RWKVState(NamedTuple):
    x_tm: Tensor   # (B, d) previous token for time-mix shift
    x_cm: Tensor   # (B, d) previous token for channel-mix shift
    wkv: Tensor    # (B, H, D, D) state matrix


def _uniform(gen: torch.Generator, shape, dtype) -> Tensor:
    if isinstance(gen, DeferredDraws):
        return gen.defer(lambda g: _uniform(g, shape, dtype), shape)
    return torch.rand(shape, generator=_gen(gen), dtype=torch.float32,
                      device=gen.device).to(dtype)


def rwkv_init(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    H, D = cfg.rwkv_heads, cfg.rwkv_head_dim
    dev = gen.device
    return {
        # time-mix interpolation factors per projection (r, k, v, g, w).
        "mu": _uniform(gen, (5, d), dtype),
        "wr": dense_init(gen, (d, d), dtype),
        "wk": dense_init(gen, (d, d), dtype),
        "wv": dense_init(gen, (d, d), dtype),
        "wg": dense_init(gen, (d, d), dtype),
        "wo": dense_init(gen, (d, d), dtype),
        # data-dependent decay LoRA: d -> LORA_R -> d, plus base decay.
        "w_base": torch.full((d,), -6.0, dtype=torch.float32, device=dev),
        "w_lora_a": dense_init(gen, (d, LORA_R), dtype),
        "w_lora_b": dense_init(gen, (LORA_R, d), dtype),
        "u": normal(gen, (H, D), 0.1, torch.float32),
        "ln_x": torch.zeros((d,), dtype=torch.float32, device=dev),
    }


def channel_mix_init(gen: torch.Generator, cfg, dtype) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {"mu": _uniform(gen, (2, d), dtype),
            "wk": dense_init(gen, (d, ff), dtype),
            "wv": dense_init(gen, (ff, d), dtype)}


def _shift(x: Tensor, x_prev: Optional[Tensor]) -> Tensor:
    """x: (B, S, d) -> previous-token tensor (B, S, d)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    else:
        x_prev = x_prev[:, None, :]
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def rwkv_time_mix(params, x: Tensor, cfg, *,
                  state: Optional[RWKVState] = None
                  ) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """Returns (out, new_x_tm, new_wkv); the last two are None without a
    state."""
    b, s, d = x.shape
    H, D = cfg.rwkv_heads, cfg.rwkv_head_dim

    xs = _shift(x, state.x_tm if state is not None else None)
    mu = params["mu"].to(x.dtype)
    mix = [x * mu[i][None, None] + xs * (1 - mu[i][None, None])
           for i in range(5)]
    r = (mix[0] @ params["wr"]).reshape(b, s, H, D).float()
    k = (mix[1] @ params["wk"]).reshape(b, s, H, D).float()
    v = (mix[2] @ params["wv"]).reshape(b, s, H, D).float()
    g = F.silu(mix[3] @ params["wg"])
    # Data-dependent decay (Finch): w_t in (0, 1).
    w_raw = params["w_base"].float() + \
        ((mix[4] @ params["w_lora_a"]) @ params["w_lora_b"]).float()
    w = torch.exp(-torch.exp(w_raw)).reshape(b, s, H, D)
    u = params["u"]                                    # (H, D)

    S = (state.wkv if state is not None
         else torch.zeros((b, H, D, D), dtype=torch.float32,
                          device=x.device))
    y, S = wkv6(r, k, v, w, u, S)
    y = y.reshape(b, s, d).to(x.dtype)

    # Group norm over heads (ln_x), then gate and output-project.
    yh = y.reshape(b, s, H, D).float()
    yh = yh * torch.rsqrt(torch.mean(yh * yh, dim=-1, keepdim=True) + 1e-5)
    y = (yh.reshape(b, s, d) * (1.0 + params["ln_x"])[None, None]) \
        .to(x.dtype)
    out = (y * g) @ params["wo"]

    if state is None:
        return out, None, None
    return out, x[:, -1], S


def rwkv_channel_mix(params, x: Tensor, *,
                     x_prev: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Optional[Tensor]]:
    xs = _shift(x, x_prev)
    mu = params["mu"].to(x.dtype)
    xk = x * mu[0][None, None] + xs * (1 - mu[0][None, None])
    h = torch.square(F.relu(xk @ params["wk"]))
    out = h @ params["wv"]
    return out, (x[:, -1] if x_prev is not None else None)


def make_rwkv_state(cfg, batch: int, dtype, device) -> RWKVState:
    return RWKVState(
        x_tm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        x_cm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        wkv=torch.zeros((batch, cfg.rwkv_heads, cfg.rwkv_head_dim,
                         cfg.rwkv_head_dim), dtype=torch.float32,
                        device=device))
