"""Selective SSM (Mamba) block — the time-step scan (the JAX package's
``repro.models.mamba``).

The recurrence h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t runs in
f32 as one operator, ``repro_torch::ssm_scan_fwd`` (``kernels.scan.ops``):
a hand-written kernel on the card (``csrc/ssm_scan.cu``), the plain loop
over time on the CPU. Like the JAX package's chunked ``lax.scan`` under
``jax.checkpoint``, it carries only the (B, inner, N) state, and its
backward keeps one carry a chunk of 128 steps and recomputes each chunk.
Decode is the same operator over one step with the state's conv tail.

On a sharded layout the block gets its weights gathered at use (its
"inner" dims are "model"-sharded at rest) and runs replicated over
"model": no tensor parallelism of its own in the port yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.scan.ops import ssm_scan
from repro_torch.models.layers import dense_init, normal

Tensor = torch.Tensor


class MambaState(NamedTuple):
    conv: Tensor  # (B, K-1, inner) last conv inputs
    h: Tensor     # (B, inner, N) SSM state


def mamba_init(gen: torch.Generator, cfg, dtype) -> dict:
    d, inner = cfg.d_model, cfg.ssm_inner
    N, K, R = cfg.ssm_state, cfg.ssm_conv, cfg.dt_rank_actual
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (d, 2 * inner), dtype),
        "conv_w": normal(gen, (K, inner), K ** -0.5, dtype),
        "x_proj": dense_init(gen, (inner, R + 2 * N), dtype),
        "dt_proj": dense_init(gen, (R, inner), dtype),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                        device=dev).repeat(inner, 1)),
        "D": torch.ones((inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (inner, d), dtype),
    }


def _ssm_scan(u: Tensor, dt: Tensor, B: Tensor, C: Tensor, A: Tensor,
              D: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """u, dt: (Bt, S, inner); B, C: (Bt, S, N); A: (inner, N);
    h0: (Bt, inner, N). Returns (y: (Bt, S, inner), h after the last
    step)."""
    return ssm_scan(u, dt, B, C, A, D, h0)


def mamba_forward(params, x: Tensor, cfg, *,
                  state: Optional[MambaState] = None
                  ) -> Tuple[Tensor, Optional[MambaState]]:
    """x: (B, S, d). state carries (conv tail, SSM h) for decode."""
    b, s, d = x.shape
    inner, N = cfg.ssm_inner, cfg.ssm_state
    K, R = cfg.ssm_conv, cfg.dt_rank_actual

    xz = x @ params["in_proj"]                       # (B, S, 2*inner)
    u, z = torch.chunk(xz, 2, dim=-1)

    # Depthwise causal conv over time (kernel K).
    if state is None:
        pad = torch.zeros((b, K - 1, inner), dtype=u.dtype, device=u.device)
    else:
        pad = state.conv
    upad = torch.cat([pad, u], dim=1)                # (B, S+K-1, inner)
    conv_w = params["conv_w"].to(u.dtype)            # (K, inner)
    uc = sum(upad[:, i:i + s] * conv_w[i][None, None] for i in range(K))
    uc = F.silu(uc)

    proj = uc @ params["x_proj"]                     # (B, S, R+2N)
    dt_r, Bc, Cc = torch.split(proj, [R, N, N], dim=-1)
    # jax.nn.softplus is logaddexp(x, 0)
    dt_in = dt_r @ params["dt_proj"]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in)).float()
    A = -torch.exp(params["A_log"])                  # (inner, N)

    h0 = (state.h if state is not None
          else torch.zeros((b, inner, N), dtype=torch.float32,
                           device=x.device))
    y, h = _ssm_scan(uc.float(), dt, Bc.float(), Cc.float(), A, params["D"],
                     h0)
    y = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]

    if state is None:
        return y, None
    return y, MambaState(conv=upad[:, -(K - 1):], h=h)


def make_mamba_state(cfg, batch: int, dtype, device) -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.ssm_inner),
                         dtype=dtype, device=device),
        h=torch.zeros((batch, cfg.ssm_inner, cfg.ssm_state),
                      dtype=torch.float32, device=device))
