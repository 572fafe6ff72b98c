"""Top-k MoE with sort-based capacity dispatch (GShard semantics, static
shapes) — the JAX package's single-device ``moe_forward`` path.

1. router top-k in f32 -> (T*k,) flat expert ids + renormalised gates,
2. stable argsort by expert id; position within the expert by running
   counts,
3. tokens beyond the per-expert capacity C = ceil(T*k*cf / E) are dropped,
4. the kept tokens are copied into the (E, C, d) dispatch buffer and the
   batched expert FFN runs over it,
5. each token's k gated expert outputs are added back in top-k order.

Two choices keep a call reproducible on the card: the top-k is a stable
descending sort (``lax.top_k``'s order among ties: the lower expert id
first), and the combine adds each token's contributions in a fixed order
instead of an atomic scatter-add. The expert-parallel paths (``a2a``,
``psum`` over a mesh) belong to the sharding slice.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, gelu, normal

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, d_model: int, n_experts: int, ff: int,
             mlp_type: str, dtype) -> dict:
    s_in, s_ff = d_model ** -0.5, ff ** -0.5
    p = {"router": dense_init(gen, (d_model, n_experts), torch.float32),
         "w1": normal(gen, (n_experts, d_model, ff), s_in, dtype),
         "w2": normal(gen, (n_experts, ff, d_model), s_ff, dtype)}
    if mlp_type in ("swiglu", "geglu"):
        p["w3"] = normal(gen, (n_experts, d_model, ff), s_in, dtype)
    return p


def _expert_ffn(params, x: Tensor, mlp_type: str) -> Tensor:
    """x: (E, C, d) -> (E, C, d), batched over experts."""
    h1 = torch.bmm(x, params["w1"])
    if mlp_type == "swiglu":
        h = F.silu(h1) * torch.bmm(x, params["w3"])
    elif mlp_type == "geglu":
        h = gelu(h1) * torch.bmm(x, params["w3"])
    elif mlp_type == "relu2":
        h = torch.square(F.relu(h1))
    else:
        raise ValueError(mlp_type)
    return torch.bmm(h, params["w2"])


def _top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``lax.top_k``: the k largest per row, ties to the lower index."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_forward(params, x: Tensor, *, n_experts: int, top_k: int,
                capacity_factor: float, mlp_type: str
                ) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d). Returns (output, Switch-style aux loss)."""
    b, s, d = x.shape
    T = b * s
    xf = x.reshape(T, d)
    E, K = n_experts, top_k
    C = max(1, int((T * K * capacity_factor) / E + 0.999))

    logits = xf.float() @ params["router"]                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, K)                  # (T, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    flat_expert = expert_ids.reshape(-1)                      # (T*K,)
    counts = torch.bincount(flat_expert, minlength=E)         # (E,)
    # Load-balancing aux loss: E * sum(mean prob * routed share).
    me = probs.mean(dim=0)
    ce = counts.float() / (T * K)
    aux = E * torch.sum(me * ce)

    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = order // K                                           # token ids
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=x.device) - starts[se]  # rank in expert
    keep = pos < C
    # Kept slots are distinct; dropped tokens go to a spare row E*C.
    slot = torch.where(keep, se * C + pos, E * C)

    xdisp = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    xdisp.index_copy_(0, slot, xf[st])
    yexp = _expert_ffn(params, xdisp[:E * C].reshape(E, C, d), mlp_type)
    yexp = torch.cat([yexp.reshape(E * C, d),
                      torch.zeros((1, d), dtype=x.dtype, device=x.device)])

    # Combine: each (token, k) pair's gated expert output, back in the
    # (T, K) layout, summed over k in order.
    sg = gate_vals.reshape(-1)[order]
    contrib = yexp[slot] * (sg * keep)[:, None].to(x.dtype)
    per_tk = torch.empty_like(contrib)
    per_tk[order] = contrib
    per_tk = per_tk.reshape(T, K, d)
    y = per_tk[:, 0]
    for j in range(1, K):
        y = y + per_tk[:, j]
    return y.reshape(b, s, d), aux
