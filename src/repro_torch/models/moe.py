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
instead of an atomic scatter-add.

Over a mesh (``constrain`` carrying ``sharding``), the JAX package's
shard_map paths run on this rank's shards:

* ``_moe_forward_sharded`` (impl "psum"): experts over "model" when E
  divides it (EP), else each expert's ff over "model" (expert-TP); with
  fsdp the weights' dmodel shards are gathered over "data" at use; one
  psum of the combined output over "model";
* ``_moe_forward_a2a`` (impl "a2a"): experts over the data axes, ff over
  "model"; the dispatched tokens move to their experts' ranks and back
  (two all-to-alls) around one psum over "model".

Both route each rank's own tokens with the per-shard capacity (dropless
while T_loc * K <= 4096) and return the aux averaged over the data axes
and "model" (GShard's per-group balance loss, not the global batch's).
Under the "fsdp" layout (no tensor parallelism) the global path runs on
the tokens of every rank the batch is split over, gathered, so its
capacity and aux are the global batch's, as under GSPMD.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _mlp_hidden, dense_init, gelu, normal
from repro_torch.sharding.collectives import global_dim

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


def _route(xf: Tensor, router: Tensor, E: int, K: int):
    """Router top-k in f32, the aux loss and the tokens' order by expert:
    (aux, (order, se, st, sg, counts))."""
    T = xf.shape[0]
    logits = xf.float() @ router                              # (T, E)
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
    sg = gate_vals.reshape(-1)[order]
    return aux, (order, se, st, sg, counts)


def _dispatch(xf: Tensor, E: int, C: int, routing):
    """The kept tokens in the (E, C, d) buffer: (xdisp, slot, keep)."""
    order, se, st, _, counts = routing
    d = xf.shape[1]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(se.shape[0], device=xf.device) - starts[se]
    keep = pos < C                                            # rank in expert
    # Kept slots are distinct; dropped tokens go to a spare row E*C.
    slot = torch.where(keep, se * C + pos, E * C)
    xdisp = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    xdisp.index_copy_(0, slot, xf[st])
    return xdisp[:E * C].reshape(E, C, d), slot, keep


def _combine(yexp: Tensor, sg: Tensor, slot: Tensor, keep: Tensor,
             order: Tensor, T: int, K: int) -> Tensor:
    """Each (token, k) pair's gated expert output, back in the (T, K)
    layout, summed over k in order."""
    E, C, d = yexp.shape
    yexp = torch.cat([yexp.reshape(E * C, d),
                      torch.zeros((1, d), dtype=yexp.dtype,
                                  device=yexp.device)])
    contrib = yexp[slot] * (sg * keep)[:, None].to(yexp.dtype)
    per_tk = torch.empty_like(contrib)
    per_tk[order] = contrib
    per_tk = per_tk.reshape(T, K, d)
    y = per_tk[:, 0]
    for j in range(1, K):
        y = y + per_tk[:, j]
    return y


def _capacity(T: int, K: int, E: int, capacity_factor: float) -> int:
    return max(1, int((T * K * capacity_factor) / E + 0.999))


def _moe_global(params, xf: Tensor, *, E: int, K: int,
                capacity_factor: float, mlp_type: str):
    T = xf.shape[0]
    C = _capacity(T, K, E, capacity_factor)
    aux, routing = _route(xf, params["router"], E, K)
    xdisp, slot, keep = _dispatch(xf, E, C, routing)
    yexp = _expert_ffn(params, xdisp, mlp_type)
    order, _, _, sg, _ = routing
    return _combine(yexp, sg, slot, keep, order, T, K), aux


def moe_forward(params, x: Tensor, *, n_experts: int, top_k: int,
                capacity_factor: float, mlp_type: str, impl: str = "psum",
                constrain=None, specs=None) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d). Returns (output, Switch-style aux loss).

    With ``constrain`` carrying a sharded layout, ``params`` are this
    rank's shards and ``specs`` their PartitionSpecs: under "tp" the
    rank's tokens take ``_moe_forward_a2a`` (impl "a2a", when the experts
    divide the data axes and ff divides "model") or
    ``_moe_forward_sharded``; under "fsdp" the global path (see the
    module docstring)."""
    sh = getattr(constrain, "sharding", None)
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, mlp_type=mlp_type)
    if sh is not None and sh.layout == "tp":
        if impl == "a2a":
            dp = sh.size(sh.batch_axes)
            ff = global_dim(params["w1"], specs["w1"], -1, sh.mesh)
            if n_experts % dp == 0 and ff % sh.model == 0:
                return _moe_forward_a2a(params, x, sh, specs, **kw)
        return _moe_forward_sharded(params, x, sh, specs, **kw)
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    if sh is not None:
        # The global path on every split rank's tokens (GSPMD's values).
        w = sh.gather_all(params, specs)
        y, aux = _moe_global(w, sh.gather_split(xf), E=n_experts, K=top_k,
                             capacity_factor=capacity_factor,
                             mlp_type=mlp_type)
        return sh.split_slice(y).reshape(b, s, d), sh.replicated(aux)
    y, aux = _moe_global(params, xf, E=n_experts, K=top_k,
                         capacity_factor=capacity_factor, mlp_type=mlp_type)
    return y.reshape(b, s, d), aux


def _local_capacity(T_loc: int, K: int, E: int,
                    capacity_factor: float) -> int:
    """The sharded paths' capacity: dropless while T_loc * K <= 4096
    (decode, serving, small batches), else the capacity rule."""
    if T_loc * K <= 4096:
        return T_loc * K
    return _capacity(T_loc, K, E, capacity_factor)


def _moe_forward_sharded(params, x: Tensor, sh, specs, *, n_experts: int,
                         top_k: int, capacity_factor: float,
                         mlp_type: str) -> Tuple[Tensor, Tensor]:
    """Expert parallelism over "model" (EP when E % model == 0, else
    expert-TP on each expert's ff), ZeRO-3 gathers over "data" with fsdp,
    one psum of the combined output over "model".

    The routing and dispatch are computed alike on every "model" rank; the
    expert FFN is the rank's part (its experts, or its ff slice of every
    expert). Its input and the gates pass ``copy_to`` (their gradients are
    partial on each "model" rank), its combined output ``reduce_from``."""
    b, s, d = x.shape
    E, K = n_experts, top_k
    model = sh.model
    ep = E % model == 0
    e_loc = E // model if ep else E
    T_loc = b * s
    C_loc = _local_capacity(T_loc, K, E, capacity_factor)
    w = {k: sh.gather(params[k], specs[k], keep=("model",))
         for k in ("w1", "w2", "w3") if k in params}
    want = (e_loc, d, params["w1"].shape[-1])
    if tuple(w["w1"].shape) != want or (not ep and model > 1 and
                                        specs["w1"][-1:] != ("model",)):
        raise ValueError(f"MoE weights {tuple(w['w1'].shape)} ({specs['w1']})"
                         f" do not match the "
                         f"{'EP' if ep else 'expert-TP'} layout on "
                         f"{model} model ranks")

    xf = x.reshape(T_loc, d)
    aux, routing = _route(xf, params["router"], E, K)
    xdisp, slot, keep = _dispatch(xf, E, C_loc, routing)
    xdisp = sh.copy_to(xdisp, ("model",))
    e0 = sh.index(("model",)) * e_loc if ep else 0
    xs = xdisp[e0:e0 + e_loc] if e_loc != E else xdisp
    yexp = _expert_ffn(w, xs, mlp_type)                      # (e_loc, C, d)
    if e_loc != E:
        zeros = yexp.new_zeros
        yexp = torch.cat([zeros((e0, C_loc, d)), yexp,
                          zeros((E - e0 - e_loc, C_loc, d))])
    order, _, _, sg, _ = routing
    y = _combine(yexp, sh.copy_to(sg, ("model",)), slot, keep, order,
                 T_loc, K)
    # EP combine: each token's expert lives on one model rank (EP) or
    # every rank holds a partial-ff sum (expert-TP) — psum either way.
    y = sh.reduce_from(y, ("model",))
    aux = sh.pmean(aux, sh.batch_axes + ("model",))
    return y.reshape(b, s, d), aux


def _moe_forward_a2a(params, x: Tensor, sh, specs, *, n_experts: int,
                     top_k: int, capacity_factor: float,
                     mlp_type: str) -> Tuple[Tensor, Tensor]:
    """Experts over the data axes, each expert's ff over "model": the
    weights are never gathered. The rank routes its tokens into the
    (E, C_loc, d) buffer; an all-to-all over the data axes brings each
    rank its experts' tokens from every rank, (e_loc, C_loc * dp, d); the
    ff-TP partial is cast to the activation dtype and psummed over
    "model"; the reverse all-to-all brings the outputs home."""
    b, s, d = x.shape
    E, K = n_experts, top_k
    baxes = sh.batch_axes
    dp = sh.size(baxes)
    e_loc = E // dp
    T_loc = b * s
    C_loc = _local_capacity(T_loc, K, E, capacity_factor)
    keep_axes = tuple(baxes) + ("model",)
    w = {k: sh.gather(params[k], specs[k], keep=keep_axes)
         for k in ("w1", "w2", "w3") if k in params}
    if w["w1"].shape[0] != e_loc:
        raise ValueError(f"a2a MoE: {w['w1'].shape[0]} local experts, "
                         f"want {e_loc} ({specs['w1']})")

    xf = x.reshape(T_loc, d)
    aux, routing = _route(xf, params["router"], E, K)
    xdisp, slot, keep = _dispatch(xf, E, C_loc, routing)
    # Tokens -> expert owners: (e_loc, C_loc * dp, d), every rank's tokens.
    xexp = sh.all_to_all(xdisp, baxes, split_dim=0, concat_dim=1)
    xexp = sh.copy_to(xexp, ("model",))
    h = _mlp_hidden(torch.bmm(xexp, w["w1"]), xexp, w.get("w3"), mlp_type)
    ypart = torch.bmm(h, w["w2"]).to(x.dtype)
    yexp = sh.reduce_from(ypart, ("model",))       # ff-TP combine
    # Results -> token owners (the reverse all-to-all).
    ylocal = sh.all_to_all(yexp, baxes, split_dim=1, concat_dim=0)
    order, _, _, sg, _ = routing
    y = _combine(ylocal, sg, slot, keep, order, T_loc, K)
    aux = sh.pmean(aux, tuple(baxes) + ("model",))
    return y.reshape(b, s, d), aux
