"""The decoder stack over an arch's heterogeneous layer pattern (the JAX
package's ``repro.models.transformer``).

``init_params`` builds a ``Decoder``: an ``nn.Module`` holding the
embedding, the final norm, the unembedding and a ``ModuleList`` of
``DecoderLayer``s in stack order. Each layer holds its parameters under
the JAX package's names (``norm1``, ``attn``/``mamba``/``rwkv``,
``mlp``/``moe``/``dense_res``/``cmix``), so ``params.layers[i]["attn"]["wq"]``
is the JAX tree's ``segments["l{i % period}"]["attn"]["wq"][i // period]``
(or ``tail[...]`` past the whole periods). The JAX package scans over
the stacked periods; here the layers run in a loop.

Modes (one code path, the cache decides):
  * train:   cache=None, full sequence
  * prefill: cache=zero buffers, full sequence, returns the filled cache
  * decode:  cache=filled, single-token step from position cache["pos"]

The KV buffers of a cache are written in place; the returned cache holds
them with the new position and the new SSM/RWKV states. Modality
frontends are stubs: audio supplies frame embeddings in place of the
token embedding, vision supplies patch embeddings prepended to the text.

A ``Decoder``'s parameters carry no gradient: it serves. Training runs
``forward`` on ``param_tree(decoder)``, the same tensors in the JAX
package's layout (``utils.tree.Stacked`` for the stacked leaves), whose
leaves the train step makes require gradients. Where the forward records
a graph (train mode, gradients enabled, some input requiring them) each
layer is rematerialised by ``cfg.remat``, as the JAX package's
``_remat_wrap`` does per layer.

Sharded (``constrain`` from ``sharding.specs.make_constrain``): ``params``
are this rank's shards of the ``param_tree`` and the layers fetch their
weights at use (``ShardCtx.gather``), inside the rematerialised layer,
so a re-run layer fetches them again in the backward pass (every rank
re-runs its collectives in the same order). Under the "tp" layout:
attention is head-parallel over "model" when both the query and the kv
heads divide it (else its weights are gathered and it runs replicated
over "model", the values GSPMD's sequence-sharded layout computes); the
MLP is Megatron's (``mlp_forward_tp``) where ``cfg.tp_mlp`` asks for it;
the MoE takes its expert-parallel paths; the embedding is looked up by
vocab range on each "model" rank and summed over "model". Mamba, RWKV,
the dense MLP without ``tp_mlp``, arctic's dense residual and the
unembedding gather their weights at use and run replicated over "model"
(no tensor parallelism of their own yet). Under "fsdp" every weight is
gathered at use.

Sharded serving (a cache under a ``constrain``): the tokens are the
GLOBAL batch, each rank keeps its rows (``ShardCtx.batch_split``: the
longest prefix of the layout's batch axes that divides it, none at B = 1,
as the JAX package's ``_b``) and returns its rows' logits (the cache's
"split"; ``train.serve_step`` gathers them). The cache is this rank's
shard of it (``sharding.state.shard_cache`` / ``init_cache_sharded``:
each leaf ``shard(leaf, cache_spec_for_leaf(...))``, beside its layout,
worked out once for the cache: "split", "specs", each KV layer's
"slots"); the split goes on a local copy of the ``ShardCtx``, so the
caller's ``constrain`` is left as it is. Attention reads and writes its
KV shard (``attention.attention_forward_sharded``: prefill keeps its
positions, decode is flash-decoding over the ranks that hold them);
Mamba and RWKV gather their state's "model" shards at use, run
replicated over "model" as their weights do, and keep their slice of
the new state (one state gather a layer a step). The logits take the
gathered unembedding, so an argmax sees the whole vocab.

Under the "fsdp" layout the JAX package serves through the same steps
(``make_constrain(mesh, layout="fsdp")``: the activations' batch over
("pod", "data", "model")), with the cache placed by ``decode_specs``,
i.e. by the same ``cache_spec_for_leaf`` (rows over ("pod", "data"),
positions or the state's inner dim over "model"). So the port splits the
rows over every axis outside the mixers (embedding, norms, MLP, MoE,
unembedding; every weight gathered at use), and each mixer runs on the
cache's rows, the split without "model": its input rows gathered over
"model" before it, this rank's rows kept after it (``_regrouped``), and
the mixer is the "tp" layout's with every head. Where the split does not
reach "model" (B = 1, or B not divisible by every axis), the two splits
are one and nothing is regrouped.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.attention import (attn_init, attention_forward,
                                          attention_forward_sharded,
                                          make_kv_cache)
from repro_torch.models.layers import (DeferredDraws, Draw, MetaGenerator,
                                       dense_init, embed_init, mlp_forward,
                                       mlp_forward_tp, mlp_init, rms_norm)
from repro_torch.models.mamba import (make_mamba_state, mamba_forward,
                                      mamba_init)
from repro_torch.models.moe import moe_forward, moe_init
from repro_torch.models.rwkv import (RWKVState, channel_mix_init,
                                     make_rwkv_state, rwkv_channel_mix,
                                     rwkv_init, rwkv_time_mix)
from repro_torch.sharding.collectives import shard
from repro_torch.sharding.specs import with_sharding
from repro_torch.sharding.state import gather_state, scatter_state
from repro_torch.utils.tree import Stacked, leaves, map_tree

Tensor = torch.Tensor


def _param(t: Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Named(nn.Module):
    """Parameters by the JAX package's key: ``p["attn"]["wq"]``."""

    def __getitem__(self, key: str):
        return getattr(self, key)


class DecoderLayer(_Named):
    """One layer's parameters; its ``spec`` says which mixer and MLP."""

    def __init__(self, spec: LayerSpec, tree: dict):
        super().__init__()
        self.spec = spec
        for key, val in tree.items():
            if isinstance(val, dict):
                setattr(self, key, nn.ParameterDict(
                    {k: _param(v) for k, v in val.items()}))
            else:
                setattr(self, key, _param(val))


class Decoder(_Named):
    """The whole stack's parameters; ``Decoder(...)(tokens=...)`` runs
    ``forward``."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers for "
                             f"{cfg.name}'s {cfg.n_layers}")
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.final_norm = _param(tree["final_norm"])
        self.unembed = _param(tree["unembed"])
        self.layers = nn.ModuleList(
            DecoderLayer(cfg.layer_spec(i), t)
            for i, t in enumerate(tree["layers"]))

    def forward(self, **kwargs):
        return forward(self, self.cfg, **kwargs)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ArchConfig,
                spec: LayerSpec) -> dict:
    dtype, dev = cfg.dtype, gen.device
    p: dict = {
        "norm1": torch.zeros((cfg.d_model,), dtype=torch.float32,
                             device=dev),
        "norm2": torch.zeros((cfg.d_model,), dtype=torch.float32,
                             device=dev),
    }
    if spec.mixer in ("full", "swa"):
        p["attn"] = attn_init(gen, cfg.d_model, cfg.n_heads,
                              cfg.n_kv_heads, cfg.head_dim, dtype)
    elif spec.mixer == "mamba":
        p["mamba"] = mamba_init(gen, cfg, dtype)
    elif spec.mixer == "rwkv":
        p["rwkv"] = rwkv_init(gen, cfg, dtype)
    else:
        raise ValueError(spec.mixer)

    if spec.mixer == "rwkv":
        p["cmix"] = channel_mix_init(gen, cfg, dtype)
    elif spec.moe:
        p["moe"] = moe_init(gen, cfg.d_model, cfg.n_experts, cfg.moe_ff,
                            cfg.mlp_type, dtype)
        if cfg.dense_residual_ff:
            p["dense_res"] = mlp_init(gen, cfg.d_model,
                                      cfg.dense_residual_ff, cfg.mlp_type,
                                      dtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)
    return p


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> Decoder:
    """Random parameters drawn from ``generator`` (default: one seeded 0)
    on ``device`` (default: the CUDA card; ``"cpu"`` on the CPU). On
    ``"meta"`` it gives the shapes and dtypes alone."""
    from repro_torch.api import resolve_device
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = MetaGenerator() if dev.type == "meta" \
            else torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"a generator on {gen.device} cannot draw the "
                         f"parameters on {dev}")
    return Decoder(cfg, _init_tree(gen, cfg))


def _init_tree(gen, cfg: ArchConfig) -> dict:
    """Every leaf drawn from ``gen`` in the one order both draws keep."""
    return {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=gen.device),
        "unembed": dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                              cfg.dtype),
        "layers": [_layer_init(gen, cfg, cfg.layer_spec(i))
                   for i in range(cfg.n_layers)],
    }


def init_params_sharded(cfg: ArchConfig, generator: torch.Generator,
                        constrain) -> dict:
    """This rank's shards of the ``param_tree`` that ``init_params(cfg,
    generator)`` draws, bitwise, drawn one full leaf at a time on the
    generator's device: the same leaves in the same order with the same
    generator calls, each leaf cut to this rank's shard
    (``collectives.shard`` by ``constrain.sharding``'s specs) and freed
    before the next is drawn. The peak is this rank's shards plus the
    largest leaf (its f32 draw and its cast). Every rank draws every leaf:
    a draw by spec that skips the other ranks' values would change them."""
    sh = constrain.sharding
    lazy = DeferredDraws(generator.device)
    raw = _init_tree(lazy, cfg)
    tree = {k: raw[k] for k in ("embed", "final_norm", "unembed")}
    tree.update(_jax_layout(cfg, raw["layers"]))
    specs = sh.param_specs(cfg)
    seen = []

    def note(t, spec):
        if isinstance(t, Draw):
            t.spec = spec
            seen.append(t)
    map_tree(note, tree, specs)
    if len(seen) != len(lazy.draws):
        raise RuntimeError(f"{len(lazy.draws)} draws, {len(seen)} in the "
                           f"tree")
    for d in lazy.draws:            # the initialisers' order
        d.value = shard(d.make(generator), d.spec, sh.mesh)
    return map_tree(lambda t, spec: t.value if isinstance(t, Draw)
                    else shard(t, spec, sh.mesh), tree, specs)


def param_tree(params: Decoder) -> dict:
    """The JAX package's parameter tree over a ``Decoder``'s tensors
    (detached, sharing their storage): "embed", "final_norm", "unembed",
    "segments" {"l{i}": the period position's layers, each leaf a
    ``Stacked`` of its R per-layer tensors} and "tail" [per-layer
    dicts]."""
    cfg = params.cfg

    def layer(m: nn.Module) -> dict:
        t = {k: v.detach() for k, v in m.named_parameters(recurse=False)}
        t.update({k: {n: w.detach() for n, w in c.items()}
                  for k, c in m.named_children()})
        return t

    tree = {"embed": params.embed.detach(),
            "final_norm": params.final_norm.detach(),
            "unembed": params.unembed.detach()}
    tree.update(_jax_layout(cfg, [layer(m) for m in params.layers]))
    return tree


def _jax_layout(cfg: ArchConfig, layers: list) -> dict:
    """Per-layer trees (parameters or states, in stack order) in the JAX
    package's layout: "segments" {"l{i}": period position i's layers, each
    leaf a ``Stacked``} and "tail" (the partial period's layers)."""
    tree = {}
    if cfg.n_repeats:
        tree["segments"] = {
            f"l{i}": map_tree(lambda *ts: Stacked(ts), *[
                layers[r * cfg.period + i] for r in range(cfg.n_repeats)])
            for i in range(cfg.period)}
    if cfg.n_tail:
        tree["tail"] = layers[cfg.n_repeats * cfg.period:]
    return tree


def layer_params(params, cfg: ArchConfig) -> list:
    """Each layer's parameters in stack order: a ``Decoder``'s modules,
    or the per-layer views of a ``param_tree`` (repeat r of period
    position i for layer r * period + i, then the tail); of a
    ``cache_tree`` too."""
    if isinstance(params, Decoder):
        return list(params.layers)
    out = []
    for j in range(cfg.n_layers):
        r, i = divmod(j, cfg.period)
        if r < cfg.n_repeats:
            out.append(map_tree(lambda s, r=r: s[r],
                                params["segments"][f"l{i}"], stacked=True))
        else:
            out.append(params["tail"][j - cfg.n_repeats * cfg.period])
    return out


# ---------------------------------------------------------------------------
# per-layer state (KV cache / SSM state)
# ---------------------------------------------------------------------------

def _layer_state(cfg: ArchConfig, spec: LayerSpec, batch: int, seq_len: int,
                 dtype, device):
    if spec.mixer in ("full", "swa"):
        return make_kv_cache(cfg, spec.mixer, batch, seq_len, dtype, device)
    if spec.mixer == "mamba":
        return make_mamba_state(cfg, batch, dtype, device)
    if spec.mixer == "rwkv":
        return make_rwkv_state(cfg, batch, dtype, device)
    raise ValueError(spec.mixer)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=None, *,
               device=None) -> dict:
    """Empty caches for ``seq_len`` positions: {"pos": 0, "layers": [one
    state per layer, in stack order]} on ``device`` (default: the CUDA
    card)."""
    from repro_torch.api import resolve_device
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    return {"pos": 0,
            "layers": [_layer_state(cfg, cfg.layer_spec(i), batch, seq_len,
                                    dtype, dev)
                       for i in range(cfg.n_layers)]}


def cache_tree(cache: dict, cfg: ArchConfig) -> dict:
    """A cache in the JAX package's layout (its ``init_cache``): "pos" an
    int32 scalar, the layers' states under "segments" (a ``Stacked`` per
    leaf) and "tail". The one mapping between the two layouts, for the
    specs (``launch.specs.cache_sds``) and for checkpoints."""
    first = next(t for st in cache["layers"] for t in st)
    pos = cache["pos"]
    tree = {"pos": (pos if isinstance(pos, Tensor) else torch.tensor(
        pos, dtype=torch.int32, device=first.device))}
    tree.update(_jax_layout(cfg, list(cache["layers"])))
    return tree


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _weights(p, name: str, constrain, pspec):
    """A layer's sub-dict of weights: as it is on one device, gathered at
    use when sharded."""
    sh = getattr(constrain, "sharding", None)
    if sh is None:
        return p[name]
    return sh.gather_all(p[name], pspec[name])


def _attention(p, h: Tensor, cfg: ArchConfig, mixer: str, constrain,
               pspec, kv=None, **kw):
    """``attention_forward``, head-parallel over "model" under the "tp"
    layout when the query and the kv heads both divide it (kv head j
    serves query heads j*g..(j+1)*g-1, so contiguous blocks of both stay
    together): the input passes ``copy_to``, the row-parallel ``wo``
    output ``reduce_from``. Else the weights are gathered. ``kv``: the
    ``KVSlots`` of a sharded cache's layer, which
    ``attention_forward_sharded`` reads and writes."""
    sh = getattr(constrain, "sharding", None)
    m = sh.model if sh is not None else 1
    specs = pspec["attn"] if pspec is not None else None
    heads = (sh is not None and sh.layout == "tp"
             and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
             and all(specs[k][1:2] == ("model",) for k in ("wq", "wk", "wv"))
             and specs["wo"][:1] == ("model",))
    if kv is not None:
        keep = ("model",) if heads else ()
        w = sh.gather_all(p["attn"], specs, keep=keep)
        xin = sh.copy_to(h, keep) if heads else h
        out, st = attention_forward_sharded(
            w, xin, cfg, mixer, sh, heads=m if heads else 1, slots=kv,
            **kw)
        return (sh.reduce_from(out, keep) if heads else out), st
    if heads:
        w = sh.gather_all(p["attn"], specs, keep=("model",))
        local = dataclasses.replace(cfg, n_heads=cfg.n_heads // m,
                                    n_kv_heads=cfg.n_kv_heads // m)
        out, st = attention_forward(w, sh.copy_to(h, ("model",)), local,
                                    mixer, **kw)
        return sh.reduce_from(out, ("model",)), st
    return attention_forward(_weights(p, "attn", constrain, pspec), h, cfg,
                             mixer, **kw)


def _mix(p, x: Tensor, cfg: ArchConfig, spec: LayerSpec, *,
         positions: Tensor, state, cache_pos: int, q_chunk: int,
         constrain=None, pspec=None, kv=None):
    """The layer's first half, norm1 and the mixer: (x + out, the
    mixer's new state parts). ``pspec``: the layer's specs, sharded;
    ``kv``: its KV shard's ``KVSlots`` in a sharded cache."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer in ("full", "swa"):
        out, new_mix_state = _attention(
            p, h, cfg, spec.mixer, constrain, pspec, kv=kv,
            positions=positions, cache=state, cache_pos=cache_pos,
            q_chunk=q_chunk)
        mixed = (new_mix_state, None, None)
    elif spec.mixer == "mamba":
        out, new_mix_state = mamba_forward(
            _weights(p, "mamba", constrain, pspec), h, cfg, state=state)
        mixed = (new_mix_state, None, None)
    elif spec.mixer == "rwkv":
        out, new_x_tm, new_wkv = rwkv_time_mix(
            _weights(p, "rwkv", constrain, pspec), h, cfg, state=state)
        mixed = (state, new_x_tm, new_wkv)
    else:
        raise ValueError(spec.mixer)
    return x + out, mixed


def _ffn(p, x: Tensor, cfg: ArchConfig, spec: LayerSpec, *, state, mixed,
         constrain=None, pspec=None):
    """The layer's second half, norm2 and the MLP / MoE / channel mix:
    (x + out, the layer's new state, aux)."""
    new_mix_state, new_x_tm, new_wkv = mixed
    sh = getattr(constrain, "sharding", None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if spec.mixer == "rwkv":
        out, new_x_cm = rwkv_channel_mix(
            _weights(p, "cmix", constrain, pspec), h,
            x_prev=(state.x_cm if state is not None else None))
        if state is not None:
            new_mix_state = RWKVState(x_tm=new_x_tm, x_cm=new_x_cm,
                                      wkv=new_wkv)
    elif spec.moe:
        out, aux = moe_forward(p["moe"], h, n_experts=cfg.n_experts,
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               mlp_type=cfg.mlp_type, impl=cfg.moe_impl,
                               constrain=constrain,
                               specs=pspec["moe"] if pspec else None)
        if cfg.dense_residual_ff:
            out = out + mlp_forward(
                _weights(p, "dense_res", constrain, pspec), h, cfg.mlp_type)
    elif cfg.tp_mlp and sh is not None and sh.layout == "tp":
        out = mlp_forward_tp(p["mlp"], h, cfg.mlp_type, sh, pspec["mlp"])
    else:
        out = mlp_forward(_weights(p, "mlp", constrain, pspec), h,
                          cfg.mlp_type)
    return x + out, new_mix_state, aux


def _apply_layer(p, x: Tensor, cfg: ArchConfig, spec: LayerSpec, *,
                 positions: Tensor, state, cache_pos: int, q_chunk: int,
                 constrain=None, pspec=None, kv=None):
    """One decoder layer. Returns (x, new_state, aux)."""
    x, mixed = _mix(p, x, cfg, spec, positions=positions, state=state,
                    cache_pos=cache_pos, q_chunk=q_chunk,
                    constrain=constrain, pspec=pspec, kv=kv)
    return _ffn(p, x, cfg, spec, state=state, mixed=mixed,
                constrain=constrain, pspec=pspec)


def _regrouped(p, x: Tensor, cfg: ArchConfig, spec: LayerSpec,
               mix_constrain, *, positions: Tensor, state, constrain,
               **kw):
    """One sharded layer under "fsdp" where the rows split over "model"
    and the cache's rows do not: the mixer on the cache's rows (this
    rank's rows gathered over "model", ``mix_constrain``'s split), the
    second half on this rank's rows. RWKV's channel-mix shift state is
    cut to this rank's rows for the channel mix and its new value
    gathered back. Returns (x, new_state, aux)."""
    sh = constrain.sharding
    comm = sh.comm(("model",))

    def mine(t: Tensor) -> Tensor:
        n = t.shape[0] // sh.model
        return t.narrow(0, sh.index(("model",)) * n, n)
    xc = comm.all_gather(x, dim=0)
    xc, mixed = _mix(p, xc, cfg, spec, state=state,
                     positions=positions[:1].expand(xc.shape[0], -1),
                     constrain=mix_constrain, **kw)
    if spec.mixer == "rwkv":
        state = state._replace(x_cm=mine(state.x_cm))
    x, nst, aux = _ffn(p, mine(xc), cfg, spec, state=state, mixed=mixed,
                       constrain=constrain, pspec=kw["pspec"])
    if spec.mixer == "rwkv":
        nst = nst._replace(x_cm=comm.all_gather(nst.x_cm, dim=0))
    return x, nst, aux


def _save_weight_matmuls(ctx, op, *args, **kwargs):
    """"dots": keep the outputs of the weight matmuls (``aten.mm``; 3-D
    activations reach it folded to 2-D) and recompute the rest, the
    batched products of attention and of the experts (``aten.bmm``)
    among it, as ``dots_with_no_batch_dims_saveable`` does."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_layer(p, x: Tensor, cfg: ArchConfig, spec: LayerSpec, *,
                 positions: Tensor, q_chunk: int, mode: str,
                 constrain=None, pspec=None):
    """One train-mode layer under ``mode`` (the JAX package's
    ``_remat_wrap``): "none" keeps every intermediate; "full" keeps only
    the layer's input and re-runs the layer in the backward pass; "dots"
    keeps the weight matmuls' outputs besides; "boundaries" checkpoints
    the mixer half and the MLP half apart, so the residual stream after
    the mixer (x + mixer_out) is kept and neither half is re-run for the
    other. Remat changes no value. Returns (x, None, aux)."""
    kw = dict(positions=positions, state=None, cache_pos=0,
              q_chunk=q_chunk, constrain=constrain, pspec=pspec)
    if mode == "none":
        return _apply_layer(p, x, cfg, spec, **kw)
    if mode == "boundaries":
        x, mixed = ckpt.checkpoint(
            lambda x: _mix(p, x, cfg, spec, **kw), x, use_reentrant=False)
        return ckpt.checkpoint(
            lambda x: _ffn(p, x, cfg, spec, state=None, mixed=mixed,
                           constrain=constrain, pspec=pspec), x,
            use_reentrant=False)
    extra = {}
    if mode == "dots":
        extra["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_weight_matmuls)
    elif mode != "full":
        raise ValueError(f"remat {mode!r}")
    return ckpt.checkpoint(lambda x: _apply_layer(p, x, cfg, spec, **kw), x,
                           use_reentrant=False, **extra)


def _records_graph(p, x: Tensor) -> bool:
    """Whether a train-mode layer records an autograd graph."""
    if not torch.is_grad_enabled():
        return False
    ts = p.parameters() if isinstance(p, nn.Module) else leaves(p)
    return x.requires_grad or any(t.requires_grad for t in ts)

def _embed(params, tokens: Tensor, cfg: ArchConfig, constrain,
           specs) -> Tensor:
    """The token embedding. Sharded, with the vocab over "model" under the
    "tp" layout, each "model" rank looks up the tokens of its vocab range
    (zero rows for the others; dmodel gathered over "data" with fsdp) and
    the rows are summed over "model": one term is non-zero, so the sum is
    the lookup exactly. Else the table is gathered at use. (The JAX
    package leaves this gather to GSPMD, which refuses it under jax 0.9.0
    on a mesh with Explicit axes: ROADMAP C.3.)"""
    tokens = tokens.long()
    sh = getattr(constrain, "sharding", None)
    if sh is None:
        return params["embed"][tokens]
    spec = specs["embed"]
    if sh.layout == "tp" and spec[:1] == ("model",):
        table = sh.gather(params["embed"], spec, keep=("model",))
        n = table.shape[0]
        ids = tokens - sh.index(("model",)) * n
        inside = (ids >= 0) & (ids < n)
        rows = table[ids.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
        return sh.reduce_from(rows, ("model",))
    return sh.gather(params["embed"], spec)[tokens]


def unembed_weight(params, cfg: ArchConfig, constrain=None) -> Tensor:
    """The (d_model, padded vocab) unembedding; sharded, gathered at use
    (the logits and the loss then run replicated over "model")."""
    sh = getattr(constrain, "sharding", None)
    if sh is None:
        return params["unembed"]
    return sh.gather(params["unembed"], sh.param_specs(cfg)["unembed"])


def forward(params, cfg: ArchConfig, *,
            tokens: Optional[Tensor] = None,
            embeds: Optional[Tensor] = None,
            vision_embeds: Optional[Tensor] = None,
            cache: Optional[dict] = None,
            q_chunk: int = 2048,
            return_hidden: bool = False,
            constrain=None
            ) -> Tuple[Tensor, Optional[dict], Tensor]:
    """Returns (logits_or_hidden, new_cache_or_None, aux_loss).

    ``params`` is a ``Decoder`` or its ``param_tree`` (this rank's shards
    of it when ``constrain`` carries a sharded layout). Sharded with a
    cache (its shard, see the module docstring), the inputs are the global
    batch and the outputs this rank's rows of it.
    return_hidden skips the unembedding and returns the final-normed
    hidden states (B, S, d_model), the features a head pools (and the
    fused loss takes).
    """
    sh = getattr(constrain, "sharding", None)
    specs = sh.param_specs(cfg) if sh is not None else None
    sharded = sh is not None and cache is not None
    if sharded:
        if "slots" not in cache:
            raise ValueError("a sharded forward takes this rank's shard of "
                             "a cache (sharding.state.shard_cache or "
                             "init_cache_sharded)")
        src = embeds if embeds is not None else tokens
        if src.shape[0] != cache["batch"]:
            raise ValueError(f"a batch of {src.shape[0]} for a cache of "
                             f"{cache['batch']} rows: the inputs are the "
                             f"global batch")
        # This call's batch split, on a local context: the caller's
        # constrain keeps its own.
        sh = sh.with_split(cache["split"])
        constrain = with_sharding(constrain, sh)
        tokens, embeds, vision_embeds = (
            None if t is None else sh.split_slice(t)
            for t in (tokens, embeds, vision_embeds))
        # The mixers run on the cache's rows: the split without "model"
        # (under "tp" the split has no "model": the same rows).
        mix_sh = sh.with_split(ax for ax in sh.split if ax != "model")
        mix_constrain = with_sharding(constrain, mix_sh)
        regroup = "model" in sh.split and sh.model > 1
        if not regroup:     # both splits hold the same rows
            constrain = mix_constrain
    if embeds is not None:                       # audio frontend stub
        x = embeds.to(cfg.dtype)
    else:
        x = _embed(params, tokens, cfg, constrain, specs)
    if vision_embeds is not None:                # vision frontend stub
        x = torch.cat([vision_embeds.to(cfg.dtype), x], dim=1)
    b, s, _ = x.shape

    pos0 = cache["pos"] if cache is not None else 0
    positions = (pos0 + torch.arange(s, device=x.device))[None, :] \
        .expand(b, s)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_states = []
    pspecs = (layer_params(specs, cfg) if specs is not None
              else [None] * cfg.n_layers)
    for i, layer in enumerate(layer_params(params, cfg)):
        spec = cfg.layer_spec(i)
        if cache is None and _records_graph(layer, x):
            x, nst, aux = _remat_layer(layer, x, cfg, spec,
                                       positions=positions, q_chunk=q_chunk,
                                       mode=cfg.remat, constrain=constrain,
                                       pspec=pspecs[i])
        else:
            st = cache["layers"][i] if cache is not None else None
            ssm = sharded and spec.mixer in ("mamba", "rwkv")
            if ssm:     # the state's "model" shards gathered at use
                st = gather_state(st, cache["specs"][i], mix_sh)
            kw = dict(positions=positions, state=st, cache_pos=pos0,
                      q_chunk=q_chunk, constrain=constrain, pspec=pspecs[i],
                      kv=cache["slots"][i] if sharded else None)
            if sharded and regroup:
                x, nst, aux = _regrouped(layer, x, cfg, spec, mix_constrain,
                                         **kw)
            else:
                x, nst, aux = _apply_layer(layer, x, cfg, spec, **kw)
            if ssm:     # this rank's slice of the new state
                nst = scatter_state(nst, cache["specs"][i], mix_sh)
        aux_total = aux_total + aux
        new_states.append(nst)
    new_cache = None
    if cache is not None:         # a sharded cache keeps its layout
        new_cache = dict(cache, pos=pos0 + s, layers=new_states)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, new_cache, aux_total
    logits = x @ unembed_weight(params, cfg, constrain)
    if cfg.padded_vocab != cfg.vocab_size:
        # Megatron-style vocab padding: pad columns never win.
        logits[..., cfg.vocab_size:] = -1e30
    return logits, new_cache, aux_total
