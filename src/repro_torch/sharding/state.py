"""A ``TrainState`` and a serving cache laid out on a mesh: every rank's
shards of the parameters, of the optimizer's moments and of the KV caches
and SSM states.

The parameters take ``make_param_specs`` (``ShardCtx.param_specs``);
AdamW's moments the parameters' specs; Adafactor's ``vr`` / ``vc`` the
stacked leaf's spec without the dim they average (``vr``: the last,
``vc``: the one before it), so each rank's factored moments match its
shard of the gradient. The step is replicated.

A cache's leaves take ``cache_spec_for_leaf`` on their full shapes (the
layout ``launch.specs.decode_specs`` states): a rank's cache is, leaf for
leaf, ``shard(full leaf, spec)``, beside its layout, worked out once for
the cache: the full cache's batch and length, the batch split, the specs
and each KV shard's slots (the sharded forward reads its shard's place
from them at every step).
"""
from __future__ import annotations

import math

import torch

from repro_torch.sharding.collectives import (entry_axes, padded, shard,
                                              shard_tree, stacked_leaf_specs,
                                              unshard, unshard_tree)
from repro_torch.sharding.specs import P, cache_spec_for_leaf
from repro_torch.utils.tree import leaves, unflatten


def state_specs(state, cfg, sharding):
    """The spec tree of a ``TrainState`` (same structure, a spec per
    tensor) under ``sharding`` (a ``ShardCtx``)."""
    specs = sharding.param_specs(cfg)
    opt = state.opt_state
    if hasattr(opt, "vr"):
        full = stacked_leaf_specs(specs)
        shapes = [tuple(p.shape) for p in leaves(state.params, stacked=True)]
        vr = [P(*s[:-1]) if len(n) >= 2 else s for s, n in zip(full, shapes)]
        vc = [P(*(tuple(s)[:-2] + tuple(s)[-1:])) if len(n) >= 2 else P()
              for s, n in zip(full, shapes)]
        opt_specs = type(opt)(step=P(),
                              vr=unflatten(opt.vr, vr, stacked=True),
                              vc=unflatten(opt.vc, vc, stacked=True))
    else:
        opt_specs = type(opt)(step=P(), m=specs, v=specs)
    return type(state)(params=specs, opt_state=opt_specs, step=P())


def shard_params(params, cfg, constrain):
    """This rank's shards of full parameters (a ``Decoder`` or its
    ``param_tree``): start the optimizer on them
    (``init_train_state``), and no rank holds full moments."""
    from repro_torch.models.transformer import Decoder, param_tree
    if isinstance(params, Decoder):
        params = param_tree(params)
    sh = constrain.sharding
    return shard_tree(params, sh.param_specs(cfg), sh.mesh)


def shard_train_state(state, cfg, constrain):
    """This rank's shards of a full ``TrainState`` (every rank passes the
    same full state; nothing is communicated)."""
    sh = constrain.sharding
    return shard_tree(state, state_specs(state, cfg, sh), sh.mesh)


def unshard_train_state(state, cfg, constrain, *, ledger=None):
    """The full ``TrainState`` on every rank from its shards (all-gathers:
    every rank calls this)."""
    sh = constrain.sharding
    return unshard_tree(state, state_specs(state, cfg, sh), sh.mesh,
                        ledger=ledger)


# ---------------------------------------------------------------------------
# serving caches
# ---------------------------------------------------------------------------

def _seq_len(cache: dict) -> int:
    """A full cache's length: its longest KV buffer (an SWA layer's ring
    is shorter; with every layer a ring, any length past the window lays
    them out alike). 0 with no KV layer."""
    return max((st.k.shape[1] for st in cache["layers"]
                if hasattr(st, "k")), default=0)


def cache_specs(cfg, batch: int, seq_len: int, mesh) -> list:
    """Each layer's state specs for a cache of ``batch`` x ``seq_len`` on
    ``mesh``: ``cache_spec_for_leaf`` on each field's full shape, as the
    state's named tuple."""
    from repro_torch.models.transformer import init_cache
    full = init_cache(cfg, batch, seq_len, cfg.dtype, device="meta")
    return [type(st)(*(cache_spec_for_leaf((f,), tuple(t.shape), mesh)
                       for f, t in zip(st._fields, st)))
            for st in full["layers"]]


def _layout(cfg, batch: int, seq_len: int, sh) -> dict:
    """A sharded cache's layout, worked out once for the cache and read
    by every step: "batch" and "seq_len" (the full cache's), "split" (the
    batch axes its rows split on), "specs" (``cache_specs``) and "slots"
    (each KV layer's ``attention.KVSlots``; None for a Mamba / RWKV
    layer)."""
    from repro_torch.models.attention import kv_buffer_len, kv_slots
    specs = cache_specs(cfg, batch, seq_len, sh.mesh)
    slots = [kv_slots(sp.k, kv_buffer_len(cfg, cfg.layer_spec(i).mixer,
                                          seq_len), sh)
             if hasattr(sp, "k") else None for i, sp in enumerate(specs)]
    return {"batch": batch, "seq_len": seq_len,
            "split": sh.batch_split(batch, needs_two=True),
            "specs": specs, "slots": slots}


def shard_cache(cache: dict, cfg, constrain) -> dict:
    """This rank's shard of a full cache (every rank passes the same; no
    communication): each leaf ``shard(leaf, cache_spec_for_leaf(...))``,
    with its layout (``_layout``)."""
    sh = constrain.sharding
    out = _layout(cfg, cache["layers"][0][0].shape[0], _seq_len(cache), sh)
    out.update(pos=cache["pos"], layers=[
        type(st)(*(shard(t, s, sh.mesh) for t, s in zip(st, sp)))
        for st, sp in zip(cache["layers"], out["specs"])])
    return out


def init_cache_sharded(cfg, batch: int, seq_len: int, constrain,
                       dtype=None, *, device=None) -> dict:
    """``shard_cache(init_cache(...))`` without the full cache: this rank's
    zero shards alone, on ``device`` (default: the CUDA card)."""
    from repro_torch.api import resolve_device
    from repro_torch.models.transformer import init_cache
    sh = constrain.sharding
    dev = resolve_device(device)
    full = init_cache(cfg, batch, seq_len, dtype, device="meta")
    out = _layout(cfg, batch, seq_len, sh)

    def zeros(t, spec):
        shape = [n // math.prod(sh.mesh.shape[ax] for ax in entry_axes(e))
                 for n, e in zip(t.shape, padded(spec, t.dim()))]
        return torch.zeros(shape, dtype=t.dtype, device=dev)
    out.update(pos=0, layers=[
        type(st)(*(zeros(t, s) for t, s in zip(st, sp)))
        for st, sp in zip(full["layers"], out["specs"])])
    return out


def unshard_cache(cache: dict, cfg, constrain) -> dict:
    """The full cache on every rank from its shards (all-gathers: every
    rank calls this)."""
    sh = constrain.sharding
    return {"pos": cache["pos"],
            "layers": [type(st)(*(unshard(t, s, sh.mesh, ledger=sh.ledger)
                                  for t, s in zip(st, sp)))
                       for st, sp in zip(cache["layers"], cache["specs"])]}


def _rows_free(spec) -> P:
    """``spec`` with its batch (first) entry replicated."""
    return P(None, *tuple(spec)[1:])


def gather_state(state, specs, sh):
    """A Mamba / RWKV state's shard -> the whole state of this rank's
    rows: each field gathered over its non-batch axes ("model"), and, when
    the state's rows are not split as the batch is, cut to the batch's
    rows."""
    def one(t, spec):
        t = unshard(t, _rows_free(spec), sh.mesh, ledger=sh.ledger)
        rows = entry_axes(padded(spec, 1)[0])
        return t if rows else sh.split_slice(t)
    return type(state)(*(one(t, s) for t, s in zip(state, specs)))


def scatter_state(state, specs, sh):
    """The inverse of ``gather_state`` on the new state: its rows gathered
    where the state's rows are not split, then this rank's slice of the
    non-batch axes (no communication for that cut)."""
    def one(t, spec):
        rows = entry_axes(padded(spec, 1)[0])
        if not rows:
            t = sh.gather_split(t)
        return shard(t, _rows_free(spec), sh.mesh)
    return type(state)(*(one(t, s) for t, s in zip(state, specs)))
