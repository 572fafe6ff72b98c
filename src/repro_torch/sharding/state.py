"""A ``TrainState`` laid out on a mesh: every rank's shards of the
parameters and of the optimizer's moments.

The parameters take ``make_param_specs`` (``ShardCtx.param_specs``);
AdamW's moments the parameters' specs; Adafactor's ``vr`` / ``vc`` the
stacked leaf's spec without the dim they average (``vr``: the last,
``vc``: the one before it), so each rank's factored moments match its
shard of the gradient. The step is replicated.
"""
from __future__ import annotations

from repro_torch.sharding.collectives import (shard_tree, stacked_leaf_specs,
                                              unshard_tree)
from repro_torch.sharding.specs import P
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
