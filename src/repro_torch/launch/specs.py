"""Shapes without storage and the train state's shardings (the train-state
part of the JAX package's ``repro.launch.specs``).

``params_sds`` gives an arch's ``param_tree`` as meta tensors (the JAX
package's ``eval_shape``); the ``*_shardings`` functions give the
``NamedSharding`` (mesh + ``PartitionSpec``) of every leaf, derived from
the sharding rules; ``batch_sds_and_shardings`` the batch's. The
dry-run's ``input_specs`` / ``decode_specs`` belong to the serving slice
and the XLA-only tools.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.specs import (NamedSharding, P, batch_axes,
                                        batch_prefix, make_param_specs,
                                        map_specs, map_with_names,
                                        spec_for_param)


@functools.lru_cache(maxsize=32)
def params_sds(cfg: ArchConfig) -> dict:
    """``cfg``'s ``param_tree`` as meta tensors (shapes and dtypes; one
    tree per config, shared: treat it as read-only)."""
    from repro_torch.models.transformer import init_params, param_tree
    return param_tree(init_params(cfg, device="meta"))


def param_shardings(cfg: ArchConfig, mesh, *, fsdp: bool = True,
                    layout: str = "tp"):
    """Each parameter's sharding (a ``Stacked`` leaf's tensors each with
    the per-layer one); moe_layout = cfg.moe_impl."""
    specs = make_param_specs(params_sds(cfg), mesh, fsdp=fsdp, layout=layout,
                             moe_layout=cfg.moe_impl)
    return map_specs(lambda s: NamedSharding(mesh, s), specs)


def _drop_axis(spec, k: int):
    """Spec for a factored-moment leaf (last k axes removed)."""
    t = tuple(spec)
    return P(*t[:-k]) if len(t) >= k else P(*t)


def _stacked_specs(cfg: ArchConfig, mesh, fsdp: bool, layout: str):
    """(shapes, specs) of the JAX layout: a stacked leaf's whole (R, ...)
    shape and spec."""
    psds = params_sds(cfg)
    shapes = map_with_names(lambda names, leaf: tuple(leaf.shape), psds)
    specs = map_with_names(lambda names, leaf: spec_for_param(
        names, tuple(leaf.shape), mesh, fsdp=fsdp, layout=layout,
        moe_layout=cfg.moe_impl), psds)
    return shapes, specs


def _zip_leaves(fn, specs, shapes):
    """``fn(spec, shape)`` over two trees of the JAX layout."""
    if isinstance(specs, dict):
        return {k: _zip_leaves(fn, specs[k], shapes[k]) for k in specs}
    if isinstance(specs, list):
        return [_zip_leaves(fn, a, b) for a, b in zip(specs, shapes)]
    return fn(specs, shapes)


def opt_state_shardings(cfg: ArchConfig, mesh, *, fsdp: bool = True,
                        layout: str = "tp"):
    """The optimizer state's shardings in the JAX layout: a stacked
    leaf's entry is the whole (R, ...) leaf's (the port's AdamW moments
    hold that leaf's layers apart; its Adafactor moments are whole).
    Under layout="fsdp" AdamW's and Adafactor's moments add a "data" dim
    (ZeRO-2, the JAX package's ``densify``); the port's sharded step
    keeps its moments in the parameters' layout (see
    ``optim.adafactor``)."""
    from repro_torch.optim.adafactor import AdafactorState
    from repro_torch.optim.adamw import AdamWState
    shapes, specs = _stacked_specs(cfg, mesh, fsdp, layout)
    if layout == "fsdp":
        def densify(s, shape):
            t = list(s) + [None] * (len(shape) - len(tuple(s)))
            if "data" not in t:
                for i, ax in enumerate(t):
                    if ax is None and shape[i] % mesh.shape["data"] == 0 \
                            and shape[i] > 1:
                        t[i] = "data"
                        break
            return P(*t)

        specs = _zip_leaves(densify, specs, shapes)
    rep = NamedSharding(mesh, P())

    def named(s):
        return NamedSharding(mesh, s)
    if cfg.optimizer == "adafactor":
        vr = _zip_leaves(lambda s, shape: named(
            _drop_axis(s, 1) if len(shape) >= 2 else s), specs, shapes)
        vc = _zip_leaves(lambda s, shape: named(
            P(*(tuple(s)[:-2] + tuple(s)[-1:]))
            if len(shape) >= 2 and len(tuple(s)) >= 2 else P()),
            specs, shapes)
        return AdafactorState(step=rep, vr=vr, vc=vc)
    m = _zip_leaves(lambda s, shape: named(s), specs, shapes)
    return AdamWState(step=rep, m=m, v=m)


def train_state_shardings(cfg: ArchConfig, mesh, *, fsdp: bool = True,
                          layout: str = "tp"):
    from repro_torch.train.train_step import TrainState
    return TrainState(
        params=param_shardings(cfg, mesh, fsdp=fsdp, layout=layout),
        opt_state=opt_state_shardings(cfg, mesh, fsdp=fsdp, layout=layout),
        step=NamedSharding(mesh, P()))


def batch_sds_and_shardings(cfg: ArchConfig, mesh, batch: int,
                            seq_len: int, layout: str = "tp"
                            ) -> Tuple[dict, dict]:
    """(meta tensors, shardings) of a global batch: the batch axes cut to
    the longest prefix whose size divides ``batch``."""
    baxes = batch_prefix(mesh, batch_axes(mesh, layout), batch) or None
    bspec = NamedSharding(mesh, P(baxes))
    b3 = NamedSharding(mesh, P(baxes, None, None))

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    sds: Dict[str, Any] = {}
    shd: Dict[str, Any] = {}
    if cfg.frontend == "audio":
        sds["embeds"] = meta((batch, seq_len, cfg.d_model), cfg.dtype)
        sds["labels"] = meta((batch, seq_len), torch.int32)
        shd["embeds"], shd["labels"] = b3, bspec
    elif cfg.frontend == "vision":
        nv = cfg.n_frontend_tokens
        sds["tokens"] = meta((batch, seq_len - nv), torch.int32)
        sds["labels"] = meta((batch, seq_len - nv), torch.int32)
        sds["vision_embeds"] = meta((batch, nv, cfg.d_model), cfg.dtype)
        shd["tokens"], shd["labels"], shd["vision_embeds"] = bspec, bspec, b3
    else:
        sds["tokens"] = meta((batch, seq_len), torch.int32)
        sds["labels"] = meta((batch, seq_len), torch.int32)
        shd["tokens"], shd["labels"] = bspec, bspec
    return sds, shd

