"""Shapes without storage and their shardings for every (arch x shape x
step) — the JAX package's ``repro.launch.specs``.

``params_sds`` gives an arch's ``param_tree`` as meta tensors (the JAX
package's ``eval_shape``), ``cache_sds`` its cache in the JAX layout
(``models.transformer.cache_tree``), ``opt_state_sds`` /
``train_state_sds`` the optimizer's and the train step's state; the
``*_shardings`` functions give the ``NamedSharding`` (mesh +
``PartitionSpec``) of every leaf, derived from the sharding rules;
``batch_sds_and_shardings`` the batch's, ``decode_specs`` a decode
step's and ``input_specs`` every input of a ``configs.base.SHAPES``
cell. A stacked leaf is a ``Stacked`` of per-layer meta tensors, its
sharding a ``Stacked`` of per-layer ones (the stacked spec with its
leading entry dropped), as in ``make_param_specs``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.sharding.specs import (NamedSharding, P, batch_axes,
                                        batch_prefix, make_cache_shardings,
                                        make_param_specs, map_specs,
                                        map_with_names, spec_for_param)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@functools.lru_cache(maxsize=32)
def params_sds(cfg: ArchConfig) -> dict:
    """``cfg``'s ``param_tree`` as meta tensors (shapes and dtypes; one
    tree per config, shared: treat it as read-only)."""
    from repro_torch.models.transformer import init_params, param_tree
    return param_tree(init_params(cfg, device="meta"))


def cache_sds(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """The cache of ``batch`` x ``seq_len`` in the JAX layout, as meta
    tensors in ``cfg.dtype`` ("pos" an int32 scalar)."""
    from repro_torch.models.transformer import cache_tree, init_cache
    return cache_tree(init_cache(cfg, batch, seq_len, dtype=cfg.dtype,
                                 device="meta"), cfg)


def opt_state_sds(cfg: ArchConfig):
    """The optimizer state ``cfg.optimizer`` starts from, as meta tensors
    (AdamW's moments per layer, Adafactor's whole stacked leaves)."""
    if cfg.optimizer == "adafactor":
        from repro_torch.optim import adafactor
        return adafactor.init(params_sds(cfg))
    from repro_torch.optim import adamw
    return adamw.init(params_sds(cfg))


def train_state_sds(cfg: ArchConfig):
    from repro_torch.train.train_step import TrainState
    return TrainState(params=params_sds(cfg), opt_state=opt_state_sds(cfg),
                      step=_meta((), torch.int32))


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

    sds: Dict[str, Any] = {}
    shd: Dict[str, Any] = {}
    if cfg.frontend == "audio":
        sds["embeds"] = _meta((batch, seq_len, cfg.d_model), cfg.dtype)
        sds["labels"] = _meta((batch, seq_len), torch.int32)
        shd["embeds"], shd["labels"] = b3, bspec
    elif cfg.frontend == "vision":
        nv = cfg.n_frontend_tokens
        sds["tokens"] = _meta((batch, seq_len - nv), torch.int32)
        sds["labels"] = _meta((batch, seq_len - nv), torch.int32)
        sds["vision_embeds"] = _meta((batch, nv, cfg.d_model), cfg.dtype)
        shd["tokens"], shd["labels"], shd["vision_embeds"] = bspec, bspec, b3
    else:
        sds["tokens"] = _meta((batch, seq_len), torch.int32)
        sds["labels"] = _meta((batch, seq_len), torch.int32)
        shd["tokens"], shd["labels"] = bspec, bspec
    return sds, shd


def decode_specs(cfg: ArchConfig, mesh, batch: int, seq_len: int):
    """(cache, its shardings, token, its sharding) of one decode step: the
    cache rules' layout, the (batch, 1) token over the batch axes when
    ``batch`` divides them, else replicated."""
    baxes = batch_axes(mesh)
    dp = math.prod(mesh.shape[ax] for ax in baxes)
    cache = cache_sds(cfg, batch, seq_len)
    cache_shd = make_cache_shardings(cache, mesh)
    tok = _meta((batch, 1), torch.int32)
    tok_shd = NamedSharding(mesh, P(baxes if batch % dp == 0 else None,
                                    None))
    return cache, cache_shd, tok, tok_shd


def input_specs(cfg: ArchConfig, shape_name, mesh, *,
                fsdp: bool = True, layout: str = "tp"):
    """Meta tensors for every input of a ``SHAPES`` cell's step and their
    shardings, no storage: (kind, args, shardings), ``kind`` "train"
    (state, batch), "prefill" (params, cache, batch) or "decode" (params,
    cache, token). ``shape_name`` may also be a cell of its own, a dict
    with ``SHAPES``' keys (seq_len, batch, step)."""
    sh = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if sh["step"] == "train":
        state = train_state_sds(cfg)
        state_shd = train_state_shardings(cfg, mesh, fsdp=fsdp,
                                          layout=layout)
        b_sds, b_shd = batch_sds_and_shardings(cfg, mesh, sh["batch"],
                                               sh["seq_len"], layout=layout)
        return "train", (state, b_sds), (state_shd, b_shd)
    p_sds = params_sds(cfg)
    p_shd = param_shardings(cfg, mesh, fsdp=fsdp, layout=layout)
    c_sds, c_shd, tok_sds, tok_shd = decode_specs(cfg, mesh, sh["batch"],
                                                  sh["seq_len"])
    if sh["step"] == "prefill":
        b_sds, b_shd = batch_sds_and_shardings(cfg, mesh, sh["batch"],
                                               sh["seq_len"], layout=layout)
        b_sds.pop("labels")
        b_shd.pop("labels")
        return "prefill", (p_sds, c_sds, b_sds), (p_shd, c_shd, b_shd)
    return "decode", (p_sds, c_sds, tok_sds), (p_shd, c_shd, tok_shd)
