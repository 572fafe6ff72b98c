"""Logical-axis sharding rules -> PartitionSpec, with divisibility fallback
(the JAX package's ``repro.sharding.specs``).

Axis mapping (production mesh: ("pod",) "data", "model"):

  vocab / heads / ff / experts / inner  -> "model"   (tensor/expert parallel)
  dmodel                                -> "data" when FSDP is on (ZeRO-3
                                           weight sharding; all-gather at use)
  batch                                 -> ("pod", "data")

Any logical axis whose size does not divide its mesh axis falls back to
replicated (e.g. internvl2's 92553 vocab on a 16-way model axis).

A ``PartitionSpec`` here is the port's own: a tuple with one entry per
dim (trailing replicated dims may be left out), each entry ``None``, an
axis name or a tuple of names. A mesh is anything with ``axis_names``
and ``shape`` (axis -> size): a ``launch.mesh.SolverMesh`` over the
process group, or an ``AbstractMesh`` that only names a layout (the
rules need no processes).

The rules walk the port's ``param_tree``: the JAX tree stacks each
period position's layers on a leading R axis under "segments", where the
port keeps one tensor per layer (``utils.tree.Stacked``). A stacked
leaf's spec is computed on the stacked (R, ...) shape, as in the JAX
package, and each per-layer tensor takes it with that leading ``None``
dropped.

``make_constrain`` returns the identity on local tensors (each rank
already holds its shard: nothing is laid out behind the caller's back).
It carries ``sharding``, the runtime ``collectives.ShardCtx`` (the
mesh's groups, the layout, the batch split, gather-at-use) that the
port's forward and train step read where GSPMD would place the
collectives; its ``layout`` picks the tensor- and expert-parallel paths.
Under "tp" it also carries the JAX version's ``shard_ctx`` (mesh, data
axes, fsdp) for callers of that API; the port does not read it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.utils.tree import Stacked


class PartitionSpec(tuple):
    """One entry per dim: ``None``, an axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no processes: the port's
    ``jax.sharding.AbstractMesh``, for deriving specs of a mesh that is
    not there (a production pod on a test machine)."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the port's ``jax.sharding.NamedSharding``): where
    ``checkpoint.manager.restore`` and ``launch.specs`` lay a leaf."""

    mesh: object
    spec: PartitionSpec


# Rules keyed by (parent, leaf) or leaf name: logical axes for the LAST
# len(rule) dims of the param. None = replicated dim.
_RULES = {
    ("", "embed"): ("vocab", "dmodel"),
    ("", "unembed"): ("dmodel", "vocab"),
    ("attn", "wq"): ("dmodel", "heads"),
    ("attn", "wk"): ("dmodel", "heads"),
    ("attn", "wv"): ("dmodel", "heads"),
    ("attn", "wo"): ("heads", "dmodel"),
    ("mlp", "w1"): ("dmodel", "ff"),
    ("mlp", "w3"): ("dmodel", "ff"),
    ("mlp", "w2"): ("ff", "dmodel"),
    ("dense_res", "w1"): ("dmodel", "ff"),
    ("dense_res", "w3"): ("dmodel", "ff"),
    ("dense_res", "w2"): ("ff", "dmodel"),
    ("moe", "router"): (None, None),
    ("moe", "w1"): ("experts", "dmodel", "ff"),
    ("moe", "w3"): ("experts", "dmodel", "ff"),
    ("moe", "w2"): ("experts", "ff", "dmodel"),
    ("mamba", "in_proj"): ("dmodel", "inner"),
    ("mamba", "conv_w"): (None, "inner"),
    ("mamba", "x_proj"): ("inner", None),
    ("mamba", "dt_proj"): (None, "inner"),
    ("mamba", "A_log"): ("inner", None),
    ("mamba", "D"): ("inner",),
    ("mamba", "out_proj"): ("inner", "dmodel"),
    ("rwkv", "wr"): ("dmodel", "heads"),
    ("rwkv", "wk"): ("dmodel", "heads"),
    ("rwkv", "wv"): ("dmodel", "heads"),
    ("rwkv", "wg"): ("dmodel", "heads"),
    ("rwkv", "wo"): ("heads", "dmodel"),
    ("cmix", "wk"): ("dmodel", "ff"),
    ("cmix", "wv"): ("ff", "dmodel"),
}

_PARENTS = ("attn", "mlp", "moe", "mamba", "rwkv", "cmix", "dense_res")


def _logical_to_mesh(logical: Optional[str], fsdp: bool,
                     layout: str = "tp") -> Optional[str]:
    if logical is None:
        return None
    if layout == "fsdp":
        # Pure data-parallel layout: no tensor parallelism; weights are
        # ZeRO-3 sharded over the "model" axis (gathered at use) and the
        # batch spans every mesh axis.
        return "model" if logical == "dmodel" else None
    if logical == "dmodel":
        return "data" if fsdp else None
    return "model"


def _moe_experts_divisible(shape, mesh) -> bool:
    return shape[-3] % mesh.shape["model"] == 0


def _prod(mesh, axes) -> int:
    return math.prod(mesh.shape[ax] for ax in axes)


def spec_for_param(names: Sequence[str], shape, mesh, *, fsdp: bool,
                   layout: str = "tp", moe_layout: str = "psum"
                   ) -> PartitionSpec:
    """PartitionSpec for one param leaf given the dict keys of its tree
    path and its (stacked, where the JAX tree stacks it) shape."""
    names = [str(n) for n in names]
    leaf = names[-1] if names else ""
    parent = ""
    for n in reversed(names[:-1]):
        if n in _PARENTS:
            parent = n
            break
    rule = _RULES.get((parent, leaf)) or _RULES.get(("", leaf))
    if rule is None:
        return P()  # norms, scalars, biases: replicated

    rule = list(rule)
    # MoE: experts over "model" when divisible (EP; ff replicated within a
    # shard), else expert-TP on the ff dim. moe_layout="a2a": experts over
    # the data axes + ff-TP over "model" (weights fully sharded, tokens
    # move instead: models/moe._moe_forward_a2a).
    if parent == "moe" and leaf in ("w1", "w2", "w3"):
        if moe_layout == "a2a":
            baxes = batch_axes(mesh)
            dp = _prod(mesh, baxes)
            E = shape[-3]
            ff = shape[-1] if leaf in ("w1", "w3") else shape[-2]
            if E % dp == 0 and ff % mesh.shape["model"] == 0:
                ndim = len(shape)
                axes = [None] * ndim
                axes[ndim - 3] = baxes
                if leaf in ("w1", "w3"):
                    axes[ndim - 1] = "model"
                else:
                    axes[ndim - 2] = "model"
                return P(*axes)
        if _moe_experts_divisible(shape, mesh):
            rule = (["experts", "dmodel", None] if leaf in ("w1", "w3")
                    else ["experts", None, "dmodel"])
        else:
            rule = ([None, "dmodel", "ff"] if leaf in ("w1", "w3")
                    else [None, "ff", "dmodel"])
    if layout == "fsdp":
        # ZeRO-3 wants one sharded dim: every ruled dim competes, the
        # first that divides wins.
        rule = ["dmodel" if r is not None else None for r in rule]

    ndim = len(shape)
    axes: list = [None] * ndim
    offset = ndim - len(rule)   # leading stacked axes (scan segments)
    for i, logical in enumerate(rule):
        ax = _logical_to_mesh(logical, fsdp, layout)
        if ax is not None and shape[offset + i] % mesh.shape[ax] == 0:
            axes[offset + i] = ax
            if layout == "fsdp":
                break  # one sharded dim is enough for ZeRO-3
    return P(*axes)


def layer_spec(spec: PartitionSpec) -> PartitionSpec:
    """A stacked leaf's spec for one of its per-layer tensors: the
    leading (stack) entry dropped."""
    return P(*tuple(spec)[1:])


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def map_with_names(fn, tree, names: tuple = ()):
    """``fn(names, leaf)`` over a port tree (dicts in sorted key order,
    lists, tuples, named tuples; a ``Stacked`` is one leaf); ``names`` are
    the dict keys on the leaf's path, as the JAX rules read them."""
    if tree is None:
        return None
    if isinstance(tree, Stacked):
        return fn(names, tree)
    if isinstance(tree, dict):
        return {k: map_with_names(fn, tree[k], names + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_names(fn, getattr(tree, f), names)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_names(fn, t, names) for t in tree)
    return fn(names, tree)


def make_param_specs(params_shapes, mesh, *, fsdp: bool = True,
                     layout: str = "tp", moe_layout: str = "psum"):
    """A tree of the port's layout (tensors, meta tensors or anything with
    a ``shape``; ``Stacked`` leaves) -> the same tree of PartitionSpec,
    a ``Stacked`` leaf's tensors each with the per-layer spec."""
    def one(names, leaf):
        spec = spec_for_param(names, _shape(leaf), mesh, fsdp=fsdp,
                              layout=layout, moe_layout=moe_layout)
        if isinstance(leaf, Stacked):
            return Stacked([layer_spec(spec)] * len(leaf))
        return spec
    return map_with_names(one, params_shapes)


def map_specs(fn, tree):
    """``fn`` over the specs (or NamedShardings) of a spec tree, its
    ``Stacked``, dicts, lists and named tuples kept."""
    if isinstance(tree, (PartitionSpec, NamedSharding)):
        return fn(tree)
    if isinstance(tree, Stacked):
        return Stacked(map_specs(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, getattr(tree, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, t) for t in tree)
    return tree


def batch_axes(mesh, layout: str = "tp") -> Tuple[str, ...]:
    if layout == "fsdp":
        return tuple(ax for ax in ("pod", "data", "model")
                     if ax in mesh.axis_names)
    return tuple(ax for ax in ("pod", "data") if ax in mesh.axis_names)


def batch_prefix(mesh, axes: Tuple[str, ...], dim: int, *,
                 needs_two: bool = False) -> Tuple[str, ...]:
    """The longest prefix of ``axes`` whose size divides ``dim`` (a batch
    of 256 on 512 ranks splits 32-way); ``needs_two``: a dim of 1 is not
    split (``make_constrain``'s rule)."""
    while axes:
        if dim % _prod(mesh, axes) == 0 and (dim > 1 or not needs_two):
            return axes
        axes = axes[:-1]
    return ()


def make_constrain(mesh, *, fsdp: bool = False, layout: str = "tp",
                   ledger=None):
    """The activation hook passed into the model: the identity on local
    tensors, carrying ``sharding`` (a ``collectives.ShardCtx``; its
    collectives record into ``ledger``), which is all the port's model
    reads: its ``layout`` picks the compute layout. layout="fsdp" = no
    tensor parallelism: the batch spans every axis and the weights are
    gathered at use. Under "tp" it also carries the JAX version's
    ``shard_ctx`` ({"mesh", "data_axes", "fsdp"}) for callers of that
    API; nothing in the port reads it.

    Building it makes the mesh's process groups, a collective call over
    the world: every rank builds its constrain at the same point."""
    from repro_torch.sharding.collectives import ShardCtx

    def constrain(x, kind: str):
        return x

    constrain.sharding = ShardCtx(mesh, layout=layout, fsdp=fsdp,
                                  ledger=ledger)
    if layout == "tp":
        constrain.shard_ctx = {"mesh": mesh,
                               "data_axes": batch_axes(mesh, layout),
                               "fsdp": fsdp}
    return constrain


def with_sharding(constrain, sharding):
    """``constrain`` carrying ``sharding`` in place of its own: a new hook
    with the same attributes (``constrain`` is left as it is)."""
    def local(x, kind: str):
        return constrain(x, kind)

    local.__dict__.update(vars(constrain))
    local.sharding = sharding
    return local


def cache_spec_for_leaf(names: Sequence[str], shape, mesh) -> PartitionSpec:
    """KV caches / SSM states: batch over the data axes, plus a second
    sharded dim so no single state replicates at long context:

      KV k/v (B, S, Hkv, Dh):  B -> data axes, S -> "model"
                               (B==1: S -> data axes + "model" combined)
      Mamba conv (B, K-1, inner) / h (B, inner, N): inner -> "model"
      RWKV wkv (B, H, D, D): H -> "model"; shifts (B, d): d -> "model"

    ``names``: the leaf's path (dict keys and named-tuple fields); the
    leaf may carry a leading stacked-segment axis. Consumed by
    ``sharding.state.shard_cache`` and the sharded forward.
    """
    leaf = str(names[-1]) if names else ""
    if leaf == "pos":
        return P()
    baxes = batch_axes(mesh)
    dp = _prod(mesh, baxes)
    model = mesh.shape["model"]

    ndim = len(shape)
    rank = {"k": 4, "v": 4, "conv": 3, "h": 3, "wkv": 4,
            "x_tm": 2, "x_cm": 2}.get(leaf, ndim)
    off = ndim - rank
    axes: list = [None] * ndim
    bdim = off
    b_ok = shape[bdim] % dp == 0 and shape[bdim] > 1

    if leaf in ("k", "v"):
        s_dim = off + 1
        if b_ok:
            axes[bdim] = baxes
            if shape[s_dim] % model == 0:
                axes[s_dim] = "model"
        else:
            combined = baxes + ("model",)
            if shape[s_dim] % (dp * model) == 0:
                axes[s_dim] = combined
            elif shape[s_dim] % model == 0:
                axes[s_dim] = "model"
    elif leaf in ("conv", "wkv", "x_tm", "x_cm", "h"):
        if b_ok:
            axes[bdim] = baxes
        dim = off + 2 if leaf == "conv" else off + 1
        if shape[dim] % model == 0:
            axes[dim] = "model"
    return P(*axes)


def map_cache_with_names(fn, tree, names: tuple = ()):
    """``fn(names, leaf)`` over a cache tree; named-tuple fields count as
    names (the JAX rules read KVCache's "k"/"v" by their field names); a
    ``Stacked`` is one leaf."""
    if isinstance(tree, Stacked):
        return fn(names, tree)
    if tree is None or isinstance(tree, (int, float)):
        return fn(names, tree) if tree is not None else None
    if isinstance(tree, dict):
        return {k: map_cache_with_names(fn, tree[k], names + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_cache_with_names(fn, getattr(tree, f),
                                                 names + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_cache_with_names(fn, t, names) for t in tree)
    return fn(names, tree)


def make_cache_shardings(cache_shapes, mesh):
    """A cache tree -> the same tree of NamedSharding ("pos", an int in
    the port's caches, gets P()); a ``Stacked`` leaf (``cache_tree``'s
    layout) gets a ``Stacked`` of per-layer ones, its stacked spec with
    the leading entry dropped."""
    def one(names, leaf):
        spec = cache_spec_for_leaf(names, tuple(getattr(leaf, "shape", ())),
                                   mesh)
        if isinstance(leaf, Stacked):
            return Stacked([NamedSharding(mesh, layer_spec(spec))]
                           * len(leaf))
        return NamedSharding(mesh, spec)
    return map_cache_with_names(one, cache_shapes)
