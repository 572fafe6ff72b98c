"""The sharded LM path's collectives: where GSPMD and ``shard_map`` place
them in the JAX package, the port calls them explicitly.

Every rank holds its shard of each parameter leaf (``shard``), as its
``PartitionSpec`` says, and the same code runs in every rank. The
forward fetches a weight at use (``ShardCtx.gather``), except the dims a
tensor- or expert-parallel region computes on locally; the regions are
bracketed by Megatron's two operators, ``copy_to`` (identity forward,
psum backward) and ``reduce_from`` (psum forward, identity backward).

The gradients follow one rule. Each rank's loss holds the global value
(its sums over the batch are ``reduce_from``s over the axes the batch is
split on), and its backward gives the rank's own contribution. So:

* a gather over an axis that carries different data (a batch axis the
  batch is split on; every axis under ``layout="fsdp"``) has a
  reduce-scatter **sum** for its backward (the contributions of every
  rank's tokens), while a gather over an axis where the compute is
  replicated ("model" outside a tensor-parallel region; a batch axis the
  batch does not divide) has a **slice**: a sum there would multiply the
  gradient by the axis size;
* after the backward, ``grad_sync`` sums each leaf's gradient over the
  split axes its spec does not shard it on (the data-parallel
  all-reduce), one all-reduce per bucket of leaves;
* a value every rank computes alike from global data (the MoE aux under
  the fsdp layout) passes ``replicated``: identity forward, its gradient
  divided by the split size, so the sum above counts it once.

With no process group every collective is the identity (one rank).
"""
from __future__ import annotations

import copy
import itertools
import math
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.engine.stats import MeshComm
from repro_torch.sharding.specs import (PartitionSpec, batch_axes,
                                        batch_prefix, make_param_specs)
from repro_torch.utils.tree import Stacked, map_tree

Tensor = torch.Tensor

# Gradients of leaves that share their reduction axes are summed in
# buckets of at most this many bytes (one all-reduce each).
GRAD_BUCKET_BYTES = 256 << 20


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards on, in entry order."""
    return tuple(ax for e in spec for ax in entry_axes(e))


def shard(full: Tensor, spec, mesh) -> Tensor:
    """This rank's piece of ``full`` under ``spec`` (a contiguous copy):
    along each sharded dim, block ``axis_rank(axes)`` of ``prod(sizes)``
    equal blocks, the axes of an entry taken in row-major order."""
    x = full
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = math.prod(mesh.shape[ax] for ax in axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split {n} ways ({spec})")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_rank(axes) * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def unshard(local: Tensor, spec, mesh, *, ledger=None) -> Tensor:
    """The full tensor back from every rank's piece (an all-gather along
    each sharded dim; with no process group, ``local`` itself)."""
    x = local
    for dim, entry in enumerate(spec):
        for ax in reversed(entry_axes(entry)):
            x = MeshComm((ax,), mesh=mesh, ledger=ledger).all_gather(
                x, dim=dim)
    return x


def shard_tree(tree, specs, mesh):
    """``shard`` over a tree and its spec tree (``make_param_specs``'s
    structure: a ``Stacked`` of tensors against a ``Stacked`` of specs)."""
    return map_tree(lambda t, s: shard(t, s, mesh), tree, specs)


def unshard_tree(tree, specs, mesh, *, ledger=None):
    return map_tree(lambda t, s: unshard(t, s, mesh, ledger=ledger), tree,
                    specs)


# ---------------------------------------------------------------------------
# autograd-aware collectives
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward: reduce-scatter sum (``split``)
    or this rank's slice."""

    @staticmethod
    def forward(ctx, x, comm, dim, split):
        ctx.comm, ctx.dim, ctx.split = comm, dim, split
        return comm.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.split:
            return ctx.comm.reduce_scatter(g, dim=ctx.dim), None, None, None
        n = ctx.comm.n_shards
        size = g.shape[ctx.dim] // n
        return (g.narrow(ctx.dim, ctx.comm.index * size, size).contiguous(),
                None, None, None)


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward, psum backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.psum(g), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: psum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.psum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all; backward: the reverse all-to-all."""

    @staticmethod
    def forward(ctx, x, comm, split_dim, concat_dim):
        ctx.comm, ctx.split_dim, ctx.concat_dim = comm, split_dim, concat_dim
        return comm.all_to_all(x, split_dim=split_dim, concat_dim=concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm.all_to_all(g, split_dim=ctx.concat_dim,
                                    concat_dim=ctx.split_dim),
                None, None, None)


class _Mean(torch.autograd.Function):
    """pmean forward; backward: the gradient over ``n_split`` (the split
    ranks' contributions are summed by ``grad_sync``; over the other axes
    the values are alike and the gradient passes as it is)."""

    @staticmethod
    def forward(ctx, x, comm, n_split):
        ctx.n_split = n_split
        return comm.psum(x) / comm.n_shards

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n_split, None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_split):
        ctx.n_split = n_split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n_split, None


class ShardCtx:
    """The runtime side of a sharded layout: the mesh's groups, how the
    current batch is split, gather-at-use and the collectives above.

    ``layout`` "tp" (tensor / expert parallel over "model", the batch over
    ("pod", "data")) or "fsdp" (ZeRO-3 over "model", the batch over every
    axis); ``fsdp``: dmodel over "data" under "tp". Building it makes a
    process group for every set of the mesh's axes, in one order: a
    collective call over the world, made by every rank at the same point.
    ``split`` holds the batch axes the current batch is split on
    (``shard_batch`` sets it).
    """

    def __init__(self, mesh, *, layout: str = "tp", fsdp: bool = False,
                 ledger=None):
        if layout not in ("tp", "fsdp"):
            raise ValueError(f"layout {layout!r}")
        self.mesh, self.layout, self.fsdp = mesh, layout, fsdp
        self.ledger = ledger
        self.batch_axes = batch_axes(mesh, layout)
        self.split: Tuple[str, ...] = self.batch_axes
        self._comms: Dict[Tuple[str, ...], MeshComm] = {}
        self._specs: dict = {}
        names = tuple(mesh.axis_names)
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                self.comm(axes)

    # -- groups ------------------------------------------------------------
    def comm(self, axes: Sequence[str]) -> MeshComm:
        """The collectives over ``axes`` (taken in mesh order)."""
        names = list(self.mesh.axis_names)
        axes = tuple(sorted(set(axes), key=names.index))
        if axes not in self._comms:
            self._comms[axes] = MeshComm(axes, mesh=self.mesh,
                                         ledger=self.ledger)
        return self._comms[axes]

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.mesh.shape[ax] for ax in axes)

    @property
    def model(self) -> int:
        return self.mesh.shape["model"]

    def index(self, axes: Sequence[str]) -> int:
        return self.mesh.axis_rank(tuple(axes))

    # -- parameters --------------------------------------------------------
    def param_specs(self, cfg):
        """The spec tree of ``cfg``'s ``param_tree`` on this mesh (the
        JAX launcher's ``param_shardings``: moe_layout = cfg.moe_impl)."""
        if cfg not in self._specs:
            from repro_torch.launch.specs import params_sds
            self._specs[cfg] = make_param_specs(
                params_sds(cfg), self.mesh, fsdp=self.fsdp,
                layout=self.layout, moe_layout=cfg.moe_impl)
        return self._specs[cfg]

    def gather(self, w: Tensor, spec, keep: Sequence[str] = ()) -> Tensor:
        """``w``'s local shard gathered along every sharded dim whose axes
        are not all in ``keep`` (gather at use; see the module docstring
        for the backward)."""
        keep = set(keep)
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            if not axes or set(axes) <= keep:
                continue
            for ax in reversed(axes):
                w = _Gather.apply(w, self.comm((ax,)), dim,
                                  ax in self.split)
        return w

    def gather_all(self, p: dict, specs: dict, keep: Sequence[str] = ()):
        """``gather`` over a (nested) dict of a layer's weights."""
        return {k: (self.gather_all(v, specs[k], keep)
                    if isinstance(v, dict) else
                    self.gather(v, specs[k], keep))
                for k, v in p.items()}

    # -- activations -------------------------------------------------------
    def copy_to(self, x: Tensor, axes: Sequence[str]) -> Tensor:
        return _CopyTo.apply(x, self.comm(axes))

    def reduce_from(self, x: Tensor, axes: Sequence[str]) -> Tensor:
        return _ReduceFrom.apply(x, self.comm(axes))

    def all_to_all(self, x: Tensor, axes: Sequence[str], *, split_dim: int,
                   concat_dim: int) -> Tensor:
        return _AllToAll.apply(x, self.comm(axes), split_dim, concat_dim)

    def pmean(self, x: Tensor, axes: Sequence[str]) -> Tensor:
        """The mean over ``axes`` of a value the split ranks compute from
        their own tokens (the MoE aux)."""
        n_split = self.size([ax for ax in axes if ax in self.split])
        return _Mean.apply(x, self.comm(axes), n_split)

    def replicated(self, x: Tensor) -> Tensor:
        """A value every rank computes alike from global data."""
        return _Replicated.apply(x, self.size(self.split))

    def psum_split(self, x: Tensor) -> Tensor:
        """The sum over the split axes, identity backward (the loss)."""
        return self.reduce_from(x, self.split) if self.split else x

    def gather_split(self, x: Tensor) -> Tensor:
        """Every split rank's rows of ``x`` (dim 0), in batch order;
        backward: the reduce-scatter sum of the gradient."""
        for ax in reversed(self.split):
            x = _Gather.apply(x, self.comm((ax,)), 0, True)
        return x

    def split_slice(self, x: Tensor) -> Tensor:
        """This rank's rows of a batch-ordered ``x`` (dim 0)."""
        if not self.split:
            return x
        n = self.size(self.split)
        size = x.shape[0] // n
        return x.narrow(0, self.index(self.split) * size, size)

    # -- the batch ---------------------------------------------------------
    def batch_split(self, batch: int, *,
                    needs_two: bool = False) -> Tuple[str, ...]:
        """The batch axes a global batch of ``batch`` rows is split on:
        the longest prefix whose size divides it (the JAX package's
        ``batch_sds_and_shardings``; with ``needs_two`` a batch of one is
        not split, as its ``make_constrain`` has it)."""
        return batch_prefix(self.mesh, self.batch_axes, batch,
                            needs_two=needs_two)

    def with_split(self, split: Sequence[str]) -> "ShardCtx":
        """This context with the batch split on ``split``: a copy sharing
        the groups and the specs (``self`` keeps its own split)."""
        ctx = copy.copy(self)
        ctx.split = tuple(split)
        return ctx

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch; sets ``split``."""
        b = next(iter(batch.values())).shape[0]
        self.split = self.batch_split(b)
        return {k: self.split_slice(v) for k, v in batch.items()}

    # -- gradients ---------------------------------------------------------
    def grad_sync(self, grads: list, specs: list) -> list:
        """Each gradient summed over the split axes its spec does not
        shard on: one all-reduce per bucket of leaves with the same axes."""
        out = list(grads)
        groups: Dict[Tuple[str, ...], list] = {}
        for i, spec in enumerate(specs):
            axes = tuple(ax for ax in self.split if ax not in spec_axes(spec))
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            comm = self.comm(axes)
            for bucket in _buckets(idx, out):
                flat = comm.psum(torch.cat([out[i].reshape(-1)
                                            for i in bucket]))
                for i, piece in zip(bucket, flat.split(
                        [out[i].numel() for i in bucket])):
                    out[i] = piece.view_as(out[i])
        return out

    def psum(self, x: Tensor, axes: Sequence[str]) -> Tensor:
        """The sum over ``axes`` (a value: no gradient rule)."""
        return self.comm(axes).psum(x) if axes else x


def _buckets(idx: list, tensors: list):
    """Runs of ``idx`` of one dtype whose bytes stay under
    GRAD_BUCKET_BYTES (a leaf larger than that is a bucket alone)."""
    bucket, nbytes, dtype = [], 0, None
    for i in idx:
        t = tensors[i]
        b = t.numel() * t.element_size()
        if bucket and (nbytes + b > GRAD_BUCKET_BYTES or t.dtype != dtype):
            yield bucket
            bucket, nbytes = [], 0
        bucket.append(i)
        nbytes += b
        dtype = t.dtype
    if bucket:
        yield bucket


def stacked_spec(spec) -> PartitionSpec:
    """The spec of a stacked (R, ...) leaf from its per-layer spec."""
    return PartitionSpec(None, *spec)


def leaf_specs(specs) -> list:
    """A spec tree's entries in ``leaves(params)`` order (a ``Stacked``
    of specs gives one entry per layer)."""
    out: list = []

    def walk(t):
        if isinstance(t, PartitionSpec):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
    walk(specs)
    return out


def stacked_leaf_specs(specs) -> list:
    """A spec tree's entries in ``leaves(params, stacked=True)`` order: a
    ``Stacked`` of per-layer specs gives the stacked leaf's spec."""
    out: list = []

    def walk(t):
        if isinstance(t, Stacked):
            out.append(stacked_spec(t[0]))
        elif isinstance(t, PartitionSpec):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
    walk(specs)
    return out


def padded(spec, ndim: int) -> tuple:
    """``spec``'s entries padded with None to ``ndim``."""
    return tuple(spec) + (None,) * (ndim - len(spec))


def global_dim(local: Tensor, spec, dim: int, mesh) -> int:
    """The full size of ``local``'s dim ``dim`` under ``spec``."""
    dim = dim % local.dim()
    entry = spec[dim] if dim < len(spec) else None
    return local.shape[dim] * math.prod(mesh.shape[ax]
                                        for ax in entry_axes(entry))

