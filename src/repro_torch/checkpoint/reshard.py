"""Elastic resharding: restore any checkpoint onto any mesh (the JAX
package's ``repro.checkpoint.reshard``).

Checkpoints store mesh-agnostic full arrays (``save_sharded`` gathers a
sharded tree's leaves and one rank writes them, in the JAX package's
format), so elastic rescale is "restore with the new mesh's shardings":

    new_state = reshard_checkpoint(dir, step, like_state, new_mesh)

gives every rank its shards on ``new_mesh`` (512 -> 256 -> 128 ranks:
node loss, pool shrink). The specs are the parameter rules', applied to
every leaf by its path (an optimizer moment takes its parameter's), as
in the JAX package.
"""
from __future__ import annotations

import os
from typing import Any

import torch.distributed as dist

from repro_torch.checkpoint import manager
from repro_torch.sharding.collectives import shard_tree, unshard
from repro_torch.sharding.specs import (NamedSharding, make_param_specs,
                                        map_specs)
from repro_torch.utils.tree import leaves, map_tree


def shardings_for(like: Any, mesh, *, fsdp: bool = True):
    """Param-rule shardings for every leaf of a params-like tree (a
    ``Stacked`` leaf gets a ``Stacked`` of per-layer shardings)."""
    return map_specs(lambda s: NamedSharding(mesh, s),
                     make_param_specs(like, mesh, fsdp=fsdp))


def reshard_checkpoint(directory: str, step: int, like: Any, mesh, *,
                       fsdp: bool = True):
    """This rank's shards on ``mesh`` of the checkpoint's full arrays, in
    the form of ``like`` (full-shaped leaves; their dtypes and devices
    are kept)."""
    return manager.restore(directory, step, like,
                           shardings=shardings_for(like, mesh, fsdp=fsdp))


def reshard_live(tree: Any, mesh, *, fsdp: bool = True):
    """Re-lay a tree of full tensors onto ``mesh`` (no disk round trip):
    this rank's shards."""
    return shard_tree(tree, make_param_specs(tree, mesh, fsdp=fsdp), mesh)


def save_sharded(directory: str, step: int, tree: Any, shardings: Any, *,
                 extra=None) -> str:
    """Save a sharded tree as full arrays: every leaf gathered by its
    ``NamedSharding`` (collectives: every rank of the mesh calls this),
    one leaf at a time, into the mesh's first rank's host memory (the
    others drop theirs); that rank writes and the others wait for it.
    Returns the checkpoint's path."""
    mesh = leaves(shardings)[0].mesh
    writer = mesh.rank == mesh.ranks[0]

    def gather(t, s):
        full = unshard(t, s.spec, s.mesh)
        return full.cpu() if writer else None
    full = map_tree(gather, tree, shardings)
    if writer:
        manager.save(directory, step, full, extra=extra)
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
    return os.path.join(directory, f"step_{step:09d}")
