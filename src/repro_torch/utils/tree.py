"""Trees of tensors in the JAX package's parameter layout.

The JAX package stacks the layers of each period position on a leading
axis of length ``n_repeats`` under ``"segments"`` and keeps the layers of
a partial period apart under ``"tail"``. The port keeps one tensor per
layer; a ``Stacked`` holds the R per-layer tensors that one stacked JAX
leaf is made of, in repeat order. A tree is nested dicts, lists and
(named) tuples, its dicts visited in sorted key order (as
``jax.tree_util`` visits them, so trees built in another key order line
up leaf for leaf); ``map_tree`` walks a ``Stacked`` as a list of leaves, or,
with ``stacked=True``, takes it as one leaf (Adafactor factors and clips
the stacked leaf whole, as the JAX package does: ROADMAP C.16).
"""
from __future__ import annotations

from typing import Callable

import torch


class Stacked(list):
    """The per-layer tensors of one stacked JAX leaf, in repeat order."""

    @property
    def shape(self) -> tuple:
        """The stacked leaf's shape: (R, *the layer's shape)."""
        return (len(self),) + tuple(self[0].shape)

    def stack(self) -> torch.Tensor:
        return torch.stack(list(self))


def map_tree(fn: Callable, tree, *rest, stacked: bool = False):
    """``fn(leaf, *leaves of rest)`` over the leaves of ``tree``; ``rest``
    are trees of the same structure (where ``tree`` holds a ``Stacked``
    leaf and ``stacked`` is set, theirs may hold anything). ``None``
    stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, Stacked) and stacked:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest),
                            stacked=stacked) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        vals = [map_tree(fn, t, *(r[i] for r in rest), stacked=stacked)
                for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)


def leaves(tree, *, stacked: bool = False) -> list:
    """The leaves of ``tree`` in ``map_tree``'s order."""
    out: list = []
    map_tree(out.append, tree, stacked=stacked)
    return out


def unflatten(tree, values, *, stacked: bool = False):
    """``tree``'s structure with ``values`` (in ``leaves`` order) in place
    of its leaves."""
    it = iter(values)
    return map_tree(lambda _: next(it), tree, stacked=stacked)
