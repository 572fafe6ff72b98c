"""Adafactor (factored second moments, no momentum) over a tree of tensors
(the JAX package's ``repro.optim.adafactor``): the optimizer of the
multi-hundred-B MoE configs, where AdamW's f32 moments cannot fit.

Shazeer & Stern (2018): decay 1 - step^-0.8, update RMS clipped at 1.0,
an explicit lr schedule. A leaf of rank >= 2 keeps row and column second
moments (``vr`` of shape[:-1], ``vc`` of shape[:-2] + shape[-1:]); a
lower-rank leaf keeps the full ``vr`` and a (1,) placeholder ``vc``.

The leaves are the JAX package's: a ``Stacked`` leaf (one period
position's layers, R of them) is factored and RMS-clipped as the one
(R, ...) array the JAX tree holds, so a per-layer norm of shape (d,) is
a factored (R, d) leaf there, and its clip takes one mean over the R
layers together (ROADMAP C.16). Its ``vr`` / ``vc`` are whole (R, ...)
tensors. ``update`` writes the new parameters into the tensors it is
given (the state's moments are small and come back as new tensors).

Sharded (``sharding`` a ``ShardCtx``, ``specs`` the parameters' spec
tree), each rank updates its shards and its pieces of ``vr`` / ``vc``
(the parameter's layout without the averaged dim): the factored means
and the RMS clip are taken over the global stacked leaf, their partial
sums psummed over the axes that shard the dims they reduce. The fsdp
layout's ZeRO-2 moments (``launch.specs.opt_state_shardings``'s second
"data" dim) are not laid out so: the moments keep the parameters'
layout.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sharding.collectives import (entry_axes, padded,
                                              spec_axes, stacked_leaf_specs)
from repro_torch.utils.tree import Stacked, leaves, map_tree, unflatten


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: dict   # row second moments (rank >= 2) or the full v (rank < 2)
    vc: dict   # column second moments (rank >= 2) or a (1,) placeholder


def _factored(shape) -> bool:
    return len(shape) >= 2


def _device(p) -> torch.device:
    return (p[0] if isinstance(p, Stacked) else p).device


def init(params) -> AdafactorState:
    def vrow(p):
        shape = tuple(p.shape)
        return torch.zeros(shape[:-1] if _factored(shape) else shape,
                           dtype=torch.float32, device=_device(p))

    def vcol(p):
        shape = tuple(p.shape)
        return torch.zeros(shape[:-2] + shape[-1:] if _factored(shape)
                           else (1,), dtype=torch.float32,
                           device=_device(p))

    first = leaves(params, stacked=True)[0]
    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=_device(first)),
        vr=map_tree(vrow, params, stacked=True),
        vc=map_tree(vcol, params, stacked=True))


Tensor = torch.Tensor


class _Means:
    """Means over dims of a (stacked) leaf: local, or over its shards."""

    def __init__(self, sharding, spec, shape):
        self.sh = sharding
        self.spec = None if spec is None else padded(spec, len(shape))

    def dim(self, x: Tensor, dim: int, leaf_dim: int, keepdim=False):
        """The mean of ``x`` over ``dim``, the leaf's dim ``leaf_dim``."""
        if self.spec is None:
            return torch.mean(x, dim=dim, keepdim=keepdim)
        axes = entry_axes(self.spec[leaf_dim])
        n = x.shape[dim] * self.sh.size(axes)
        return self.sh.psum(x.sum(dim=dim, keepdim=keepdim), axes) / n

    def all(self, x: Tensor) -> Tensor:
        if self.spec is None:
            return torch.mean(x)
        axes = spec_axes(self.spec)
        return self.sh.psum(x.sum(), axes) / (x.numel() * self.sh.size(axes))


@torch.no_grad()
def update(grads, state: AdafactorState, params, *, lr,
           eps: float = 1e-30, clip_threshold: float = 1.0,
           weight_decay: float = 0.0, sharding=None, specs=None):
    """One step; ``lr`` a float or an f32 tensor. Returns (params, state),
    the params' tensors updated in place. ``sharding`` / ``specs``: the
    sharded step's (see the module docstring)."""
    step = state.step + 1
    beta2 = 1.0 - step.float() ** -0.8

    def upd(p, g, vr, vc, spec):
        g = (g.stack() if isinstance(g, Stacked) else g).float()
        mean = _Means(sharding, spec, g.shape)
        g2 = g * g + eps
        if _factored(g.shape):
            vr = beta2 * vr + (1 - beta2) * mean.dim(g2, -1, -1)
            vc = beta2 * vc + (1 - beta2) * mean.dim(g2, -2, -2)
            rfac = torch.rsqrt(vr / mean.dim(vr, -1, -2, keepdim=True)
                               + eps)
            cfac = torch.rsqrt(vc + eps)
            u = g * rfac[..., None] * cfac[..., None, :]
        else:
            vr = beta2 * vr + (1 - beta2) * g2
            u = g * torch.rsqrt(vr + eps)
        # RMS clip over the whole (stacked) leaf.
        rms = torch.sqrt(mean.all(u * u) + 1e-30)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        p32 = (p.stack() if isinstance(p, Stacked) else p).float()
        new_p = p32 - lr * u
        if weight_decay:
            new_p = new_p - lr * weight_decay * p32
        for dst, src in (zip(p, new_p) if isinstance(p, Stacked)
                         else ((p, new_p),)):
            dst.copy_(src)
        return vr, vc

    ps = leaves(params, stacked=True)
    sp = stacked_leaf_specs(specs) if sharding is not None \
        else [None] * len(ps)
    out = [upd(*t) for t in zip(ps, *(leaves(x, stacked=True) for x in (
        grads, state.vr, state.vc)), sp)]
    return params, AdafactorState(
        step=step, vr=unflatten(state.vr, [o[0] for o in out]),
        vc=unflatten(state.vc, [o[1] for o in out]))
