"""AdamW over a tree of tensors (the JAX package's ``repro.optim.adamw``).

The moments are f32 whatever the parameters' dtype, every leaf decays
(norms and embeddings too), and the new parameter is
``p - lr * (m̂ / (√v̂ + eps) + wd * p)`` computed in f32 and cast once —
which is why this is not ``torch.optim.AdamW`` (that keeps its moments in
the parameter's dtype and decays before the step). ``update`` writes the
new parameters and moments into the tensors it is given and returns them:
at full width a second copy of the moments would not fit beside the
first. A ``Stacked`` leaf is updated tensor by tensor (AdamW is
elementwise).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.utils.tree import leaves, map_tree


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=map_tree(zeros, params), v=map_tree(zeros, params))


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """One step; ``lr`` a float or an f32 tensor. Returns (params, state),
    the params' and moments' tensors updated in place."""
    step = state.step + 1
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        p32 = p.float()
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        upd.add_(weight_decay * p32)
        p.copy_(p32 - lr * upd)
    return params, AdamWState(step=step, m=state.m, v=state.v)
