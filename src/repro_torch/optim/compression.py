"""Error-feedback int8 gradient compression for the data-parallel
all-reduce (the JAX package's ``repro.optim.compression``).

1-bit/8-bit SGD family: quantize the local gradient to int8 with a
per-leaf scale before the cross-replica sum, keep the quantization
residual locally and add it back into the next step's gradient (error
feedback keeps the scheme unbiased in the long run). Cuts the all-reduce
bytes 4x against f32 (2x against bf16).

The JAX package's docstring says its ``train_step`` uses this "when
compress_grads=True"; no such flag exists there, and none here: these
are the functions, for a caller's own data-parallel loop (ROADMAP C.18).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.utils.tree import leaves, map_tree, unflatten

Tensor = torch.Tensor


def init_error_state(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(g: Tensor, err: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (int8 q, f32 scale, new residual); q * scale + residual ==
    g + err. Rounding half to even, as ``jnp.round``."""
    g = g.float() + err
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, g - deq


def psum_compressed(grads, err_state, comm) -> Tuple[dict, dict]:
    """All-reduce int8-quantized gradients over ``comm`` (a
    ``core.engine.MeshComm`` over the data axes; every rank calls it).

    The int8 payload is summed in int32 (no overflow below 2^23
    replicas); the scales are psum-averaged. Returns (mean f32 gradients,
    new error state)."""
    n = comm.n_shards or 1

    def one(g, err):
        q, scale, new_err = compress(g, err)
        qsum = comm.psum(q.to(torch.int32))
        ssum = comm.psum(scale)
        # Each replica used its own scale; approximate the sum with the
        # mean scale (error feedback absorbs the residual).
        return qsum.float() * (ssum / n) / n, new_err

    outs = [one(g, e) for g, e in zip(leaves(grads), leaves(err_state))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(err_state, [o[1] for o in outs]))
