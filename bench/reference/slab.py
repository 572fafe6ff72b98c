"""Plain slab decision: what the benchmark holds the program's answers to.

    d(x) = (s(x) - rho1) * (rho2 - s(x)),   s(x) = sum_j gamma_j k(x, t_j)

with the rbf kernel k(x, t) = exp(-kgamma * ||x - t||^2), the slab of
arXiv:2011.03243 (eq. 19 before the sign). Everything here is plain
PyTorch in float64, in blocks of query rows, from the support rows, the
dual coefficients, the offsets and the kernel width that the benchmark
drew; it imports nothing of the program under test.

``precision`` rounds the rows before the float64 arithmetic. The
configuration's own precision gives the reference ("f32": the rows as
drawn; "bf16": rounded to bfloat16, as its tiles are stated); the next
precision below gives the control that the check must refuse ("tf32":
the rows rounded to TF32's 10-bit mantissa; "fp8": to float8 e4m3).
"""
from __future__ import annotations

from typing import Optional

import torch

PRECISIONS = ("f32", "tf32", "bf16", "fp8")

# Query rows a block: the (block, support) float64 distance block is the
# largest buffer (2048 x 65536 x 8 bytes = 1 GiB).
BLOCK_ELEMS = 1 << 27


def round_rows(x: torch.Tensor, precision: str) -> torch.Tensor:
    """f32 rows rounded to ``precision`` (to nearest, ties to even), as
    float64."""
    x = x.to(torch.float32)
    if precision == "f32":
        pass
    elif precision == "bf16":
        x = x.to(torch.bfloat16).to(torch.float32)
    elif precision == "fp8":
        x = x.to(torch.float8_e4m3fn).to(torch.float32)
    elif precision == "tf32":
        bits = x.contiguous().view(torch.int32).to(torch.int64)
        lsb = (bits >> 13) & 1
        bits = ((bits + 0xFFF + lsb) & ~0x1FFF) & 0xFFFFFFFF
        bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
        x = bits.to(torch.int32).view(torch.float32)
    else:
        raise ValueError(f"unknown precision {precision!r}; expected one "
                         f"of {PRECISIONS}")
    return x.to(torch.float64)


def raw_scores(q: torch.Tensor, t: torch.Tensor, gamma: torch.Tensor,
               kgamma: float, *, precision: str = "f32",
               block: Optional[int] = None) -> torch.Tensor:
    """s(q) for query rows q (n, d) against support rows t (m, d) with
    dual coefficients gamma (m,): float64 (n,), on q's device."""
    if q.ndim != 2 or t.ndim != 2 or q.shape[1] != t.shape[1] \
            or gamma.shape != (t.shape[0],):
        raise ValueError(f"shapes: q {tuple(q.shape)}, t {tuple(t.shape)}, "
                         f"gamma {tuple(gamma.shape)}")
    t64 = round_rows(t, precision)
    tn = (t64 * t64).sum(dim=1)
    g64 = gamma.to(torch.float64)
    if block is None:
        block = max(1, BLOCK_ELEMS // max(1, t.shape[0]))
    out = torch.empty((q.shape[0],), dtype=torch.float64, device=q.device)
    for i in range(0, q.shape[0], block):
        qb = round_rows(q[i:i + block], precision)
        sq = (qb * qb).sum(dim=1, keepdim=True) + tn[None, :] \
            - 2.0 * (qb @ t64.T)
        out[i:i + block] = torch.exp(-kgamma * sq.clamp_min_(0.0)) @ g64
    return out


def decision(q: torch.Tensor, t: torch.Tensor, gamma: torch.Tensor,
             rho1: float, rho2: float, kgamma: float, *,
             precision: str = "f32",
             block: Optional[int] = None) -> torch.Tensor:
    """d(q) = (s - rho1) * (rho2 - s), float64 (n,)."""
    s = raw_scores(q, t, gamma, kgamma, precision=precision, block=block)
    return (s - rho1) * (rho2 - s)
