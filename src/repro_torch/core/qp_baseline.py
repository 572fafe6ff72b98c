"""Generic QP baselines the paper compares SMO against.

Two solvers for  min 1/2 gamma^T K gamma  s.t.  lo <= gamma <= hi,
sum(gamma) = 1 - eps:

* FISTA — accelerated projected gradient with the exact Euclidean
  projection onto {box ∩ hyperplane} (bisection on the shift
  multiplier); Lipschitz constant from power iteration on K. This stands
  in for the "traditional QP solver" of the paper's timing comparison.
* PGD (``accelerate=False``) — plain projected gradient, for ablation.

Both are O(m^2) per iteration (a full K gamma matvec) against SMO's O(m):
the scaling gap of the paper's Table 1. The JAX package runs the loop as
one ``lax.while_loop``; here it is a Python loop of device operations
with one host read per iteration (the termination test), and the
bisection's 64 steps and the power iteration's 30 are device operations
too, in the reference's f32 arithmetic.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.ocssvm import SlabSpec, concrete_spec, feasible_init

Tensor = torch.Tensor


def project_box_hyperplane(v: Tensor, lo: float, hi: float, total: float,
                           iters: int = 64) -> Tensor:
    """Euclidean projection of v onto {lo <= x <= hi, sum(x) = total}.

    Solves sum(clip(v - lam, lo, hi)) = total by bisection (monotone in
    lam).
    """
    a = torch.min(v) - hi
    b = torch.max(v) - lo
    for _ in range(iters):
        mid = 0.5 * (a + b)
        too_big = torch.sum(torch.clamp(v - mid, lo, hi)) > total
        a, b = torch.where(too_big, mid, a), torch.where(too_big, b, mid)
    return torch.clamp(v - 0.5 * (a + b), lo, hi)


def _power_iteration(K: Tensor, iters: int = 30) -> Tensor:
    m = K.shape[0]
    u = torch.ones((m,), dtype=K.dtype, device=K.device) / math.sqrt(m)
    for _ in range(iters):
        w = K @ u
        u = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
    return torch.clamp_min(u @ (K @ u), 1e-12)


class QPResult(NamedTuple):
    gamma: Tensor
    objective: Tensor
    iters: Tensor


def solve_qp(X: Tensor, spec: SlabSpec, *, max_iters: int = 5000,
             tol: float = 1e-8, accelerate: bool = True) -> QPResult:
    """FISTA / PGD on the reduced dual with a precomputed Gram matrix, on
    the device X lies on."""
    spec = concrete_spec(spec)
    m = X.shape[0]
    Xf = X.to(torch.float32)
    K = spec.kernel.gram(Xf)
    lo, hi, total = spec.lower(m), spec.upper(m), spec.total()
    step = 1.0 / _power_iteration(K)

    g = feasible_init(m, spec, device=Xf.device)
    y = g
    t = torch.ones((), dtype=torch.float32, device=Xf.device)
    it = 0
    delta = math.inf
    while it < max_iters and delta > tol:
        g_new = project_box_hyperplane(y - step * (K @ y), lo, hi, total)
        if accelerate:
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            y = g_new + ((t - 1.0) / t_new) * (g_new - g)
            t = t_new
        else:
            y = g_new
        delta = float(torch.max(torch.abs(g_new - g)))
        g = g_new
        it += 1
    return QPResult(gamma=g, objective=0.5 * (g @ (K @ g)),
                    iters=torch.tensor(it, dtype=torch.int32,
                                       device=Xf.device))
