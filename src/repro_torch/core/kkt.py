"""KKT optimality conditions for the reduced OCSSVM dual (paper eq. 49-53).

The five gamma-space cases, written as per-plane distance violations so all
magnitudes share the raw-score scale:

    gamma_i = 0          -> rho1 <= s_i <= rho2      (strict interior)
    0 < gamma_i < hi     -> s_i = rho1               (on lower plane)
    gamma_i = hi         -> s_i <= rho1              (below lower plane)
    lo < gamma_i < 0     -> s_i = rho2               (on upper plane)
    gamma_i = lo         -> s_i >= rho2              (above upper plane)

``violation(...)`` returns a non-negative per-sample violation magnitude;
the paper's Algorithm 1 stops when at most one sample violates beyond
``tol``. The implementation lives in ``repro_torch.core.engine.stats``;
this module keeps the spec-based view.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine.stats import slab_margin
from repro_torch.core.engine.stats import violation as _violation
from repro_torch.core.ocssvm import SlabSpec

Tensor = torch.Tensor

__all__ = ["slab_margin", "violation", "n_violators", "converged"]


def violation(gamma: Tensor, scores: Tensor, rho1: Tensor, rho2: Tensor,
              spec: SlabSpec, bound_tol: float = 1e-8) -> Tensor:
    """Per-sample KKT violation magnitude (>= 0)."""
    m = gamma.shape[0]
    return _violation(gamma, scores, rho1, rho2, hi=spec.upper(m),
                      lo=spec.lower(m), m=m, bound_tol=bound_tol)


def n_violators(v: Tensor, tol: float) -> Tensor:
    return torch.sum(v > tol)


def converged(v: Tensor, tol: float) -> Tensor:
    """Paper termination: at most one variable violates KKT."""
    return n_violators(v, tol) <= 1
