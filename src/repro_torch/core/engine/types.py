"""Shared state and selection tuples for the solver engine."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class SolverState(NamedTuple):
    """The one carried state of the SMO loop. Scalars are 0-d tensors on
    the solve's device."""

    gamma: Tensor     # (m,) dual coefficients
    f: Tensor         # (m,) raw-score cache K @ gamma
    rho1: Tensor      # lower-plane offset (eq. 20)
    rho2: Tensor      # upper-plane offset (eq. 21)
    it: Tensor        # int32 iteration counter
    n_viol: Tensor    # int32 current KKT violator count
    max_viol: Tensor  # float max KKT violation
    gap: Tensor       # float MVP duality gap: max f|down - min f|up
    stall: Tensor     # int32 consecutive no-progress steps


class Selection(NamedTuple):
    """A working set of 2P rows: the grow half [0:P], the shrink half [P:2P].

    ``gamma``/``f``/``X`` are the gathered per-row values, so providers can
    evaluate kernel rows without re-indexing.
    """

    ids: Tensor       # (2P,) int64 row ids
    gamma: Tensor     # (2P,) current dual values
    f: Tensor         # (2P,) current scores
    X: Tensor         # (2P, d) selected data rows
    # Optional (m, 2P) kernel columns a selector already computed;
    # providers reuse them instead of recomputing.
    rows: Optional[Tensor] = None

    @property
    def n_pairs(self) -> int:
        return self.ids.shape[0] // 2


class SMOResult(NamedTuple):
    """Public result type shared by every solver facade."""

    model: "object"   # OCSSVMModel (kept loose to avoid an import cycle)
    iters: Tensor
    n_viol: Tensor
    max_viol: Tensor
    gap: Tensor
    converged: Tensor
    # Final f-cache K @ gamma over the full training set.
    f: Optional[Tensor] = None
