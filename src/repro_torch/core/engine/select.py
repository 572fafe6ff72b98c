"""Selector — the working-set-selection axis of the engine.

A selector looks at the current ``SolverState`` and returns a ``Selection``
of 2P rows (grow half first, shrink half second) for the Gauss-Seidel pair
solve. Its ``criterion`` names the termination test the driver applies
(``"gap"``: Keerthi MVP duality gap <= tol).

* ``BlockSelector`` — top-P Keerthi working set: the P smallest scores
  that can grow x the P largest that can shrink (disjoint). P=1 is the
  classic maximal-violating pair.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine.types import Selection, SolverState

Tensor = torch.Tensor


def top_k_ids(v: Tensor, k: int) -> Tensor:
    """Indices of the k largest entries, lowest index first on ties — the
    order of ``jax.lax.top_k``, which ``torch.topk`` does not promise.
    Ties are common here: every ``-inf``-masked entry ties whenever fewer
    than k rows can move."""
    return torch.sort(v, descending=True, stable=True).indices[:k]


class BlockSelector:
    """Top-P maximal-violating pairs in one vectorized sweep (P=1 == MVP)."""

    criterion = "gap"

    def __init__(self, provider, *, P: int, hi: float, lo: float):
        self.provider = provider
        self.P = P
        self.hi, self.lo = hi, lo
        self.bnd = 1e-8 * (hi - lo)

    def select(self, s: SolverState) -> Selection:
        neg = torch.full((), -float("inf"), dtype=s.f.dtype,
                         device=s.f.device)
        up = s.gamma < self.hi - self.bnd
        dn = s.gamma > self.lo + self.bnd
        # P "grow" coordinates: smallest scores among movable-up.
        up_idx = top_k_ids(torch.where(up, -s.f, neg), self.P)
        # P "shrink" coordinates: largest scores among movable-down,
        # excluding the grow set (disjointness).
        dn_score = torch.where(dn, s.f, neg).index_fill(0, up_idx, neg)
        dn_idx = top_k_ids(dn_score, self.P)
        ids = torch.cat([up_idx, dn_idx])
        return Selection(ids=ids, gamma=s.gamma[ids], f=s.f[ids],
                         X=self.provider.X[ids])
