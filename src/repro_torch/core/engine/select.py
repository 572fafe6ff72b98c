"""Selector — the working-set-selection axis of the engine.

A selector looks at the current ``SolverState`` and returns a ``Selection``
of 2P rows (grow half first, shrink half second) for the Gauss-Seidel pair
solve. Its ``criterion`` names the termination test the driver applies:
``"kkt"`` (paper Algorithm 1: stop when at most one violator) or
``"gap"`` (Keerthi MVP duality gap <= tol).

* ``PaperSelector`` — the paper's eq. 56 heuristic: b = argmax |f_bar|
  among KKT violators, a = argmax |f_bar(b) - f_bar(a)| among partners
  whose clipped step is nonzero (without the movability mask the
  iteration deadlocks on bound-blocked pairs).
* ``BlockSelector`` — top-P Keerthi working set: the P smallest scores
  that can grow x the P largest that can shrink (disjoint). P=1 is the
  classic maximal-violating pair.
* ``ShardedBlockSelector`` — BlockSelector over row-sharded ranks: every
  rank proposes its local top-P candidates; one all_gather of the packed
  candidate set (O(P d) per rank, independent of m) makes the global
  selection identical on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine.stats import slab_margin, violation
from repro_torch.core.engine.types import Selection, SolverState

Tensor = torch.Tensor
_TINY = 1e-12


def top_k_ids(v: Tensor, k: int) -> Tensor:
    """Indices of the k largest entries, lowest index first on ties — the
    order of ``jax.lax.top_k``, which ``torch.topk`` does not promise.
    Ties are common here: every ``-inf``-masked entry ties whenever fewer
    than k rows can move."""
    return torch.sort(v, descending=True, stable=True).indices[:k]


class PaperSelector:
    """One violating pair per iteration, the paper's eq. 56 heuristic.

    ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does,
    so ties (every entry ``-inf`` when nothing violates) resolve to the
    lowest index in both packages."""

    criterion = "kkt"

    def __init__(self, provider, *, hi: float, lo: float, m: int,
                 tol: float):
        self.provider = provider
        self.hi, self.lo, self.m, self.tol = hi, lo, m, tol

    def select(self, s: SolverState) -> Selection:
        hi, lo = self.hi, self.lo
        neg = torch.full((), -float("inf"), dtype=s.f.dtype,
                         device=s.f.device)
        tiny = torch.full((), _TINY, dtype=s.f.dtype, device=s.f.device)

        v = violation(s.gamma, s.f, s.rho1, s.rho2, hi=hi, lo=lo, m=self.m)
        fbar = slab_margin(s.f, s.rho1, s.rho2)
        b = torch.argmax(torch.where(v > self.tol, torch.abs(fbar), neg))

        # Candidate step size against every partner a (needs row b).
        kb = self.provider.column(b)
        diagK = self.provider.diag()
        eta_den = torch.maximum(diagK + diagK[b] - 2.0 * kb, tiny)
        t = s.gamma + s.gamma[b]
        L = torch.clamp_min(t - hi, lo)
        H = torch.clamp_max(t - lo, hi)
        gb_t = s.gamma[b] + (s.f - s.f[b]) / eta_den
        movable = torch.abs(torch.clamp(gb_t, L, H) - s.gamma[b]) > tiny * 10
        # b is no partner of itself (out of place, as ``.at[b].set``).
        gap_score = torch.where(movable, torch.abs(fbar[b] - fbar),
                                neg).index_fill(0, b.reshape(1), neg)
        a = torch.argmax(gap_score)

        ids = torch.stack([b, a])
        # kb is already paid for; add ka so the driver's rank-2 f update
        # reuses both columns instead of recomputing them.
        rows = torch.stack([kb, self.provider.column(a)], dim=1)
        return Selection(ids=ids, gamma=s.gamma[ids], f=s.f[ids],
                         X=self.provider.X[ids], rows=rows)


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


class ShardedBlockSelector:
    """Globally consistent block selection from per-rank candidates.

    ``comm`` is the facade's ``MeshComm`` over the data axes; the one
    per-iteration candidate gather goes through it, so an attached
    ``CollectiveLedger`` accounts its O(P d) payload. ``gids`` are this
    rank's global row ids, ``valid`` masks the pad rows.
    """

    criterion = "gap"

    def __init__(self, X_local: Tensor, *, P: int, hi: float, lo: float,
                 gids: Tensor, valid: Tensor, comm):
        self.X = X_local
        self.P = P
        self.hi, self.lo = hi, lo
        self.bnd = 1e-8 * (hi - lo)
        self.gids = gids
        self.valid = valid
        self.comm = comm
        self.axes = comm.axes

    def select(self, s: SolverState) -> Selection:
        P = self.P
        dtype = s.f.dtype
        neg = torch.full((), -float("inf"), dtype=dtype, device=s.f.device)
        up = self.valid & (s.gamma < self.hi - self.bnd)
        dn = self.valid & (s.gamma > self.lo + self.bnd)

        # Local candidates.
        up_v = torch.where(up, -s.f, neg)
        dn_v = torch.where(dn, s.f, neg)
        up_i, dn_i = top_k_ids(up_v, P), top_k_ids(dn_v, P)

        # Both sides packed into ONE matrix, so selection costs a single
        # all-gather (ids ride as f32: exact below 2^24 rows).
        def pack(idx, val):
            return torch.cat(
                [val[idx][:, None], self.gids[idx].to(dtype)[:, None],
                 s.gamma[idx][:, None], s.f[idx][:, None], self.X[idx]],
                dim=1)                           # (P, 4 + d)

        cand = torch.stack([pack(up_i, up_v), pack(dn_i, dn_v)])
        cand_g = self.comm.all_gather(cand, tiled=False)
        # (n_shards, 2, P, 4+d) -> per side (n_shards*P, 4+d), shard-major
        cg = cand_g.transpose(0, 1).reshape(2, -1, cand.shape[-1])
        uv, uid = cg[0, :, 0], cg[0, :, 1].to(torch.int64)
        ug, uf, uX = cg[0, :, 2], cg[0, :, 3], cg[0, :, 4:]
        dv, did = cg[1, :, 0], cg[1, :, 1].to(torch.int64)
        dg, df_, dX = cg[1, :, 2], cg[1, :, 3], cg[1, :, 4:]

        usel = top_k_ids(uv, P)                  # global top-P grows
        up_ids = uid[usel]
        # Exclude grow picks from shrink candidates (disjoint pairs).
        clash = (did[:, None] == up_ids[None, :]).any(dim=1)
        dsel = top_k_ids(torch.where(clash, neg, dv), P)

        return Selection(
            ids=torch.cat([up_ids, did[dsel]]),
            gamma=torch.cat([ug[usel], dg[dsel]]),
            f=torch.cat([uf[usel], df_[dsel]]),
            X=torch.cat([uX[usel], dX[dsel]]))


def make_selector(selection: str, provider, *, P: int, hi: float, lo: float,
                  m: int, tol: float):
    """Build a local selector by name ("sharded" is constructed explicitly
    by the distributed facade)."""
    if selection == "paper":
        return PaperSelector(provider, hi=hi, lo=lo, m=m, tol=tol)
    if selection == "mvp":
        return BlockSelector(provider, P=1, hi=hi, lo=lo)
    if selection == "block":
        return BlockSelector(provider, P=P, hi=hi, lo=lo)
    raise ValueError(f"unknown selection {selection!r}")
