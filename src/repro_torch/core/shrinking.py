"""LIBSVM-style shrinking as a repack driver.

Classic shrinking skips bound-pinned coordinates inside the solver loop.
Every vector op of the engine is full-m regardless of masks, so masking
saves nothing — instead this driver PHYSICALLY repacks the active set:

1. run the blocked solver a bounded number of iterations on the full set,
2. freeze coordinates at a bound whose score keeps them there with margin
   (they cannot be part of any violating pair),
3. gather the active coordinates (size rounded up to a bucket), fold the
   frozen coordinates' kernel contribution into a per-row ``f_offset``,
   and solve the small problem exactly (box bounds rescaled:
   nu' = nu * m_total / m_active keeps 1/(nu1' m_active) ==
   1/(nu1 m_total)),
4. scatter back, verify KKT on the FULL set, repeat if anything at a
   bound woke up (the classic unshrink pass).

Per-iteration work in step 3 is O(m_active * d) instead of O(m * d). The
reached optimum is the full-problem optimum (the final full-set KKT check
gates termination).

Every inner solve routes through ``solve_blocked``, so
``gram_mode="pallas"`` drives the ``fupdate`` kernel inside the rounds
too: the narrow class on every iteration, the wide class for an inner
init pass over a bucket of at most ``BLOCK`` rows. The full-set sweeps
between rounds are plain row-blocked products (``raw_scores_blocked``),
as in the JAX package. The freeze decision and the active order are read
to the host with the reference's numpy order, so the same rows form the
bucket.

``solve_sharded_shrinking`` is the row-sharded composition of the same
idea: bounded distributed rounds (``solve_blocked_distributed``, the
per-rank ``fupdate`` on the hot loop), per-rank freeze masks (one pmax
gives every rank the global movable-score extrema), and — once the
global active set fits under ``SINGLE_PASS_MAX`` — the LOCAL blocked
solver on the repacked active rows, run on one rank (every rank holds
the global rows) and its gamma broadcast, with the frozen rows' kernel
contribution riding along as ``f_offset``. The full-set KKT sweeps
between rounds run sharded (``sharded_raw_scores``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batched_smo import solve_blocked
from repro_torch.core.engine import CollectiveLedger, MeshComm
from repro_torch.core.engine.gram import SINGLE_PASS_MAX, raw_scores_blocked
from repro_torch.core.engine.stats import violation as _violation
from repro_torch.core.engine.types import SMOResult
from repro_torch.core.ocssvm import (OCSSVMModel, SlabSpec, concrete_spec,
                                     recover_rhos)
from repro_torch.kernels.precision import round_to_tile

Tensor = torch.Tensor

__all__ = ["solve_blocked_shrinking", "solve_sharded_shrinking"]


def _bucket(n: int, m: int) -> int:
    """Round n up to a power of two of at least 64 (at most m)."""
    if n >= m:
        return m
    b = 1 << max(6, math.ceil(math.log2(max(n, 1))))
    return min(b, m)


def _full_set_result(gamma: Tensor, f: Tensor, X32: Tensor, spec: SlabSpec,
                     *, tol: float, total_iters: int) -> SMOResult:
    """The final full-set KKT verification both drivers end with."""
    m = X32.shape[0]
    hi, lo = spec.upper(m), spec.lower(m)
    bnd = 1e-8 * (hi - lo)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=f.device)
    rho1, rho2 = recover_rhos(gamma, f, spec)
    v = _violation(gamma, f, rho1, rho2, hi=hi, lo=lo, m=m)
    up_ok = gamma < hi - bnd
    dn_ok = gamma > lo + bnd
    gap = (torch.max(torch.where(dn_ok, f, -inf))
           - torch.min(torch.where(up_ok, f, inf)))
    n_viol = torch.sum(v > tol).to(torch.int32)
    model = OCSSVMModel(gamma=gamma, rho1=rho1, rho2=rho2, X=X32, spec=spec)
    return SMOResult(model=model,
                     iters=torch.tensor(total_iters, dtype=torch.int32,
                                        device=f.device),
                     n_viol=n_viol, max_viol=torch.max(v), gap=gap,
                     converged=n_viol <= 1, f=f)


def _repack(Xf: Tensor, gamma: Tensor, f: Tensor, active: np.ndarray,
            spec: SlabSpec):
    """(idx, X_act, g_act, f_offset, sub_spec) of the bucketed active set:
    the least-frozen rows wake to fill the bucket, and the frozen rows'
    kernel contribution to the active scores rides as ``f_offset``."""
    m = Xf.shape[0]
    kernel = spec.kernel
    n_b = _bucket(int(active.sum()), m)
    order = np.argsort(~active, kind="stable")     # active first
    idx = torch.as_tensor(np.sort(order[:n_b]), device=Xf.device)
    X_act = Xf[idx]
    g_act = gamma[idx]
    k_act = (kernel.cross(X_act, X_act) @ g_act
             if n_b <= SINGLE_PASS_MAX
             else raw_scores_blocked(X_act, g_act, kernel))
    sub_spec = dataclasses.replace(
        spec, nu1=spec.nu1 * m / n_b, nu2=spec.nu2 * m / n_b)
    return idx, X_act, g_act, f[idx] - k_act, sub_spec


def solve_blocked_shrinking(
    X: Tensor,
    spec: SlabSpec,
    *,
    P: int = 8,
    gram_mode: str = "on_the_fly",
    precision: str = "f32",
    tol: float = 1e-4,
    warm_iters: int = 200,
    max_rounds: int = 8,
    round_iters: int = 50_000,
    margin: float = 2.0,
    max_outer: Optional[int] = None,
    patience: int = 20,
    gamma0: Optional[Tensor] = None,
    warm=None,
) -> SMOResult:
    """Solve on the device X lies on. max_outer caps the per-round
    iteration budget (alias of round_iters, so the blocked solvers'
    signature works here too); gamma0 seeds the phase-1 full-set solve.
    ``warm`` (an ``engine.WarmStart``) seeds gamma AND reconciles the
    phase-1 f-cache from the prior fit's scores with one fused rank-s
    sweep; later rounds proceed from wherever phase 1 lands."""
    if max_outer is not None:
        round_iters = min(round_iters, max_outer)
    spec = concrete_spec(spec)
    m = X.shape[0]
    X32 = X.to(torch.float32)
    # Tile-round once up front: the driver's own KKT sweeps and f_offset
    # folds see exactly the rows the inner low-precision solves see. The
    # RETURNED model still carries the unrounded X32.
    Xf = round_to_tile(X32, precision)
    kernel = spec.kernel
    hi, lo = spec.upper(m), spec.lower(m)
    bnd = 1e-8 * (hi - lo)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=X.device)

    def _solve(Xs, sp, **kw):
        return solve_blocked(Xs, sp, P=P, gram_mode=gram_mode,
                             precision=precision, tol=tol, patience=patience,
                             **kw)

    # Phase 1: bounded full-set warm solve.
    res = _solve(Xf, spec, max_outer=warm_iters, gamma0=gamma0, warm=warm)
    gamma = res.model.gamma
    if bool(res.converged):
        # The caller's rows, as every other return (the JAX package
        # returns the tile-rounded rows here; ROADMAP C).
        return res._replace(model=res.model._replace(X=X32))

    total_iters = int(res.iters)
    for _ in range(max_rounds):
        f = raw_scores_blocked(Xf, gamma, kernel)
        rho1, rho2 = recover_rhos(gamma, f, spec)
        v = _violation(gamma, f, rho1, rho2, hi=hi, lo=lo, m=m)
        if int(torch.sum(v > tol)) <= 1:
            break

        # Freeze coordinates pinned at a bound with margin: at hi the KKT
        # wants f <= lambda; it can never pair as the "down" end of a
        # violating pair if f is below every movable-up score by margin.
        up_ok = gamma < hi - bnd
        dn_ok = gamma > lo + bnd
        m_up = torch.min(torch.where(up_ok, f, inf))
        m_dn = torch.max(torch.where(dn_ok, f, -inf))
        frozen_hi = (~up_ok) & (f < m_up - margin * tol)
        frozen_lo = (~dn_ok) & (f > m_dn + margin * tol)
        frozen_zero = (torch.abs(gamma) < bnd) & (v <= tol * 0.5)
        frozen = (frozen_hi | frozen_lo | frozen_zero) & (v <= tol)

        active = (~frozen).cpu().numpy()
        n_active = int(active.sum())
        if n_active >= int(0.9 * m) or n_active < 4 * P:
            # shrinking not profitable: finish on the full set
            res = _solve(Xf, spec, max_outer=round_iters, gamma0=gamma)
            gamma = res.model.gamma
            total_iters += int(res.iters)
            break

        idx, X_act, g_act, f_offset, sub_spec = _repack(Xf, gamma, f,
                                                        active, spec)
        sub = _solve(X_act, sub_spec, max_outer=round_iters, gamma0=g_act,
                     f_offset=f_offset)
        gamma = gamma.index_copy(0, idx, sub.model.gamma)
        total_iters += int(sub.iters)

    return _full_set_result(gamma, raw_scores_blocked(Xf, gamma, kernel), X32,
                            spec, tol=tol, total_iters=total_iters)


def _sharded_freeze_mask(gamma: Tensor, f: Tensor, v: Tensor, mesh,
                         data_axes: Tuple[str, ...], *, hi: float,
                         lo: float, tol: float, margin: float, m: int,
                         ledger: Optional[CollectiveLedger] = None
                         ) -> Tensor:
    """The freeze decision of ``solve_blocked_shrinking``, taken per rank:
    each rank classifies ITS rows from its local gamma/f/v slices; the
    only cross-rank facts needed are the two global movable-score
    extrema, which cost one pmax (billed to the ledger's "sweep" phase).
    Returns the global frozen mask on every rank."""
    from repro_torch.core.distributed_smo import (_pad_rows, _shard_geometry,
                                                  gather_rows)

    bnd = 1e-8 * (hi - lo)
    sizes, _, m_pad, m_local = _shard_geometry(m, mesh, data_axes)
    rank = mesh.axis_rank(data_axes)
    rows = slice(rank * m_local, (rank + 1) * m_local)
    g_l, f_l, v_l = (_pad_rows(t.to(torch.float32), m_pad)[rows]
                     for t in (gamma, f, v))
    valid_l = (torch.arange(m_pad, device=f.device) < m)[rows]
    if ledger is not None:
        ledger.set_phase("sweep")
    comm = MeshComm(data_axes, sizes=sizes, ledger=ledger, mesh=mesh)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=f.device)
    up_ok = valid_l & (g_l < hi - bnd)
    dn_ok = valid_l & (g_l > lo + bnd)
    # One pmax of [-(min movable-up f), max movable-down f]: the min rides
    # negated, as in the fused solver stats.
    pm = comm.pmax(torch.stack([
        -torch.min(torch.where(up_ok, f_l, inf)),
        torch.max(torch.where(dn_ok, f_l, -inf)),
    ]))
    m_up, m_dn = -pm[0], pm[1]
    frozen_hi = (~up_ok) & (f_l < m_up - margin * tol)
    frozen_lo = (~dn_ok) & (f_l > m_dn + margin * tol)
    frozen_zero = (torch.abs(g_l) < bnd) & (v_l <= tol * 0.5)
    frozen = (frozen_hi | frozen_lo | frozen_zero) & (v_l <= tol)
    return gather_rows(mesh, data_axes, frozen | ~valid_l, m=m)[0]


def solve_sharded_shrinking(
    X: Tensor,
    spec: SlabSpec,
    mesh,
    *,
    data_axes: Tuple[str, ...] = ("data",),
    P_pairs: int = 8,
    gram_mode: str = "on_the_fly",
    precision: str = "f32",
    tol: float = 1e-4,
    warm_iters: int = 200,
    max_rounds: int = 8,
    round_iters: int = 50_000,
    margin: float = 2.0,
    max_outer: Optional[int] = None,
    patience: int = 20,
    gamma0: Optional[Tensor] = None,
    warm=None,
    gather_max: Optional[int] = None,
    rho_every: int = 1,
    ledger: Optional[CollectiveLedger] = None,
    device=None,
) -> SMOResult:
    """Shrinking repack driver for a ROW-SHARDED problem; every rank of
    ``mesh`` calls it with the same arguments and gets the same result.

    Rounds alternate between bounded distributed solves on the mesh and —
    as soon as the global active set fits under ``gather_max`` (default
    ``SINGLE_PASS_MAX``) — a LOCAL blocked solve of the repacked active
    rows (``gram_mode`` picks its provider; the distributed rounds always
    run the per-rank ``fupdate``). That solve runs on the data group's
    first rank and its gamma (and iteration count) is broadcast. The
    full-set KKT sweeps between rounds are sharded.

    ``ledger`` threads through every distributed solve and sharded sweep.
    Returns the caller's rows in the model on both returns (ROADMAP C.5).
    """
    from repro_torch.core.distributed_smo import (sharded_raw_scores,
                                                  solve_blocked_distributed)

    if max_outer is not None:
        round_iters = min(round_iters, max_outer)
    if gather_max is None:
        gather_max = SINGLE_PASS_MAX
    spec = concrete_spec(spec)
    dev = X.device if device is None else torch.device(device)
    X32 = X.to(device=dev, dtype=torch.float32)
    m = X32.shape[0]
    # The repack sweeps and f_offset folds see exactly the tile-rounded
    # rows the solves see.
    Xf = round_to_tile(X32, precision)
    kernel = spec.kernel
    hi, lo = spec.upper(m), spec.lower(m)

    def _dist(g0, iters, w=None):
        return solve_blocked_distributed(
            X32, spec, mesh, data_axes=data_axes, P_pairs=P_pairs, tol=tol,
            max_outer=iters, patience=patience, precision=precision,
            gamma0=g0, rho_every=rho_every, ledger=ledger, warm=w)

    def _scores(g):
        return sharded_raw_scores(Xf, g, kernel, mesh, data_axes=data_axes,
                                  precision=precision, ledger=ledger)

    # Phase 1: bounded full-set distributed warm solve.
    res = _dist(gamma0, warm_iters, warm)
    gamma = res.model.gamma
    if bool(res.converged):
        return res._replace(model=res.model._replace(X=X32))

    total_iters = int(res.iters)
    for _ in range(max_rounds):
        f = _scores(gamma)
        rho1, rho2 = recover_rhos(gamma, f, spec)
        v = _violation(gamma, f, rho1, rho2, hi=hi, lo=lo, m=m)
        if int(torch.sum(v > tol)) <= 1:
            break

        frozen = _sharded_freeze_mask(gamma, f, v, mesh, data_axes, hi=hi,
                                      lo=lo, tol=tol, margin=margin, m=m,
                                      ledger=ledger)
        active = (~frozen).cpu().numpy()
        n_active = int(active.sum())
        if n_active >= int(0.9 * m) or n_active < 4 * P_pairs:
            # Shrinking not profitable: finish distributed on the full set.
            res = _dist(gamma, round_iters)
            gamma = res.model.gamma
            total_iters += int(res.iters)
            break

        if n_active > gather_max:
            # Active set still at sharded scale: another bounded
            # distributed round, warm-started, then re-sweep.
            res = _dist(gamma, round_iters)
            gamma = res.model.gamma
            total_iters += int(res.iters)
            continue

        # The active set fits one rank: repack it and solve it locally on
        # the group's first rank; the others take its gamma and iteration
        # count from one broadcast.
        idx, X_act, g_act, f_offset, sub_spec = _repack(Xf, gamma, f,
                                                        active, spec)
        comm = MeshComm(data_axes, ledger=ledger, mesh=mesh)
        if mesh.axis_rank(data_axes) == 0:
            sub = solve_blocked(X_act, sub_spec, P=P_pairs,
                                gram_mode=gram_mode, precision=precision,
                                tol=tol, max_outer=round_iters, gamma0=g_act,
                                f_offset=f_offset, patience=patience)
            out = torch.cat([sub.model.gamma,
                             sub.iters.to(torch.float32).reshape(1)])
        else:
            out = torch.empty((idx.shape[0] + 1,), dtype=torch.float32,
                              device=dev)
        out = comm.broadcast(out)
        gamma = gamma.index_copy(0, idx, out[:-1])
        total_iters += int(out[-1])

    # Final full-set verification, sharded.
    return _full_set_result(gamma, _scores(gamma), X32, spec, tol=tol,
                            total_iters=total_iters)
