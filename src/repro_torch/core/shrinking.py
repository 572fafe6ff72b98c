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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.batched_smo import solve_blocked
from repro_torch.core.engine.gram import SINGLE_PASS_MAX, raw_scores_blocked
from repro_torch.core.engine.stats import violation as _violation
from repro_torch.core.engine.types import SMOResult
from repro_torch.core.ocssvm import (OCSSVMModel, SlabSpec, concrete_spec,
                                     recover_rhos)
from repro_torch.kernels.precision import round_to_tile

Tensor = torch.Tensor

__all__ = ["solve_blocked_shrinking"]


def _bucket(n: int, m: int) -> int:
    """Round n up to a power of two of at least 64 (at most m)."""
    if n >= m:
        return m
    b = 1 << max(6, math.ceil(math.log2(max(n, 1))))
    return min(b, m)


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

        # Bucket the active size by waking the least-frozen coordinates.
        n_b = _bucket(n_active, m)
        order = np.argsort(~active, kind="stable")     # active first
        idx = torch.as_tensor(np.sort(order[:n_b]), device=X.device)

        X_act = Xf[idx]
        g_act = gamma[idx]
        # Frozen contribution to the active rows' scores:
        k_act = (kernel.cross(X_act, X_act) @ g_act
                 if n_b <= SINGLE_PASS_MAX
                 else raw_scores_blocked(X_act, g_act, kernel))
        f_offset = f[idx] - k_act

        sub_spec = dataclasses.replace(
            spec, nu1=spec.nu1 * m / n_b, nu2=spec.nu2 * m / n_b)
        sub = _solve(X_act, sub_spec, max_outer=round_iters, gamma0=g_act,
                     f_offset=f_offset)
        gamma = gamma.index_copy(0, idx, sub.model.gamma)
        total_iters += int(sub.iters)

    f = raw_scores_blocked(Xf, gamma, kernel)
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
                                        device=X.device),
                     n_viol=n_viol, max_viol=torch.max(v), gap=gap,
                     converged=n_viol <= 1, f=f)
