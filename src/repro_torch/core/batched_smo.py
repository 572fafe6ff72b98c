"""Blocked SMO — the engine facade the ``"blocked"`` and ``"pallas"``
strategies run.

Each outer step selects ``P`` disjoint maximal-violating pairs in one
vectorized sweep, runs Gauss-Seidel over the P analytic 2-variable
subproblems against the small (2P x 2P) Gram block, and applies ONE
rank-2P f-cache update f += K(X, X_sel) @ delta. With
``gram_mode="pallas"`` that update is the ``fupdate`` CUDA kernel: one
pass over X per iteration.

Feasibility is exact: every pair moves on the equality hyperplane and is
clipped to the box.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core.engine.types import SMOResult
from repro_torch.core.ocssvm import (OCSSVMModel, SlabSpec, concrete_spec,
                                     feasible_init)

Tensor = torch.Tensor

__all__ = ["solve_blocked"]


def solve_blocked(
    X: Tensor,
    spec: SlabSpec,
    *,
    P: int = 8,
    gram_mode: str = "on_the_fly",
    precision: str = "f32",
    tol: float = 1e-4,
    max_outer: int = 50_000,
    patience: int = 20,
    gamma0: Optional[Tensor] = None,
    f_offset: Optional[Tensor] = None,
    warm=None,
) -> SMOResult:
    """Solve on the device X lies on.

    f_offset: constant per-row score contribution from coordinates
    outside this problem. warm: optional warm start (``gamma0``,
    ``f_seed``, ``x_corr``, ``delta``) — seeds gamma and reconciles the
    f-cache with one rank-s sweep instead of the O(m^2) init pass;
    mutually exclusive with ``gamma0``. ``precision`` is the Gram
    tile-input dtype (``repro_torch.kernels.precision``).
    """
    if warm is not None and gamma0 is not None:
        raise ValueError("pass warm= or gamma0=, not both")
    spec = concrete_spec(spec)
    m = X.shape[0]
    Xf = X.to(torch.float32)
    hi, lo = spec.upper(m), spec.lower(m)

    if warm is not None:
        gamma = warm.gamma0.to(torch.float32)
    elif gamma0 is None:
        gamma = feasible_init(m, spec, torch.float32, device=X.device)
    else:
        gamma = gamma0.to(torch.float32)

    provider = engine.make_provider(gram_mode, Xf, spec.kernel,
                                    precision=precision)
    selector = engine.BlockSelector(provider, P=P, hi=hi, lo=lo)
    stats_fn = partial(engine.solver_stats_fresh, hi=hi, lo=lo, m=m, tol=tol)

    state0 = engine.init_state(provider, stats_fn, gamma, f_offset=f_offset,
                               warm=warm)
    s = engine.run(provider, selector, stats_fn, state0, hi=hi, lo=lo,
                   tol=tol, max_iters=max_outer, patience=patience)

    model = OCSSVMModel(gamma=s.gamma, rho1=s.rho1, rho2=s.rho2, X=Xf,
                        spec=spec)
    # Report f WITHOUT the external offset: K @ gamma over these rows.
    f_out = s.f if f_offset is None else s.f - f_offset.to(s.f.dtype)
    return SMOResult(model=model, iters=s.it, n_viol=s.n_viol,
                     max_viol=s.max_viol, gap=s.gap,
                     converged=s.gap <= tol, f=f_out)
