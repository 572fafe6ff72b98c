"""The one SMO driver: Gauss-Seidel pair solve + the iteration loop.

Each iteration:

1. ``selector.select`` picks a 2P working set (grow half, shrink half),
2. ``gauss_seidel_pairs`` runs the paper's analytic 2-variable update
   (eq. 35-39) over the P pairs against the small (2P, 2P) Gram block,
   keeping the selected scores exact,
3. the provider folds the step back: a rank-2P f-cache update (the
   ``fupdate`` CUDA kernel under ``gram_mode="pallas"``) and a gamma
   scatter,
4. ``stats_fn`` re-estimates rho1/rho2 and the convergence diagnostics.

The JAX package runs this as a ``lax.while_loop`` on the device; here it
is a Python loop that reads the termination flags back once per
iteration. Every other scalar stays an f32 tensor on the solve's device.
Under the sharded solver every rank runs this loop on its slice of the
rows; the flags come from all-reduced statistics and the selection from
one all-gather, so every rank reads the same flags and the ranks stay in
lockstep.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.engine.types import Selection, SolverState

Tensor = torch.Tensor
_TINY = 1e-12

# stats_fn(gamma, f, rho1_prev, rho2_prev, recompute_rho)
#   -> (rho1, rho2, n_viol, max_viol, gap)
StatsFn = Callable[..., tuple]


def gauss_seidel_pairs(sel: Selection, Kblk: Tensor, dsl: Tensor, *,
                       hi: float, lo: float) -> Tensor:
    """Solve the P analytic 2-variable subproblems sequentially.

    Pair k couples slot k (grow side) with slot P+k (shrink side). Every
    step moves on the equality hyperplane and is clipped to the box, so
    feasibility is exact; the selected scores are updated against the
    (2P, 2P) block so each step sees the previous pairs' moves.
    Returns delta = gamma_sel_final - gamma_sel_0, shape (2P,).

    Pair k reads and writes only slots k and P+k, so each pair's gamma
    values, eta and clip box are the initial ones and are computed for
    all pairs at once; only the selected scores carry from pair to pair.
    The f32 operations and their order are the JAX package's.
    """
    P = sel.n_pairs
    g0, f_sel = sel.gamma, sel.f
    tiny = torch.full((), _TINY, dtype=f_sel.dtype, device=f_sel.device)
    ib = torch.arange(P, device=g0.device)
    ia = ib + P
    eta = 1.0 / torch.maximum(dsl[ia] + dsl[ib] - 2.0 * Kblk[ia, ib], tiny)
    t = g0[ia] + g0[ib]
    L = torch.clamp_min(t - hi, lo)
    H = torch.clamp_max(t - lo, hi)
    frozen = sel.ids[ia] == sel.ids[ib]     # duplicate ids from top-k ties
    step_cols = Kblk[:, ib] - Kblk[:, ia]   # (2P, P)
    zero = torch.zeros((), dtype=f_sel.dtype, device=f_sel.device)
    dgbs = []
    for k in range(P):
        gb = torch.clamp(g0[k] + eta[k] * (f_sel[P + k] - f_sel[k]),
                         L[k], H[k])
        dgb = torch.where(frozen[k], zero, gb - g0[k])
        f_sel = f_sel + dgb * step_cols[:, k]
        dgbs.append(dgb)
    dgb = torch.stack(dgbs)
    g_fin = g0 + torch.cat([dgb, -dgb])
    return g_fin - g0


def init_state(provider, stats_fn: StatsFn, gamma0: Tensor,
               f_offset: Optional[Tensor] = None, ledger=None,
               warm=None) -> SolverState:
    """Score the initial gamma and measure the starting diagnostics.

    f_offset: constant per-row score contribution from coordinates
    outside this problem. warm: optional warm start whose seeded f-cache
    ``provider.reconcile_scores`` turns into K @ gamma0 instead of the
    O(m^2) init pass (the local slice under the sharded provider).
    ledger: optional ``CollectiveLedger``; everything here is one-time
    work, tagged phase="init".
    """
    if ledger is not None:
        ledger.set_phase("init")
    if warm is not None:
        f = provider.reconcile_scores(warm)
    else:
        f = provider.init_scores(gamma0)
    if f_offset is not None:
        f = f + f_offset.to(f.dtype)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    izero = torch.zeros((), dtype=torch.int32, device=f.device)
    # Two passes: the first recovers rho, the second measures diagnostics
    # against it.
    rho1, rho2, _, _, _ = stats_fn(gamma0, f, zero, zero, True)
    rho1, rho2, n_viol, max_viol, gap = stats_fn(gamma0, f, rho1, rho2, True)
    return SolverState(gamma0, f, rho1, rho2, izero, n_viol, max_viol, gap,
                       izero)


def _unconverged(s: SolverState, criterion: str, tol: float) -> Tensor:
    if criterion == "kkt":
        return (s.n_viol > 1) & (s.max_viol > tol)
    return s.gap > tol


def run(provider, selector, stats_fn: StatsFn, state0: SolverState, *,
        hi: float, lo: float, tol: float, max_iters: int, patience: int,
        rho_every: int = 1, ledger=None) -> SolverState:
    """Iterate select -> pair-solve -> rank-2P update until converged.

    Termination (selector.criterion):
      "kkt" — at most one KKT violator (or a uniformly small max
              violation);
      "gap" — Keerthi MVP duality gap <= tol.
    Both additionally stop at max_iters or after ``patience`` consecutive
    zero-progress steps (bound-blocked working sets).

    ledger: optional ``CollectiveLedger``. The first iteration's
    collectives are tagged phase="iter" — the per-iteration bill, as the
    JAX package records its loop body once at trace time — and later
    iterations are not recorded.
    """
    if ledger is not None:
        ledger.set_phase("iter")
    criterion = selector.criterion
    s = state0
    tiny10 = torch.full((), _TINY, dtype=s.f.dtype, device=s.f.device) * 10
    it, stall = int(s.it), int(s.stall)
    unconverged = bool(_unconverged(s, criterion, tol))
    while it < max_iters and unconverged and stall < patience:
        sel = provider.prepare(selector.select(s))
        Kblk = provider.block(sel)
        dsl = provider.diag_sel(sel)
        delta = gauss_seidel_pairs(sel, Kblk, dsl, hi=hi, lo=lo)

        gamma_new = provider.scatter(s.gamma, sel, delta)
        f_new = provider.apply_update(s.f, sel, delta)

        recompute = rho_every == 1 or (it + 1) % rho_every == 0
        r1, r2, n_viol, max_viol, gap = stats_fn(
            gamma_new, f_new, s.rho1, s.rho2, recompute)
        s = s._replace(gamma=gamma_new, f=f_new, rho1=r1, rho2=r2,
                       n_viol=n_viol, max_viol=max_viol, gap=gap)

        # The one host read of the iteration: both loop flags together.
        progressed = torch.max(torch.abs(delta)) > tiny10
        unconverged, progressed = torch.stack(
            [_unconverged(s, criterion, tol), progressed]).tolist()
        it += 1
        stall = 0 if progressed else stall + 1
        if ledger is not None:
            ledger.set_phase(None)      # one iteration's bill is enough
    dev = s.f.device
    return s._replace(it=torch.tensor(it, dtype=torch.int32, device=dev),
                      stall=torch.tensor(stall, dtype=torch.int32,
                                         device=dev))


def has_converged(s: SolverState, criterion: str, tol: float) -> Tensor:
    if criterion == "kkt":
        return (s.n_viol <= 1) | (s.max_viol <= tol)
    return s.gap <= tol
