"""Rho recovery + KKT diagnostics + MVP gap, written once for every solver.

All statistics are local masked reductions followed by a combine through
a ``Comm`` object. Only ``LocalComm`` (one device: the combine is the
identity) exists so far.

``solver_stats_fresh`` recovers rho first, then measures violations
against the fresh rho (the paper recomputes each step).

``hi``/``lo``/``m`` are the box bounds and problem size. Every scalar
stays an f32 (or int32) tensor on the solve's device: the arithmetic is
the reference's f32 arithmetic, never Python doubles.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


class LocalComm:
    """Single-device combine: reductions are already global."""

    axes: Tuple[str, ...] = ()

    def psum(self, x: Tensor) -> Tensor:
        return x

    def pmax(self, x: Tensor) -> Tensor:
        return x


LOCAL_COMM = LocalComm()


def _f32(v, like: Tensor) -> Tensor:
    # torch.full, not torch.tensor: a fill launches on the device instead
    # of copying from the host and waiting for it.
    return torch.full((), v, dtype=like.dtype, device=like.device)


def slab_margin(scores: Tensor, rho1: Tensor, rho2: Tensor) -> Tensor:
    """f_bar(x) = min(s - rho1, rho2 - s) (paper eq. 56)."""
    return torch.minimum(scores - rho1, rho2 - scores)


def violation(gamma: Tensor, scores: Tensor, rho1: Tensor, rho2: Tensor, *,
              hi: float, lo: float, m: int,
              valid: Optional[Tensor] = None,
              bound_tol: float = 1e-8) -> Tensor:
    """Per-sample KKT violation magnitude (>= 0), the paper's 5 cases
    (eq. 49-53) phrased as per-plane score distances:

        gamma_i = 0          -> rho1 <= s_i <= rho2
        0 < gamma_i < hi     -> s_i = rho1
        gamma_i = hi         -> s_i <= rho1
        lo < gamma_i < 0     -> s_i = rho2
        gamma_i = lo         -> s_i >= rho2
    """
    bt_hi = hi * bound_tol * m
    bt_lo = -lo * bound_tol * m

    at_zero = torch.abs(gamma) <= min(bt_hi, bt_lo)
    at_hi = gamma >= hi - bt_hi
    at_lo = gamma <= lo + bt_lo
    free_pos = (~at_zero) & (~at_hi) & (gamma > 0)
    free_neg = (~at_zero) & (~at_lo) & (gamma < 0)

    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    v = torch.where(
        at_zero,
        torch.clamp_min(torch.maximum(rho1 - scores, scores - rho2), 0.0),
        zero)
    v = torch.where(free_pos, torch.abs(scores - rho1), v)
    v = torch.where(at_hi, torch.clamp_min(scores - rho1, 0.0), v)
    v = torch.where(free_neg, torch.abs(scores - rho2), v)
    v = torch.where(at_lo, torch.clamp_min(rho2 - scores, 0.0), v)
    if valid is not None:
        v = torch.where(valid, v, zero)
    return v


def _masked(valid: Optional[Tensor], mask: Tensor) -> Tensor:
    return mask if valid is None else (valid & mask)


def _rho_from_parts(sum1, n1, sum2, n2, r1_lo, r1_hi, r2_lo, r2_hi, big):
    """Free-SV means with KKT-interval-midpoint fallback (eq. 20-21)."""
    mean1 = sum1 / torch.clamp_min(n1, 1.0)
    mean2 = sum2 / torch.clamp_min(n2, 1.0)
    half = big / 2
    r1_mid = torch.where((r1_lo > -half) & (r1_hi < half),
                         0.5 * (r1_lo + r1_hi),
                         torch.where(r1_hi < half, r1_hi, r1_lo))
    r2_mid = torch.where((r2_lo > -half) & (r2_hi < half),
                         0.5 * (r2_lo + r2_hi),
                         torch.where(r2_lo > -half, r2_lo, r2_hi))
    rho1 = torch.where(n1 > 0, mean1, r1_mid)
    rho2 = torch.where(n2 > 0, mean2, r2_mid)
    return rho1, rho2


def _rho_masks(gamma: Tensor, valid: Optional[Tensor], *, hi: float,
               lo: float, m: int, tol: float):
    ghi = hi * tol * m      # absolute slack scaled to the box size
    glo = -lo * tol * m
    return dict(
        free_lower=_masked(valid, (gamma > ghi) & (gamma < hi - ghi)),
        free_upper=_masked(valid, (gamma < -glo) & (gamma > lo + glo)),
        at_hi=_masked(valid, gamma >= hi - ghi),
        at_lo=_masked(valid, gamma <= lo + glo),
        nonneg=_masked(valid, gamma >= -glo),   # gamma >= 0: s <= rho2 side
        nonpos=_masked(valid, gamma <= ghi),    # gamma <= 0: s >= rho1 side
    )


def recover_rhos(gamma: Tensor, scores: Tensor, *, hi: float, lo: float,
                 m: int, comm: LocalComm = LOCAL_COMM,
                 valid: Optional[Tensor] = None,
                 tol: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """rho1 / rho2 from on-margin SVs, midpoint fallback when a plane has
    no free SV. ``big`` is the f32 sentinel finfo.max / 4, as a tensor of
    the scores' dtype."""
    dtype = scores.dtype
    big = _f32(torch.finfo(dtype).max / 4, scores)
    zero = torch.zeros((), dtype=dtype, device=scores.device)
    mk = _rho_masks(gamma, valid, hi=hi, lo=lo, m=m, tol=tol)

    ps = comm.psum(torch.stack([
        torch.sum(torch.where(mk["free_lower"], scores, zero)),
        torch.sum(mk["free_lower"]).to(dtype),
        torch.sum(torch.where(mk["free_upper"], scores, zero)),
        torch.sum(mk["free_upper"]).to(dtype),
    ]))
    pm = comm.pmax(torch.stack([
        torch.max(torch.where(mk["at_hi"], scores, -big)),
        torch.max(torch.where(mk["nonneg"], scores, -big)),
        -torch.min(torch.where(mk["nonpos"], scores, big)),
        -torch.min(torch.where(mk["at_lo"], scores, big)),
    ]))
    return _rho_from_parts(ps[0], ps[1], ps[2], ps[3],
                           pm[0], -pm[2], pm[1], -pm[3], big)


def _gap_masks(gamma: Tensor, valid: Optional[Tensor], *, hi: float,
               lo: float):
    bnd = 1e-8 * (hi - lo)            # bound-identification slack
    up = _masked(valid, gamma < hi - bnd)    # can increase
    dn = _masked(valid, gamma > lo + bnd)    # can decrease
    return up, dn


def solver_stats_fresh(gamma: Tensor, f: Tensor, rho1_prev: Tensor,
                       rho2_prev: Tensor, recompute_rho: bool, *, hi: float,
                       lo: float, m: int, tol: float,
                       comm: LocalComm = LOCAL_COMM,
                       valid: Optional[Tensor] = None):
    """(rho1, rho2, n_viol, max_viol, gap) with violations vs FRESH rho."""
    neg = _f32(-float("inf"), f)
    pos = _f32(float("inf"), f)

    if recompute_rho:
        rho1, rho2 = recover_rhos(gamma, f, hi=hi, lo=lo, m=m, comm=comm,
                                  valid=valid)
    else:
        rho1, rho2 = rho1_prev, rho2_prev

    v = violation(gamma, f, rho1, rho2, hi=hi, lo=lo, m=m, valid=valid)
    up, dn = _gap_masks(gamma, valid, hi=hi, lo=lo)
    n_viol = comm.psum(torch.sum(v > tol).to(f.dtype)).to(torch.int32)
    pm = comm.pmax(torch.stack([
        torch.max(v),
        torch.max(torch.where(dn, f, neg)),
        -torch.min(torch.where(up, f, pos)),
    ]))
    gap = pm[1] + pm[2]
    return rho1, rho2, n_viol, pm[0], gap
