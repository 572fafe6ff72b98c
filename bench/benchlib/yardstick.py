"""The benchmark's frozen yardstick: peaks, the decision's work, shares.

Kept here, not read from the program, so that a change to the program
cannot move what it is measured against.

Peaks: NVIDIA's data sheet for one H100 SXM, dense, at its 700 W limit
(the same numbers as the program's ``utils/roofline`` when this copy was
taken): 67 TFLOP/s in f32 outside the tensor cores, 989 TFLOP/s in bf16
and f16 on them, 3.35 TB/s of HBM.

The slab decision of ``rows`` queries against ``nt`` support rows of
``d`` features: every query meets every support row, 2 d FLOPs for the
dot product and 2 for the gamma-weighted sum (the rbf epilogue's exp and
the slab rule are not counted). Its bytes: each input read once and the
output written once — the query rows and the support rows in the tile
type (``elem`` bytes a feature), the support's f32 coefficient and norm,
the queries' f32 norm and f32 output; the support set is read once a
launch.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "f16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"f32": 4, "bf16": 2, "f16": 2}


def decision_flops(rows: int, nt: int, d: int) -> float:
    return 2.0 * rows * nt * d + 2.0 * rows * nt


def decision_bytes(rows: int, launches: int, nt: int, d: int,
                   precision: str) -> float:
    e = ELEM_BYTES[precision]
    return launches * nt * (d * e + 8.0) + rows * (d * e + 8.0)


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations
    at the precision's peak and the bytes at the HBM bandwidth."""
    return max(flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S)


def share_pct(part: float, whole: float):
    """100 * part / whole, or None when there is nothing to divide by."""
    if not whole or whole <= 0 or part is None:
        return None
    return 100.0 * part / whole


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals (any unit)."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank p-th percentile of all values: the smallest value
    that at least p% of them do not exceed."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(p / 100.0 * len(s)))
    return s[k - 1]
