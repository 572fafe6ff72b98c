"""Score-distribution drift detector gating warm vs. cold refresh.

A registry refresh with appended data has two routes: a warm delta-solve
(``fit_update`` seeded from the cached ``SolverArtifact``) or a full cold
refit. The warm route only pays when the new rows come from roughly the
distribution the cached model learned: a warm start from a model of the
wrong distribution spends its iterations un-learning the stale support
set.

The detector scores a strided sample of the incoming rows through the
cached support-vector slab (non-SV rows carry ~zero coefficient, so
``k(q, X_sv) @ gamma_sv`` equals the full-expansion raw score) and
compares that distribution with the cached f-cache scores of the
training rows, by a two-sample Kolmogorov-Smirnov statistic.
In-distribution appends land inside the cached score distribution (KS
small); a shifted stream scores far from the slab (KS -> 1).

The kernel block runs on the recipe's device (``KernelFn.cross``, a
plain tensor op, as in the JAX package); the float64 matvec and the KS
statistic run on the host, in numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine.state import host_f32

__all__ = ["DriftReport", "ks_statistic", "score_drift",
           "DEFAULT_THRESHOLD"]

# KS distance above which a refresh refits cold. Two samples from the
# same continuous distribution at n = 512 sit around 0.03-0.12; a mean
# shift of one bandwidth pushes past 0.5.
DEFAULT_THRESHOLD = 0.35


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One drift decision, with the evidence that produced it."""

    statistic: float    # two-sample KS distance in [0, 1]
    threshold: float
    n_ref: int          # cached-score sample size
    n_new: int          # incoming-row sample size

    @property
    def drifted(self) -> bool:
        return bool(self.statistic > self.threshold)


def ks_statistic(a, b) -> float:
    """Two-sample Kolmogorov-Smirnov distance sup_x |F_a(x) - F_b(x)|:
    pool both samples, sort once, and take the largest gap between the
    two empirical CDFs over the pooled points."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if a.size == 0 or b.size == 0:
        raise ValueError("ks_statistic needs non-empty samples")
    pooled = np.concatenate([a, b])
    order = np.argsort(pooled, kind="stable")
    # +1/na steps where the pooled point came from a, -1/nb where from b:
    # the running sum IS F_a - F_b over the pooled support.
    steps = np.where(order < a.size, 1.0 / a.size, -1.0 / b.size)
    return float(np.abs(np.cumsum(steps)).max())


def _strided(x: np.ndarray, cap: int) -> np.ndarray:
    """Deterministic <= cap evenly-strided sample along axis 0."""
    if x.shape[0] <= cap:
        return x
    return x[:: -(-x.shape[0] // cap)]


def score_drift(artifact, X_new, *, threshold: float = DEFAULT_THRESHOLD,
                max_sample: int = 512, sv_threshold: float = 1e-7,
                device=None) -> DriftReport:
    """Compare incoming rows' scores against the cached score slab.

    ``artifact`` is the ``SolverArtifact`` of the cached fit; ``X_new``
    the candidate rows (numpy or a tensor). Both samples are capped at
    ``max_sample`` rows, so one call is O(sample * n_sv * d) kernel work.
    ``device``: where the kernel block runs (default: the CUDA card).
    """
    from repro_torch.api import resolve_device
    dev = resolve_device(device)
    f = np.asarray(artifact.f, np.float64)
    ref = _strided(f, max_sample)

    sv = artifact.support_mask(sv_threshold)
    if not sv.any():            # degenerate fit: every score is constant
        sv = np.ones_like(sv)
    X_sv = np.asarray(artifact.X, np.float32)[sv]
    g_sv = np.asarray(artifact.gamma, np.float32)[sv]

    q = _strided(host_f32(X_new), max_sample)
    k = artifact.spec.kernel.cross(torch.as_tensor(q, device=dev),
                                   torch.as_tensor(X_sv, device=dev))
    new_scores = k.cpu().numpy().astype(np.float64) @ g_sv.astype(np.float64)

    return DriftReport(statistic=ks_statistic(ref, new_scores),
                       threshold=threshold, n_ref=int(ref.shape[0]),
                       n_new=int(new_scores.shape[0]))
