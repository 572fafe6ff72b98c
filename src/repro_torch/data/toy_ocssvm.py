"""The paper's toy dataset (Section 4 / Figs 1-2), reconstructed.

A target class concentrated in a band around a line plus a fraction of
background anomalies, with ground-truth labels (+1 = target /
inside-slab, -1 = anomaly). Same construction as the JAX package's
``make_toy``; the bits differ, because ``numpy.random.Generator`` is not
``jax.random``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_toy(seed: int, m: int, anomaly_frac: float = 0.15, d: int = 2,
             band_width: float = 0.35,
             direction=None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X, y) as float32 numpy arrays, y in {-1, +1}."""
    rng = np.random.default_rng(seed)
    n_anom = max(1, int(m * anomaly_frac))
    n_tgt = m - n_anom

    w = np.ones(d) if direction is None else np.asarray(direction, float)
    w = w / np.linalg.norm(w)

    # Target: spread along the band direction, tight across it.
    along = rng.standard_normal((n_tgt, 1)) * 2.0 + 3.0
    across = rng.standard_normal((n_tgt, d)) * band_width
    across = across - (across @ w)[:, None] * w[None, :]
    X_tgt = along * w[None, :] + across

    # Anomalies: uniform box covering the scene.
    X_anom = rng.uniform(-4.0, 10.0, (n_anom, d))

    X = np.concatenate([X_tgt, X_anom], axis=0)
    y = np.concatenate([np.ones((n_tgt,)), -np.ones((n_anom,))])
    perm = rng.permutation(m)
    return X[perm].astype(np.float32), y[perm].astype(np.float32)
