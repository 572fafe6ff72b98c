"""Shared tile plumbing for the kernel wrappers.

Only the padding helper and the lane width live here for now; the tuned
tile table of the JAX package is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Feature and row padding multiple the packed serving operands keep, so a
# packed model has the same geometry as the JAX package's.
LANE = 128


def _pad_to(a: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``a`` up to a multiple of ``mult``."""
    pad = (-a.shape[axis]) % mult
    if pad == 0:
        return a
    axis = axis % a.ndim
    # F.pad lists (left, right) pairs from the LAST axis backwards.
    widths = [0, 0] * (a.ndim - axis - 1) + [0, pad]
    return F.pad(a, widths)
