"""Plain PyTorch version of the kernel matrix, dtype-parameterized.

``gram_plain`` is the counterpart of the JAX package's
``kernels/gram/ref.py::gram_ref``: the rows are rounded to the tile dtype
(f32 -> bf16/f16 -> f32, as the kernel's low-precision stream sees them)
and everything else is f32 — the norms of the rounded rows, the dot
products and the epilogue (``core/kernel_fn.apply_epilogue``). It is
what the ``gram`` wrapper runs for CPU tensors and what the CUDA kernel
is held against on the card; the two differ only by the f32 summation
order.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel_fn import apply_epilogue
from repro_torch.kernels.precision import round_to_tile


def gram_plain(x, y, *, kind: str, gamma: float = 1.0, coef0: float = 0.0,
               degree: int = 3, precision: str = "f32") -> torch.Tensor:
    """K[i, j] = k(x_i, y_j) in f32 for x (m, d), y (n, d) rows of any
    float dtype, streamed at ``precision``."""
    x = round_to_tile(x, precision)
    y = round_to_tile(y, precision)
    xn = yn = None
    if kind == "rbf":
        xn = torch.sum(x * x, dim=-1, keepdim=True)
        yn = torch.sum(y * y, dim=-1, keepdim=True).T
    return apply_epilogue(x @ y.T, xn, yn, kind=kind, gamma=gamma,
                          coef0=coef0, degree=degree)
