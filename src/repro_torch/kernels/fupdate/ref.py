"""Plain PyTorch versions of the fused f-cache update.

``fupdate_plain`` is the kernel's function on the operands the wrapper
launches it with (tile-dtype rows, f32 norms); it is what the wrapper runs
for CPU tensors and what the CUDA kernel is held against on the card.
``fupdate_ref`` is the oracle from raw f32 inputs, the counterpart of the
JAX package's ``kernels/fupdate/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel_fn import KernelFn, apply_epilogue
from repro_torch.kernels.precision import round_to_tile


def fupdate_plain(x, xsel, delta, f, xn, seln, *, kind: str,
                  gamma: float = 1.0, coef0: float = 0.0, degree: int = 3):
    """f + k(x, xsel) @ delta from the kernel's operands: x (m, d) and
    xsel (s, d) in the tile dtype, delta (s,), f (m,), xn (m,) and
    seln (s,) f32."""
    dot = x.to(torch.float32) @ xsel.to(torch.float32).T
    krows = apply_epilogue(dot, xn[:, None], seln[None, :], kind=kind,
                           gamma=gamma, coef0=coef0, degree=degree)
    return f + krows @ delta


def fupdate_ref(x, xsel, delta, f, *, kind: str, gamma: float = 1.0,
                coef0: float = 0.0, degree: int = 3,
                precision: str = "f32"):
    kern = KernelFn(name=kind, gamma=gamma, coef0=coef0, degree=degree)
    krows = kern.cross(round_to_tile(x, precision),
                       round_to_tile(xsel, precision))
    return f.to(torch.float32) + krows @ delta.to(torch.float32)
