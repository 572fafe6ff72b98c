"""Plain PyTorch versions of the slab decision function.

``decision_plain`` is the kernel's function on the operands the wrappers
launch it with; it is what they run for CPU tensors and what the CUDA
kernel is held against on the card. ``decision_ref`` is the oracle from
raw f32 inputs, the counterpart of the JAX package's
``kernels/decision/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel_fn import KernelFn, apply_epilogue
from repro_torch.kernels.precision import round_to_tile


def decision_plain(q, t, gamma_vec, qn, tnorm, rho1: float, rho2: float, *,
                   kind: str, gamma: float = 1.0, coef0: float = 0.0,
                   degree: int = 3):
    """(s - rho1) * (rho2 - s), s = k(q, t) @ gamma_vec, from the kernel's
    operands: q (nq, d) and t (nt, d) in the tile dtype, gamma_vec (nt,),
    qn (nq,) and tnorm (nt,) f32."""
    dot = q.to(torch.float32) @ t.to(torch.float32).T
    s = apply_epilogue(dot, qn[:, None], tnorm[None, :], kind=kind,
                       gamma=gamma, coef0=coef0, degree=degree) @ gamma_vec
    return (s - rho1) * (rho2 - s)


def decision_ref(q, t, gamma_vec, rho1, rho2, *, kind: str,
                 gamma: float = 1.0, coef0: float = 0.0, degree: int = 3,
                 precision: str = "f32"):
    kern = KernelFn(name=kind, gamma=gamma, coef0=coef0, degree=degree)
    s = kern.cross(round_to_tile(q, precision),
                   round_to_tile(t, precision)) @ gamma_vec.to(torch.float32)
    return (s - rho1) * (rho2 - s)
