"""Carry a fitted model across from the JAX package.

The JAX package's parameters are handed over as numpy arrays and plain
floats (this module imports nothing of it): the spec (nu1, nu2, eps and
the kernel's name, gamma, coef0, degree), the dual coefficients gamma,
the offsets rho1/rho2 and the training rows X. Out come the port's
``SlabSpec``, ``OCSSVMModel`` and ``SMOResult`` on the chosen device, so
a model fitted by one package can be packed and scored by the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine.types import SMOResult
from repro_torch.core.kernel_fn import KernelFn
from repro_torch.core.ocssvm import OCSSVMModel, SlabSpec


def spec_from_params(*, nu1: float, nu2: float, eps: float, kernel: str,
                     gamma: float = 1.0, coef0: float = 0.0,
                     degree: int = 3) -> SlabSpec:
    """A ``SlabSpec`` from host floats; ``kernel`` is the kernel's name."""
    return SlabSpec(nu1=float(nu1), nu2=float(nu2), eps=float(eps),
                    kernel=KernelFn(name=str(kernel), gamma=float(gamma),
                                    coef0=float(coef0), degree=int(degree)))


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def model_from_params(*, gamma, rho1: float, rho2: float, X,
                      spec: SlabSpec, device="cpu") -> OCSSVMModel:
    """An ``OCSSVMModel`` from the dual coefficients (m,), the offsets
    and the training rows (m, d)."""
    gamma = _f32(gamma, device).reshape(-1)
    X = _f32(X, device)
    if X.ndim != 2 or X.shape[0] != gamma.shape[0]:
        raise ValueError(f"gamma {tuple(gamma.shape)} and X "
                         f"{tuple(X.shape)} do not describe one model")
    return OCSSVMModel(gamma=gamma, rho1=_f32(rho1, device),
                       rho2=_f32(rho2, device), X=X, spec=spec)


def result_from_params(*, model: OCSSVMModel, iters: int, n_viol: int,
                       max_viol: float, gap: float, converged: bool,
                       f=None) -> SMOResult:
    """An ``SMOResult`` around a carried-across model and its solve's
    diagnostics (``f`` is the optional final f-cache)."""
    dev = model.gamma.device
    return SMOResult(
        model=model,
        iters=torch.tensor(int(iters), dtype=torch.int32, device=dev),
        n_viol=torch.tensor(int(n_viol), dtype=torch.int32, device=dev),
        max_viol=_f32(max_viol, dev), gap=_f32(gap, dev),
        converged=torch.tensor(bool(converged), device=dev),
        f=None if f is None else _f32(f, dev).reshape(-1))
