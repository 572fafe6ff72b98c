"""Mercer kernel functions for the OCSSVM dual.

All kernels expose the access patterns the SMO solver needs:

* ``gram(X)``        — full m x m Gram matrix (small-m path only).
* ``cross(X, Y)``    — m x n cross-kernel block (decision function).
* ``rows(X, Xsel)``  — k(X, Xsel) for a gathered block of rows (what the
                       ``fupdate`` kernel fuses).

``apply_epilogue`` is the one Python statement of the kernel epilogue on
an f32 dot-product block; ``KernelFn.cross`` and the kernels' plain
versions all go through it.
"""
from __future__ import annotations

import dataclasses

import torch

_KINDS = ("linear", "rbf", "poly")


def int_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for a static int n >= 0 by repeated squaring — the
    multiplication order of ``jax.lax.integer_pow`` (and of the CUDA
    kernels), not ``pow``."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def apply_epilogue(dot: torch.Tensor, row_norms, col_norms, *, kind: str,
                   gamma: float, coef0: float, degree: int) -> torch.Tensor:
    """Kernel values from an f32 (n, k) dot block. ``row_norms`` (n, 1)
    and ``col_norms`` (1, k) are read by rbf only; rbf clamps the squared
    distance at 0 before the exp."""
    if kind == "linear":
        return dot
    if kind == "rbf":
        sq = row_norms + col_norms - 2.0 * dot
        return torch.exp(-gamma * torch.clamp_min(sq, 0.0))
    if kind == "poly":
        return int_pow(gamma * dot + coef0, degree)
    raise ValueError(f"unknown kernel {kind!r}")


@dataclasses.dataclass(frozen=True)
class KernelFn:
    """A Mercer kernel with hyper-parameters held as host floats.

    name: one of {"linear", "rbf", "poly"}.
    gamma: RBF width / poly scale (ignored for linear).
    coef0, degree: poly parameters.
    """

    name: str = "linear"
    gamma: float = 1.0
    coef0: float = 0.0
    degree: int = 3

    def cross(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """K[i, j] = k(X[i], Y[j]); shapes (m, d), (n, d) -> (m, n)."""
        if self.name not in _KINDS:
            raise ValueError(f"unknown kernel {self.name!r}")
        dot = X @ Y.T
        xx = yy = None
        if self.name == "rbf":
            xx = torch.sum(X * X, dim=-1, keepdim=True)
            yy = torch.sum(Y * Y, dim=-1, keepdim=True).T
        return apply_epilogue(dot, xx, yy, kind=self.name, gamma=self.gamma,
                              coef0=self.coef0, degree=self.degree)

    def gram(self, X: torch.Tensor) -> torch.Tensor:
        return self.cross(X, X)

    def rows(self, X: torch.Tensor, Xsel: torch.Tensor) -> torch.Tensor:
        """k(X, Xsel) -> (m, k). ``Xsel`` is a gathered (k, d) block."""
        return self.cross(X, Xsel)

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        """k(x_i, x_i) for every row — needed for eta without the Gram."""
        if self.name == "linear":
            return torch.sum(X * X, dim=-1)
        if self.name == "rbf":
            return torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)
        if self.name == "poly":
            return int_pow(self.gamma * torch.sum(X * X, dim=-1)
                           + self.coef0, self.degree)
        raise ValueError(f"unknown kernel {self.name!r}")


def linear() -> KernelFn:
    return KernelFn(name="linear")


def rbf(gamma: float = 1.0) -> KernelFn:
    return KernelFn(name="rbf", gamma=gamma)


def poly(gamma: float = 1.0, coef0: float = 1.0, degree: int = 3) -> KernelFn:
    return KernelFn(name="poly", gamma=gamma, coef0=coef0, degree=degree)
