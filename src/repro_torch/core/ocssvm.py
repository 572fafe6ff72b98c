"""One-Class Slab SVM model state, in the paper's reduced gamma-space.

The paper's key reduction (eq. 29-32): the dual depends only on
``gamma = alpha - alpha_bar``, giving

    min_gamma  1/2 gamma^T K gamma
    s.t.       -eps/(nu2*m) <= gamma_i <= 1/(nu1*m),   sum(gamma) = 1 - eps

``raw score`` s_i = sum_j gamma_j k(x_i, x_j); the slab decision is
``sgn((s - rho1) * (rho2 - s))`` (eq. 19): +1 inside the slab, -1 outside.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.engine import stats as _stats
from repro_torch.core.engine.gram import BLOCK, SINGLE_PASS_MAX
from repro_torch.core.kernel_fn import KernelFn

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SlabSpec:
    """Static problem specification (nu1, nu2, eps and the kernel)."""

    nu1: float = 0.5
    nu2: float = 0.01
    eps: float = 2.0 / 3.0
    kernel: KernelFn = dataclasses.field(default_factory=KernelFn)

    # Box bounds in gamma space (eq. 31) and the equality target (eq. 32).
    def upper(self, m: int) -> float:
        return 1.0 / (self.nu1 * m)

    def lower(self, m: int) -> float:
        return -self.eps / (self.nu2 * m)

    def total(self) -> float:
        return 1.0 - self.eps


class OCSSVMModel(NamedTuple):
    """Fitted model: dual coefficients + slab offsets + the training data."""

    gamma: Tensor  # (m,) dual coefficients alpha - alpha_bar
    rho1: Tensor   # lower-plane offset
    rho2: Tensor   # upper-plane offset
    X: Tensor      # (m, d) training points (support data)
    spec: SlabSpec

    def raw_scores(self, Xq: Tensor) -> Tensor:
        """s(x) = sum_j gamma_j k(x, x_j) for query points (n, d) -> (n,)."""
        return self.spec.kernel.cross(Xq, self.X) @ self.gamma

    def decision_function(self, Xq: Tensor) -> Tensor:
        """Signed slab margin value (eq. 19 before the sgn)."""
        s = self.raw_scores(Xq)
        return (s - self.rho1) * (self.rho2 - s)

    def predict(self, Xq: Tensor) -> Tensor:
        """+1 inside the slab (target class), -1 outside."""
        return torch.where(self.decision_function(Xq) >= 0, 1, -1)


def concrete_spec(spec: SlabSpec) -> SlabSpec:
    """The spec with every (hyper-)parameter a host float, so it hashes
    (cache keys) and reaches the kernels as plain scalars — 0-d tensors,
    e.g. from a spec carried across from another package, are read once."""
    kernel = dataclasses.replace(spec.kernel, gamma=float(spec.kernel.gamma),
                                 coef0=float(spec.kernel.coef0),
                                 degree=int(spec.kernel.degree))
    return dataclasses.replace(spec, nu1=float(spec.nu1),
                               nu2=float(spec.nu2), eps=float(spec.eps),
                               kernel=kernel)


def feasible_init(m: int, spec: SlabSpec, dtype=torch.float32,
                  device=None) -> Tensor:
    """A strictly feasible gamma: water-fill ``1 - eps`` into the box.

    Uniform (1-eps)/m works whenever it is inside the box; otherwise fill
    the first floor((1-eps)/hi) entries to the cap and put the remainder
    in the next slot. The water-fill arithmetic is the reference's f32
    arithmetic (the host ratio rounded to f32 before the floor).
    """
    hi = spec.upper(m)
    lo = spec.lower(m)
    total = spec.total()
    uniform = total / m
    if lo <= uniform <= hi:
        return torch.full((m,), uniform, dtype=dtype, device=device)
    # total > 0 always (eps < 1): fill caps left to right.
    hi_t = torch.tensor(hi, dtype=dtype)
    full = int(math.floor(float(torch.tensor(total / hi, dtype=dtype))))
    rem = torch.tensor(total, dtype=dtype) - torch.tensor(full, dtype=dtype) \
        * hi_t
    g = torch.zeros((m,), dtype=dtype)
    g[:min(full, m)] = hi_t
    if full < m:    # an out-of-range remainder slot is dropped, as in jax
        g[full] += rem
    return g.to(device)


def recover_rhos(gamma: Tensor, scores: Tensor, spec: SlabSpec,
                 tol: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """rho1 / rho2 from on-margin support vectors (eq. 20-21).

    Lower-plane SVs: 0 < gamma < 1/(nu1 m)  -> s = rho1.
    Upper-plane SVs: -eps/(nu2 m) < gamma < 0 -> s = rho2.

    When a plane has no free SV (all at bound), fall back to the KKT
    interval midpoint. This is the spec-based view of the one
    implementation in ``repro_torch.core.engine.stats``.
    """
    m = gamma.shape[0]
    return _stats.recover_rhos(gamma, scores, hi=spec.upper(m),
                               lo=spec.lower(m), m=m, tol=tol)


def _quantile(s: Tensor, q: float) -> Tensor:
    """``jnp.quantile(s, q)`` (method "linear"): f32 rank q * (n - 1),
    then low * (1 - w) + high * w."""
    v = torch.sort(s).values
    n = v.shape[0]
    rank = torch.full((), q, dtype=s.dtype, device=s.device) * (n - 1)
    low = torch.clamp(torch.floor(rank), 0, n - 1)
    high = torch.clamp(torch.ceil(rank), 0, n - 1)
    hw = rank - low
    lw = 1.0 - hw
    return v[low.long()] * lw + v[high.long()] * hw


def with_quantile_offsets(model: OCSSVMModel) -> OCSSVMModel:
    """Beyond-paper robustness: primal-consistent slab offsets.

    rho1 = nu1-quantile and rho2 = (1 - nu2)-quantile of the training
    scores, which restores a usable slab whenever w != 0 (at a dual
    optimum with free SVs on both planes the margin-SV rule gives
    rho1 = rho2).
    """
    s = model.raw_scores(model.X)
    rho1 = _quantile(s, model.spec.nu1)
    rho2 = _quantile(s, 1.0 - model.spec.nu2)
    return model._replace(rho1=rho1, rho2=rho2)


def compact_support(model: OCSSVMModel,
                    threshold: float = 1e-7) -> OCSSVMModel:
    """Drop non-support rows: keep only |gamma_i| > threshold.

    The compacted ``decision_function`` differs from the full model's by
    at most ``sum(|dropped gamma|) * max_k |k|``. Shapes change, so this
    runs once per fitted model, in the serving cache.
    """
    idx = torch.nonzero(torch.abs(model.gamma) > threshold).reshape(-1)
    return model._replace(gamma=model.gamma[idx], X=model.X[idx])


def dual_objective(gamma: Tensor, K: Tensor) -> Tensor:
    """1/2 gamma^T K gamma (eq. 30)."""
    return 0.5 * (gamma @ (K @ gamma))


def dual_objective_matfree(gamma: Tensor, X: Tensor,
                           kernel: KernelFn) -> Tensor:
    """Objective without materializing K: one cross-kernel pass below the
    engine's single-pass threshold, row blocks above it."""
    if X.shape[0] <= SINGLE_PASS_MAX:
        return 0.5 * (gamma @ (kernel.cross(X, X) @ gamma))
    acc = torch.zeros((), dtype=gamma.dtype, device=gamma.device)
    for i in range(0, X.shape[0], BLOCK):
        acc = acc + gamma[i:i + BLOCK] @ (kernel.cross(X[i:i + BLOCK], X)
                                          @ gamma)
    return 0.5 * acc
