"""OneClassSlabHead — the paper's classifier as a first-class head on
backbone features (the open-set-recognition integration point).

A backbone yields (batch, d_model) pooled features; this head fits the
OCSSVM slab on them with the SMO family and scores new features. Feature
normalization matters for kernel geometry, so the head owns a whitening
transform (mean/scale fit on the training features). The blocked solver
runs with its default on-the-fly kernel rows, as in the JAX package: the
fit launches no CUDA kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.batched_smo import solve_blocked
from repro_torch.core.engine.types import SMOResult
from repro_torch.core.ocssvm import OCSSVMModel, SlabSpec
from repro_torch.core.smo import solve as solve_smo

Tensor = torch.Tensor

_SOLVERS = ("blocked", "paper", "mvp")


class FittedHead(NamedTuple):
    model: OCSSVMModel
    mean: Tensor
    scale: Tensor
    result: SMOResult

    def _norm(self, F) -> Tensor:
        from repro_torch.api import as_rows
        return (as_rows(F, self.mean.device) - self.mean) / self.scale

    def score(self, F) -> Tensor:
        """Slab decision value; >= 0 means in-distribution."""
        return self.model.decision_function(self._norm(F))

    def predict(self, F) -> Tensor:
        return self.model.predict(self._norm(F))


def pool_features(hidden, mode: str = "mean") -> Tensor:
    """(batch, seq, d) -> (batch, d)."""
    hidden = torch.as_tensor(hidden)
    if mode == "mean":
        return hidden.mean(dim=1)
    if mode == "last":
        return hidden[:, -1, :]
    raise ValueError(f"unknown pooling {mode!r}")


def fit_head(
    features,
    spec: SlabSpec,
    *,
    solver: str = "blocked",
    P: int = 8,
    tol: float = 1e-4,
    normalize: bool = True,
    device=None,
) -> FittedHead:
    """Fit the OCSSVM slab on (n, d) in-distribution features, on
    ``device`` (default: the CUDA card; ``"cpu"`` runs the plain
    versions)."""
    from repro_torch.api import as_rows, resolve_device
    if solver not in _SOLVERS:
        raise ValueError(f"unknown solver {solver!r}")
    F = as_rows(features, resolve_device(device))
    if normalize:
        mean = F.mean(dim=0)
        # the population std, as jnp.std computes it
        scale = F.std(dim=0, correction=0) + 1e-6
    else:
        mean = torch.zeros((F.shape[1],), dtype=torch.float32,
                           device=F.device)
        scale = torch.ones((F.shape[1],), dtype=torch.float32,
                           device=F.device)
    Fn = (F - mean) / scale
    if solver == "blocked":
        res = solve_blocked(Fn, spec, P=P, tol=tol)
    else:
        res = solve_smo(Fn, spec, selection=solver, tol=tol)
    return FittedHead(model=res.model, mean=mean, scale=scale, result=res)
