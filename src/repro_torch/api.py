"""Top-level entry points: ``fit`` picks a solver composition by problem,
``serve`` fits (once per recipe) and packs the model for scoring.

* small m (<= 2048) -> blocked solver, precomputed Gram
* larger m          -> blocked solver; on a CUDA device the f-cache
                       update is the fused ``fupdate`` kernel
                       (``gram_mode="pallas"``), on the CPU the plain
                       on-the-fly rows

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card and without that request they raise.
The strategies the JAX package has beyond these (the paper's sequential
selectors, shrinking, warm starts, the sharded solver) are not ported
yet and raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.batched_smo import solve_blocked
from repro_torch.core.engine.gram import SINGLE_PASS_MAX
from repro_torch.core.engine.types import SMOResult
from repro_torch.core.ocssvm import SlabSpec

# Above this row count the JAX package's "auto" takes its shrinking
# repack driver, which is not ported yet.
_SHRINKING_MIN_M = 8192

STRATEGIES = ("auto", "paper", "mvp", "blocked", "pallas", "shrinking",
              "distributed", "sharded")

# Strategies of the JAX package still waiting for their ROADMAP item.
_NOT_PORTED = {
    "paper": "ROADMAP A.5 (the paper's solver)",
    "mvp": "ROADMAP A.5 (the paper's solver)",
    "shrinking": "ROADMAP A.6 (shrinking)",
    "distributed": "ROADMAP A.9 (distributed)",
    "sharded": "ROADMAP A.9 (distributed)",
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another; raises when no card is there. On the card, TF32 is
    switched off: the f32 path is true f32, as in the JAX package."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def as_rows(X, device: torch.device) -> torch.Tensor:
    """(m, d) f32 rows on ``device`` from a tensor or array-like."""
    if isinstance(X, torch.Tensor):
        return X.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(X, np.float32), device=device)


def _auto_gram_mode(m: int, device: torch.device) -> str:
    if m <= SINGLE_PASS_MAX // 2:
        return "precomputed"
    if device.type == "cuda":
        return "pallas"            # the fused fupdate kernel
    return "on_the_fly"


def fit(
    X,
    spec: Optional[SlabSpec] = None,
    *,
    strategy: str = "auto",
    gram_mode: Optional[str] = None,
    precision: str = "f32",
    P: int = 8,
    tol: float = 1e-4,
    device=None,
    mesh=None,
    warm_start=None,
    **kwargs,
) -> SMOResult:
    """Train a One-Class Slab SVM; returns an ``SMOResult``.

    strategy: "auto" (size/hardware rule), "blocked", or "pallas" (the
    blocked solver pinned to the fused ``fupdate`` provider). precision:
    Gram tile-input dtype ("f32" default, "bf16", "f16"); dot products
    still accumulate in f32. device: where to solve (default: the CUDA
    card). Extra kwargs flow to ``solve_blocked`` (max_outer/max_iters,
    patience, gamma0).
    """
    if spec is None:
        spec = SlabSpec()
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    if mesh is not None:
        raise NotImplementedError(
            f"a mesh needs the sharded solver: {_NOT_PORTED['sharded']}")
    if warm_start is not None:
        raise NotImplementedError("warm starts are ROADMAP A.7 (warm start)")
    dev = resolve_device(device)
    X = as_rows(X, dev)
    m = X.shape[0]

    if strategy == "auto":
        strategy = "shrinking" if m > _SHRINKING_MIN_M else "blocked"
    if strategy in _NOT_PORTED:
        raise NotImplementedError(
            f"strategy={strategy!r} is not ported yet: "
            f"{_NOT_PORTED[strategy]}")
    if "max_iters" in kwargs:
        kwargs["max_outer"] = kwargs.pop("max_iters")

    if strategy == "pallas":
        if gram_mode is not None and gram_mode != "pallas":
            raise ValueError(
                f"strategy='pallas' pins gram_mode='pallas'; got "
                f"gram_mode={gram_mode!r} — drop it or use "
                f"strategy='blocked'")
        gram_mode = "pallas"
    gm = gram_mode if gram_mode is not None else _auto_gram_mode(m, dev)
    return solve_blocked(X, spec, P=P, gram_mode=gm, precision=precision,
                         tol=tol, **kwargs)


def serve(X=None, spec: Optional[SlabSpec] = None, *,
          model: Optional[str] = None, **kwargs):
    """Train-then-serve: a warm ``ServingModel`` ready to ``score(q)``.

    Hits the process-wide warm-model cache (fit + SV compaction + packing
    happen once per (spec, data, kwargs) key). kwargs flow to
    ``ModelCache.get_or_fit`` (cache=, offsets=, sv_threshold=, tn=,
    precision=) and on to ``fit`` (strategy, device, tol, P, ...).
    Routing by ``model=`` name is ROADMAP A.8 (serving control plane).
    """
    if model is not None:
        raise NotImplementedError(
            "serve(model=...) needs the model registry: ROADMAP A.8 "
            "(serving control plane)")
    if X is None:
        raise TypeError("serve() needs X")
    from repro_torch.serve.model_cache import serve as cache_serve
    return cache_serve(X, spec, **kwargs)
