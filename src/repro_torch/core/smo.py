"""Paper-faithful SMO for the One-Class Slab SVM (Algorithm 1).

Thin facade over ``repro_torch.core.engine``: one violating pair per
iteration, updated analytically (eq. 35-39), with the f-cache maintained
by a rank-2 update and rho1/rho2 re-estimated from on-margin SVs every
step (eq. 20-21).

Two working-set selections:

* ``selection="paper"`` — the paper's heuristic (eq. 56):
  b = argmax |f_bar(x_b)| among KKT violators, a = argmax
  |f_bar(x_b) - f_bar(x_a)|, with partners whose clipped step would be
  zero masked out (``engine.select.PaperSelector``).
* ``selection="mvp"`` — Keerthi-style maximal-violating-pair on the
  reduced dual; converged when the duality gap <= tol.

The paper selector already holds both kernel columns of its pair, so the
rank-2 update reuses them under every provider: this route launches no
``fupdate`` kernel, as in the JAX package.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core.engine.gram import raw_scores_blocked  # re-export
from repro_torch.core.engine.types import SMOResult
from repro_torch.core.ocssvm import (OCSSVMModel, SlabSpec, concrete_spec,
                                     feasible_init)

Tensor = torch.Tensor

__all__ = ["solve", "SMOResult", "raw_scores_blocked"]


def solve(
    X: Tensor,
    spec: SlabSpec,
    *,
    gram_mode: str = "precomputed",
    selection: str = "paper",
    precision: str = "f32",
    tol: float = 1e-4,
    max_iters: int = 200_000,
    patience: int = 20,
    gamma0: Optional[Tensor] = None,
) -> SMOResult:
    """Run Algorithm 1 until <= 1 KKT violator (paper) / gap <= tol (mvp),
    on the device X lies on. ``precision`` ("f32"/"bf16"/"f16") is the
    Gram tile-input dtype (``repro_torch.kernels.precision``)."""
    spec = concrete_spec(spec)
    m = X.shape[0]
    Xf = X.to(torch.float32)
    hi, lo = spec.upper(m), spec.lower(m)

    gamma = (feasible_init(m, spec, torch.float32, device=X.device)
             if gamma0 is None
             else torch.as_tensor(gamma0, dtype=torch.float32,
                                  device=X.device))

    provider = engine.make_provider(gram_mode, Xf, spec.kernel,
                                    precision=precision)
    selector = engine.make_selector(selection, provider, P=1, hi=hi, lo=lo,
                                    m=m, tol=tol)
    stats_fn = partial(engine.solver_stats_fresh, hi=hi, lo=lo, m=m, tol=tol)

    state0 = engine.init_state(provider, stats_fn, gamma)
    s = engine.run(provider, selector, stats_fn, state0, hi=hi, lo=lo,
                   tol=tol, max_iters=max_iters, patience=patience)

    model = OCSSVMModel(gamma=s.gamma, rho1=s.rho1, rho2=s.rho2, X=Xf,
                        spec=spec)
    return SMOResult(model=model, iters=s.it, n_viol=s.n_viol,
                     max_viol=s.max_viol, gap=s.gap,
                     converged=engine.has_converged(s, selector.criterion,
                                                    tol),
                     f=s.f)
