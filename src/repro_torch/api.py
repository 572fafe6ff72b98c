"""Top-level entry points: ``fit`` picks a solver composition by problem,
``fit_update`` re-fits warm from a prior fit, ``serve`` fits (once per
recipe) and packs the model for scoring.

* small m (<= 2048) -> blocked solver, precomputed Gram
* larger m          -> blocked solver; on a CUDA device the f-cache
                       update is the fused ``fupdate`` kernel
                       (``gram_mode="pallas"``), on the CPU the plain
                       on-the-fly rows
* m > 8192          -> the shrinking repack driver around the blocked
                       solver
* mesh given / "sharded" -> the row-sharded solver over the mesh's data
                       axes (the per-rank ``fupdate`` on the hot loop);
                       large m additionally gets the sharded shrinking
                       repack driver. With no mesh given, "sharded" builds
                       one (``repro_torch.launch.make_solver_mesh``: one
                       rank without a process group).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card and without that request they raise.
The sharded strategies run SPMD: every rank's process calls ``fit`` with
the same arguments after ``torch.distributed.init_process_group``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batched_smo import solve_blocked
from repro_torch.core.distributed_smo import solve_blocked_distributed
from repro_torch.core.engine.gram import SINGLE_PASS_MAX
from repro_torch.core.engine.state import (SolverArtifact, WarmStart,
                                           artifact_from_result,
                                           prepare_warm_start)
from repro_torch.core.engine.types import SMOResult
from repro_torch.core.ocssvm import SlabSpec
from repro_torch.core.shrinking import (solve_blocked_shrinking,
                                        solve_sharded_shrinking)
from repro_torch.core.smo import solve as solve_smo

# Above this row count the shrinking repack driver wins: per-iteration
# work drops to the active (support-vector) set.
_SHRINKING_MIN_M = 8192

STRATEGIES = ("auto", "paper", "mvp", "blocked", "pallas", "shrinking",
              "distributed", "sharded")


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
    data_axes: Tuple[str, ...] = ("data",),
    multi_pod: bool = False,
    ledger=None,
    warm_start=None,
    warm_info_out: Optional[dict] = None,
    **kwargs,
) -> SMOResult:
    """Train a One-Class Slab SVM; returns an ``SMOResult``.

    strategy: "auto" (size rule), "paper" / "mvp" (the sequential
    Algorithm 1 selectors), "blocked", "pallas" (the blocked solver
    pinned to the fused ``fupdate`` provider) or "shrinking" (the repack
    driver), "sharded" (row-sharded solver over a mesh — built by
    ``make_solver_mesh(multi_pod=...)`` when ``mesh`` is not given; large
    m composes with the sharded shrinking driver) or "distributed" (the
    plain row-sharded solver; requires ``mesh``). precision: Gram
    tile-input dtype ("f32" default, "bf16", "f16"); dot products still
    accumulate in f32. device: where to solve (default: the CUDA card;
    under a mesh, this rank's card). mesh / data_axes: a
    ``repro_torch.launch.SolverMesh`` and the axes its rows shard over;
    every rank calls ``fit`` with the same arguments. ledger: a
    ``repro_torch.core.engine.CollectiveLedger`` the sharded strategies
    fill with per-device collective bytes (ignored by the local ones).
    warm_start: a prior fit to seed from — a
    ``SolverArtifact``, an ``SMOResult`` (converted) or an
    already-prepared ``engine.WarmStart``: gamma seeds from the
    overlapping rows and the f-cache is reconciled with one fused rank-s
    sweep instead of the O(m^2) init (the paper/mvp strategies seed gamma
    only). warm_info_out: a dict the warm-start accounting
    (overlap/fresh/expired/correction counts) is written into. Extra
    kwargs flow to the chosen solver (max_iters/max_outer, patience,
    gamma0, ...).
    """
    if spec is None:
        spec = SlabSpec()
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    dev = resolve_device(device)
    X = as_rows(X, dev)
    m = X.shape[0]

    warm = None
    if warm_start is not None:
        if isinstance(warm_start, WarmStart):
            warm = warm_start          # prepared by the caller (fit_update)
        else:
            art = _as_artifact(warm_start, precision=precision)
            warm, winfo = prepare_warm_start(art, X, spec,
                                             precision=precision)
            if warm_info_out is not None:
                warm_info_out.update(dataclasses.asdict(winfo))

    if strategy == "auto":
        if mesh is not None:
            strategy = "sharded"
        elif m > _SHRINKING_MIN_M:
            strategy = "shrinking"
        else:
            strategy = "blocked"

    # The sequential solvers call their iteration cap max_iters, the
    # blocked family max_outer; accept either so "auto" can reroute a call
    # without the caller caring which solver won.
    if strategy in ("paper", "mvp"):
        if "max_outer" in kwargs:
            kwargs["max_iters"] = kwargs.pop("max_outer")
    elif "max_iters" in kwargs:
        kwargs["max_outer"] = kwargs.pop("max_iters")

    if strategy in ("distributed", "sharded"):
        if gram_mode is not None:
            raise ValueError(
                "gram_mode is not configurable for the sharded/"
                "distributed strategies: the sharded provider owns Gram "
                "access (its hot loop is the per-rank fupdate; the local "
                "repack solves of the sharded shrinking driver pick their "
                "own provider)")
        if strategy == "distributed" and mesh is None:
            raise ValueError("strategy='distributed' needs a mesh; "
                             "use strategy='sharded' to build one from "
                             "the launch layer")
        if mesh is None:
            from repro_torch.launch.mesh import make_solver_mesh
            mesh, data_axes = make_solver_mesh(multi_pod=multi_pod)
        if strategy == "sharded" and m > _SHRINKING_MIN_M:
            return solve_sharded_shrinking(X, spec, mesh,
                                           data_axes=data_axes, P_pairs=P,
                                           tol=tol, precision=precision,
                                           ledger=ledger, warm=warm,
                                           **kwargs)
        # Below the shrinking threshold the plain sharded solve runs: the
        # shrinking-only knobs raise a clear error instead of a TypeError
        # (the accepted kwargs must not change silently when a growing
        # data set crosses the threshold).
        shrink_only = [k for k in ("warm_iters", "max_rounds",
                                   "round_iters", "margin", "gather_max")
                       if k in kwargs]
        if shrink_only:
            raise ValueError(
                f"kwargs {shrink_only} configure the sharded shrinking "
                f"driver, which only runs for m > {_SHRINKING_MIN_M} "
                f"(got m={m}); drop them or call "
                "repro_torch.core.solve_sharded_shrinking directly")
        return solve_blocked_distributed(X, spec, mesh, data_axes=data_axes,
                                         P_pairs=P, tol=tol,
                                         precision=precision, ledger=ledger,
                                         warm=warm, **kwargs)

    if strategy == "pallas":
        if gram_mode is not None and gram_mode != "pallas":
            raise ValueError(
                f"strategy='pallas' pins gram_mode='pallas'; got "
                f"gram_mode={gram_mode!r} — drop it or use "
                f"strategy='blocked'")
        gram_mode = "pallas"
    gm = gram_mode if gram_mode is not None else _auto_gram_mode(m, dev)
    if strategy in ("paper", "mvp"):
        # The sequential facades seed gamma only (the init pass still
        # scores it from scratch).
        if warm is not None:
            kwargs["gamma0"] = warm.gamma0
        return solve_smo(X, spec, selection=strategy, gram_mode=gm,
                         precision=precision, tol=tol, **kwargs)
    if strategy == "shrinking":
        return solve_blocked_shrinking(X, spec, P=P, gram_mode=gm,
                                       precision=precision, tol=tol,
                                       warm=warm, **kwargs)
    return solve_blocked(X, spec, P=P, gram_mode=gm, precision=precision,
                         tol=tol, warm=warm, **kwargs)


def _as_artifact(prev, *, precision: str = "f32") -> SolverArtifact:
    if isinstance(prev, SolverArtifact):
        return prev
    if isinstance(prev, SMOResult):
        return artifact_from_result(prev, precision=precision)
    raise TypeError(
        f"expected a SolverArtifact or SMOResult, got {type(prev).__name__}")


def fit_update(
    prev,
    X_new,
    spec: Optional[SlabSpec] = None,
    *,
    min_overlap: float = 0.5,
    stats_out: Optional[dict] = None,
    **kwargs,
) -> SMOResult:
    """Delta-solve: re-fit on ``X_new`` warm-started from a prior fit.

    ``prev`` is a ``SolverArtifact`` (or an ``SMOResult``, converted).
    Rows are matched by content hash — appended rows enter with zero
    coefficient, expired rows' contribution is subtracted from the
    f-cache with the same fused rank-s sweep the hot loop runs — so the
    solve starts next to the prior optimum.

    When the overlap fraction falls below ``min_overlap`` the call falls
    back to a cold ``fit``; the routing is recorded in ``stats_out``
    (``mode``: "warm" | "cold", plus the overlap/fresh/expired/correction
    counts and ``P``). The same cold route — with ``stats_out["fallback"]``
    saying why — is taken when the warm path cannot run: an explicit
    ``gamma0`` of X_new's length among the kwargs (the solvers take
    ``warm=`` or ``gamma0=``, not both), or a solver raising
    ``NotImplementedError``. A ``gamma0`` of another length is stale and
    dropped.

    ``spec`` defaults to the artifact's; kwargs flow to ``fit``
    (strategy, precision, tol, device, ...). ``precision`` defaults to
    the artifact's so the warm correction rows are rounded to the same
    Gram tiles the prior solve streamed.
    """
    precision = kwargs.pop("precision", None)
    art = _as_artifact(prev, precision=precision or "f32")
    if precision is None:
        precision = art.precision
    if spec is None:
        spec = art.spec
    X_new = as_rows(X_new, resolve_device(kwargs.get("device")))
    warm, info = prepare_warm_start(art, X_new, spec, precision=precision)
    mode = "warm" if info.overlap_frac >= min_overlap else "cold"
    fallback = None
    g0 = kwargs.get("gamma0")
    if g0 is not None:
        if int(np.shape(g0)[0]) == int(X_new.shape[0]):
            # An explicit dual seed and a warm-start seed are mutually
            # exclusive in the solvers: take the cold route, where gamma0
            # IS the seed.
            mode = "cold"
            fallback = "gamma0_conflict"
        else:
            # A seed pinned to a previous data shape cannot seed any fit
            # on X_new: drop it so the warm/cold routing above stands.
            kwargs.pop("gamma0")
            fallback = "gamma0_stale_dropped"
    p_injected = False
    if mode == "warm" and "P" not in kwargs:
        # A delta-solve's violators concentrate on the delta (fresh rows
        # acquire mass, corrected rows re-equilibrate): a working set
        # scaled with the delta touches most of the moving set in one
        # rank-2P sweep. Capped at m/16.
        moving = info.n_fresh + info.n_corr
        kwargs["P"] = max(8, min(64, info.m // 16,
                                 1 << max(moving // 2, 1).bit_length()))
        p_injected = True
    if stats_out is not None:
        stats_out.update(dataclasses.asdict(info))
        stats_out["mode"] = mode
        stats_out["P"] = kwargs.get("P")
        if fallback is not None:
            stats_out["fallback"] = fallback
    if mode == "cold":
        return fit(X_new, spec, precision=precision, **kwargs)
    try:
        return fit(X_new, spec, precision=precision, warm_start=warm,
                   **kwargs)
    except NotImplementedError as e:
        # A streaming refresh degrades to a cold refit, never a traceback
        # after the warm state was prepared.
        if stats_out is not None:
            stats_out["mode"] = "cold"
            stats_out["fallback"] = f"warm_unsupported: {e}"
        if p_injected:
            kwargs.pop("P", None)   # sized for the warm route only
        return fit(X_new, spec, precision=precision, **kwargs)


def serve(X=None, spec: Optional[SlabSpec] = None, *,
          model: Optional[str] = None, registry=None,
          quota: Optional[int] = None, **kwargs):
    """Train-then-serve: a warm ``ServingModel`` ready to ``score(q)``.

    Hits the process-wide warm-model cache (fit + SV compaction + packing
    happen once per (spec, data, kwargs) key). kwargs flow to
    ``ModelCache.get_or_fit`` (cache=, offsets=, sv_threshold=, tn=,
    precision=) and on to ``fit`` (strategy, device, tol, P, ...).

    ``model=`` switches on multi-model routing: with ``X`` the recipe is
    registered under that name in ``registry`` (default: the
    process-wide ``repro_torch.serve.default_registry()``; idempotent — a
    *different* recipe under the same name raises
    ``DuplicateModelError``) and the registry's warm model comes back;
    without ``X`` it is a pure name lookup (``UnknownModelError`` if
    absent). ``quota=`` records the per-model admission budget the
    ``AdmissionController`` enforces.
    """
    from repro_torch.serve.registry import serve as _serve
    return _serve(X, spec, model=model, registry=registry, quota=quota,
                  **kwargs)
