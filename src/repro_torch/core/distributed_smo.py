"""Data-parallel blocked SMO over a mesh of processes (engine facade).

The training set X, the dual vector gamma and the f-cache are sharded by
rows across the mesh's data axes (("data",) single-pod, ("pod", "data")
multi-pod — ``repro_torch.launch.mesh.make_solver_mesh`` builds both).
The JAX package runs the solve inside ``shard_map``; here it runs SPMD
over ``torch.distributed``: one process per rank, every process calling
this facade with the same arguments (the global X included) and keeping
its own slice of the rows. The solve is the same engine driver as the
single-device solvers, with the sharded provider and selector:

1. ``ShardedBlockSelector``: every rank proposes its local top-P grow /
   top-P shrink candidates; one all_gather of the packed candidate set
   (O(P) scalars + P*d floats per rank, independent of m) makes the
   selection identical on every rank,
2. the Gauss-Seidel pair solve runs replicated (2P x 2P block),
3. ``ShardedGram`` applies the rank-2P f update to the local rows only —
   no communication — through the same ``fupdate`` kernel as the
   single-device provider, and scatters delta-gamma into the local slice,
4. rho recovery and the convergence tests are the fused statistics
   (``engine.stats.solver_stats_prev``): one psum of a stacked vector
   plus one pmax per iteration.

Per-iteration communication is O(P d), independent of m; compute per
rank is O(m_local d). Pass a ``CollectiveLedger`` to get that bill
itemized (``ledger.iteration_bytes``). Each facade ends with one gather
that puts the global gamma and f on every rank (the JAX package's
``out_specs``; not billed, as there).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core.engine.types import SMOResult
from repro_torch.core.ocssvm import (OCSSVMModel, SlabSpec, concrete_spec,
                                     feasible_init)
from repro_torch.kernels.precision import round_to_tile

Tensor = torch.Tensor

__all__ = ["solve_blocked_distributed", "sharded_raw_scores"]


def _shard_geometry(m: int, mesh, data_axes: Tuple[str, ...]):
    """(sizes, n_shards, m_pad, m_local) for row-sharding m over the
    mesh's data axes."""
    sizes = tuple(int(mesh.shape[ax]) for ax in data_axes)
    n_shards = 1
    for s_ in sizes:
        n_shards *= s_
    m_pad = ((m + n_shards - 1) // n_shards) * n_shards
    return sizes, n_shards, m_pad, m_pad // n_shards


def _pad_rows(x: Tensor, m_pad: int) -> Tensor:
    pad = m_pad - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def gather_rows(mesh, data_axes: Tuple[str, ...], *local: Tensor,
                m: int) -> Tuple[Tensor, ...]:
    """Each local (m_local,) slice assembled into its global (m,) vector
    on every rank, all in one all_gather (the JAX package's row-sharded
    ``out_specs``; not billed to any ledger)."""
    comm = engine.MeshComm(data_axes, mesh=mesh)
    g = comm.all_gather(torch.stack([t.to(torch.float32) for t in local]),
                        tiled=False)                  # (n, k, m_local)
    full = g.transpose(0, 1).reshape(len(local), -1)[:, :m]
    return tuple(full[i].to(t.dtype) for i, t in enumerate(local))


def solve_blocked_distributed(
    X: Tensor,
    spec: SlabSpec,
    mesh,
    *,
    data_axes: Tuple[str, ...] = ("data",),
    P_pairs: int = 8,
    tol: float = 1e-4,
    max_outer: int = 50_000,
    patience: int = 20,
    fused_stats: bool = True,
    rho_every: int = 1,
    precision: str = "f32",
    gamma0: Optional[Tensor] = None,
    warm=None,
    ledger: Optional[engine.CollectiveLedger] = None,
    device=None,
) -> SMOResult:
    """Solve the OCSSVM dual with X row-sharded over ``data_axes``.

    Every rank of ``mesh`` calls this with the same arguments; each
    solves on its slice of rows, on ``device`` (default: X's device), and
    gets the global result back. Rows are padded to ``m_pad = ceil(m /
    n_shards) * n_shards``; the pad rows are masked out everywhere.

    fused_stats: kept for the JAX package's signature; the sharded
    statistics (``solver_stats_prev``, 2 collectives an iteration) are
    always the fused ones. rho_every=k recomputes rho1/rho2 every k
    iterations. precision: Gram tile-input dtype — the rows are rounded
    once, before provider and selector, so a distributed solve matches
    its single-device counterpart at any precision. gamma0 warm-starts
    the solve (the sharded shrinking driver re-enters here between
    rounds). warm: an ``engine.WarmStart`` over the global rows — each
    rank takes its slice of gamma0 and f_seed, the correction set is used
    whole, and each rank reconciles its own f slice with one local
    ``fupdate`` sweep: the warm init costs no collective (the cold init
    all-gathers X and gamma). Mutually exclusive with gamma0. ledger: a
    ``CollectiveLedger`` that records every collective's per-device
    payload, split into "init" (once) and "iter" (per iteration).
    """
    del fused_stats
    if warm is not None and gamma0 is not None:
        raise ValueError("pass warm= or gamma0=, not both")
    spec = concrete_spec(spec)
    dev = X.device if device is None else torch.device(device)
    X32 = X.to(device=dev, dtype=torch.float32)
    m = X32.shape[0]
    kernel = spec.kernel
    sizes, n_shards, m_pad, m_local = _shard_geometry(m, mesh, data_axes)
    rank = mesh.axis_rank(data_axes)
    rows = slice(rank * m_local, (rank + 1) * m_local)

    valid = (torch.arange(m_pad, device=dev) < m)[rows]
    if warm is not None:
        g0 = warm.gamma0
    elif gamma0 is None:
        g0 = feasible_init(m, spec, torch.float32, device=dev)
    else:
        g0 = gamma0
    g_l = _pad_rows(g0.to(device=dev, dtype=torch.float32), m_pad)[rows]

    comm = engine.MeshComm(data_axes, sizes=sizes, ledger=ledger, mesh=mesh)
    # Tile-round once, before provider AND selector: both then see the
    # same rows and nothing re-rounds per iteration.
    X_l = round_to_tile(_pad_rows(X32, m_pad)[rows], precision)
    gids = rank * m_local + torch.arange(m_local, device=dev)
    hi, lo = spec.upper(m), spec.lower(m)
    provider = engine.ShardedGram(X_l, kernel, gids=gids, rank=rank,
                                  m_local=m_local, m_pad=m_pad, comm=comm,
                                  precision=precision)
    selector = engine.ShardedBlockSelector(X_l, P=P_pairs, hi=hi, lo=lo,
                                           gids=gids, valid=valid,
                                           comm=comm)
    stats_fn = partial(engine.solver_stats_prev, hi=hi, lo=lo, m=m, tol=tol,
                       comm=comm, valid=valid)
    w_l = None
    if warm is not None:
        # The local f_seed slice + the whole correction set: the
        # reconcile sweep is purely rank-local.
        f_l = _pad_rows(warm.f_seed.to(device=dev, dtype=torch.float32),
                        m_pad)[rows]
        w_l = engine.WarmStart(gamma0=g_l, f_seed=f_l,
                               x_corr=warm.x_corr.to(dev),
                               delta=warm.delta.to(dev))
    state0 = engine.init_state(provider, stats_fn, g_l, ledger=ledger,
                               warm=w_l)
    s = engine.run(provider, selector, stats_fn, state0, hi=hi, lo=lo,
                   tol=tol, max_iters=max_outer, patience=patience,
                   rho_every=rho_every, ledger=ledger)
    gamma, f = gather_rows(mesh, data_axes, s.gamma, s.f, m=m)
    model = OCSSVMModel(gamma=gamma, rho1=s.rho1, rho2=s.rho2, X=X32,
                        spec=spec)
    return SMOResult(model=model, iters=s.it, n_viol=s.n_viol,
                     max_viol=s.max_viol, gap=s.gap, converged=s.gap <= tol,
                     f=f)


def sharded_raw_scores(
    X: Tensor,
    gamma: Tensor,
    kernel,
    mesh,
    *,
    data_axes: Tuple[str, ...] = ("data",),
    precision: str = "f32",
    ledger: Optional[engine.CollectiveLedger] = None,
    device=None,
) -> Tensor:
    """f = K @ gamma with X row-sharded over the mesh's data axes.

    Each rank gathers X and gamma once and accumulates its local rows'
    scores over column blocks (``ShardedGram.init_scores``) — the sharded
    counterpart of ``raw_scores_blocked``, used by the sharded shrinking
    driver's full-set KKT sweeps; every rank gets the global f back. The
    ledger bills the O(m d) gather under its own "sweep" phase: it is
    once-per-repack-round work, not part of the per-iteration bill.
    """
    dev = X.device if device is None else torch.device(device)
    X32 = X.to(device=dev, dtype=torch.float32)
    m = X32.shape[0]
    sizes, n_shards, m_pad, m_local = _shard_geometry(m, mesh, data_axes)
    rank = mesh.axis_rank(data_axes)
    rows = slice(rank * m_local, (rank + 1) * m_local)
    if ledger is not None:
        ledger.set_phase("sweep")
    comm = engine.MeshComm(data_axes, sizes=sizes, ledger=ledger, mesh=mesh)
    X_l = round_to_tile(_pad_rows(X32, m_pad)[rows], precision)
    g_l = _pad_rows(gamma.to(device=dev, dtype=torch.float32), m_pad)[rows]
    provider = engine.ShardedGram(
        X_l, kernel, gids=rank * m_local + torch.arange(m_local, device=dev),
        rank=rank, m_local=m_local, m_pad=m_pad, comm=comm,
        precision=precision)
    f_l = provider.init_scores(g_l)
    return gather_rows(mesh, data_axes, f_l, m=m)[0]
