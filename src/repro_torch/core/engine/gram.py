"""GramProvider — the pluggable Gram-access axis of the solver engine.

A provider owns the training rows and answers the kernel-matrix queries
the SMO hot loop needs, each against a ``Selection`` of 2P rows:

* ``init_scores(gamma)``          — f = K @ gamma (once, at solve start)
* ``block(sel)``                  — the (2P, 2P) Gram block of the pairs
* ``apply_update(f, sel, delta)`` — f + K[:, sel] @ delta (rank-2P update,
                                    the per-iteration hot path)
* ``scatter(gamma, sel, delta)``  — fold the pair steps back into gamma

Implementations:

* ``precomputed`` — materialize K once (O(m^2) memory; small m / tests).
* ``on_the_fly``  — recompute the needed kernel rows from X per iteration.
* ``pallas``      — ``FusedGram``: ``on_the_fly`` with the f-cache update
                    fused into the ``fupdate`` CUDA kernel (one pass over
                    X per iteration; the name is the JAX package's, so
                    call sites match).
* ``sharded``     — ``ShardedGram``: a rank's local rows under the
                    row-sharded solver; updates touch only the local f
                    and gamma slices through the same ``fupdate`` kernel,
                    selections arrive as gathered (2P, d) row blocks.

Every provider takes a ``precision`` ("f32" default, "bf16", "f16"): the
training rows are round-tripped through the tile dtype ONCE at
construction, so the plain providers see exactly the rounded values the
fused provider streams in 16 bits. Norms, the f-cache, gamma and all
epilogues stay f32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine.types import Selection
from repro_torch.core.kernel_fn import KernelFn
from repro_torch.kernels.fupdate.ops import (as_tile, fupdate, row_norms,
                                             wide_rows)
from repro_torch.kernels.precision import (check_precision, round_to_tile,
                                           tile_dtype)
from repro_torch.kernels.tiling import FUPDATE_NARROW_MAX_S

Tensor = torch.Tensor

# Largest m for a single unblocked cross-kernel pass; above this,
# row-blocked accumulation keeps the working set at O(BLOCK * m).
SINGLE_PASS_MAX = 4096
BLOCK = 2048


def raw_scores_blocked(X: Tensor, gamma: Tensor, kernel: KernelFn,
                       block: int = BLOCK) -> Tensor:
    """K @ gamma without materializing K (row-blocked above the threshold)."""
    m = X.shape[0]
    if m <= SINGLE_PASS_MAX:
        return kernel.cross(X, X) @ gamma
    return torch.cat([kernel.cross(X[i:i + block], X) @ gamma
                      for i in range(0, m, block)])


class _ScoreDeltas:
    """Shared O(s * m) score-delta algebra — the warm-start substrate.

    ``delta_scores`` folds a rank-s kernel contribution into an f-cache
    with ONE pass over the owned rows (the ``fupdate`` kernel under the
    fused provider); ``append_rows``/``expire_rows`` compose it with a
    provider rebuild so a data delta costs O(dm * m) instead of the
    O(m^2) cold init; ``reconcile_scores`` turns a warm start's seeded
    f-cache into the new problem's exact K @ gamma0.
    """

    def delta_scores(self, f: Tensor, X_delta: Tensor,
                     g_delta: Tensor) -> Tensor:
        """f + k(X_own, X_delta) @ g_delta — one pass, no m^2 anything."""
        if X_delta.shape[0] == 0:
            return f
        return f + self.kernel.rows(self.X, X_delta) @ g_delta

    def reconcile_scores(self, warm) -> Tensor:
        """Fold a warm start's correction set (``f_seed``, ``x_corr``,
        ``delta``) into its seeded f-cache."""
        return self.delta_scores(warm.f_seed, warm.x_corr, warm.delta)

    def append_rows(self, X_app, gamma: Tensor, f: Tensor):
        """(provider', gamma', f') for the extended problem [X; X_app].

        Appended rows enter with gamma = 0 (fresh data), so surviving
        scores are untouched; their own scores cost one O(dm * m) pass.
        Host-side API (between solves).
        """
        dev = self.X.device
        Xa = round_to_tile(torch.as_tensor(X_app, dtype=torch.float32,
                                           device=dev)
                           .reshape(-1, self.X.shape[1]), self.precision)
        p2 = self._rebuilt_extended(Xa)
        gamma2 = torch.cat([gamma.to(torch.float32),
                            torch.zeros((Xa.shape[0],), dtype=torch.float32,
                                        device=dev)])
        # The appended rows' own scores against the full extended set.
        f_app = self.kernel.rows(p2.X, Xa).T @ gamma2
        return p2, gamma2, torch.cat([f, f_app])

    def expire_rows(self, idx, gamma: Tensor, f: Tensor):
        """(provider', gamma', f') with rows ``idx`` removed — O(e * m).

        Surviving scores lose the expired rows' kernel columns times
        their gamma (one rank-e sweep); no O(m^2) recompute. Host-side
        API (between solves).
        """
        dev = self.X.device
        idx = np.asarray(idx, np.int64).reshape(-1)
        keep = np.setdiff1d(np.arange(self.X.shape[0]), idx)
        idx_t = torch.as_tensor(idx, device=dev)
        keep_t = torch.as_tensor(keep, device=dev)
        f2 = self.delta_scores(f, self.X[idx_t], -gamma[idx_t])[keep_t]
        return self._rebuilt_shrunk(keep_t), gamma[keep_t], f2


class PrecomputedGram(_ScoreDeltas):
    """Materialized m x m Gram matrix: every query is a gather/matmul."""

    name = "precomputed"

    def __init__(self, X: Tensor, kernel: KernelFn, precision: str = "f32",
                 *, _K: Tensor | None = None):
        self.precision = check_precision(precision)
        self.X = round_to_tile(X, precision)
        self.kernel = kernel
        self.K = kernel.gram(self.X) if _K is None else _K
        self._diag = kernel.diag(self.X)

    def _rebuilt_extended(self, Xa: Tensor) -> "PrecomputedGram":
        # Extend K with the new cross block — O(dm * m) kernel values,
        # not a fresh O(m^2) gram.
        C = self.kernel.rows(self.X, Xa)              # (m, dm)
        K2 = torch.cat([torch.cat([self.K, C], dim=1),
                        torch.cat([C.T, self.kernel.cross(Xa, Xa)], dim=1)])
        return PrecomputedGram(torch.cat([self.X, Xa]), self.kernel,
                               self.precision, _K=K2)

    def _rebuilt_shrunk(self, keep: Tensor) -> "PrecomputedGram":
        return PrecomputedGram(self.X[keep], self.kernel, self.precision,
                               _K=self.K[keep][:, keep])

    def diag(self) -> Tensor:
        return self._diag

    def column(self, i) -> Tensor:
        return self.K[:, i]

    def init_scores(self, gamma: Tensor) -> Tensor:
        return self.K @ gamma

    def prepare(self, sel: Selection) -> Selection:
        # Gather the 2P columns once; block() and apply_update() both
        # read them.
        if sel.rows is None:
            sel = sel._replace(rows=self.K[:, sel.ids])
        return sel

    def block(self, sel: Selection) -> Tensor:
        if sel.rows is not None:
            return sel.rows[sel.ids]
        return self.K[sel.ids][:, sel.ids]

    def diag_sel(self, sel: Selection) -> Tensor:
        return self._diag[sel.ids]

    def apply_update(self, f: Tensor, sel: Selection,
                     delta: Tensor) -> Tensor:
        rows = self.K[:, sel.ids] if sel.rows is None else sel.rows
        return f + rows @ delta

    def scatter(self, gamma: Tensor, sel: Selection,
                delta: Tensor) -> Tensor:
        # index_add accumulates duplicate ids, as jax's .at[].add does.
        return gamma.index_add(0, sel.ids, delta)


class OnTheFlyGram(_ScoreDeltas):
    """Recompute the <= 2P needed kernel rows from X each iteration."""

    name = "on_the_fly"

    def __init__(self, X: Tensor, kernel: KernelFn, precision: str = "f32"):
        self.precision = check_precision(precision)
        self.X = round_to_tile(X, precision)
        self.kernel = kernel
        self._diag = kernel.diag(self.X)

    # type(self): a rebuilt FusedGram is a FusedGram, with its own tile
    # rows and norms.
    def _rebuilt_extended(self, Xa: Tensor) -> "OnTheFlyGram":
        return type(self)(torch.cat([self.X, Xa]), self.kernel,
                          self.precision)

    def _rebuilt_shrunk(self, keep: Tensor) -> "OnTheFlyGram":
        return type(self)(self.X[keep], self.kernel, self.precision)

    def diag(self) -> Tensor:
        return self._diag

    def column(self, i) -> Tensor:
        return self.kernel.rows(self.X, self.X[i][None, :])[:, 0]

    def init_scores(self, gamma: Tensor) -> Tensor:
        return raw_scores_blocked(self.X, gamma, self.kernel)

    def prepare(self, sel: Selection) -> Selection:
        return sel   # rows are recomputed exactly where needed

    def block(self, sel: Selection) -> Tensor:
        if sel.rows is not None:
            return sel.rows[sel.ids]
        return self.kernel.cross(sel.X, sel.X)

    def diag_sel(self, sel: Selection) -> Tensor:
        return self._diag[sel.ids]

    def apply_update(self, f: Tensor, sel: Selection,
                     delta: Tensor) -> Tensor:
        rows = (self.kernel.rows(self.X, sel.X) if sel.rows is None
                else sel.rows)
        return f + rows @ delta

    def scatter(self, gamma: Tensor, sel: Selection,
                delta: Tensor) -> Tensor:
        return gamma.index_add(0, sel.ids, delta)


class FusedGram(OnTheFlyGram):
    """on_the_fly with the rank-2P f update fused into the ``fupdate``
    kernel. The tile-dtype rows and their f32 norms are made once here,
    so each iteration's launch reads X and nothing else of size m*d."""

    name = "pallas"

    def __init__(self, X: Tensor, kernel: KernelFn, precision: str = "f32"):
        super().__init__(X, kernel, precision=precision)
        # self.X is already tile-rounded, so this cast is exact.
        self.X_tile = as_tile(self.X, tile_dtype(precision))
        self.norms = row_norms(self.X_tile)
        # The wide launches' rows (S > 32), laid out once: 16-bit rows on
        # the card padded for TMA when d % 8 != 0, else X_tile itself.
        # The narrow launches read X_tile as it is.
        self.X_wide = wide_rows(self.X_tile)

    def _fupdate(self, f: Tensor, X_sel: Tensor, delta: Tensor) -> Tensor:
        x = (self.X_wide if X_sel.shape[0] > FUPDATE_NARROW_MAX_S
             else self.X_tile)
        return fupdate(x, X_sel, delta, f, self.kernel,
                       precision=self.precision, xn=self.norms)

    def init_scores(self, gamma: Tensor) -> Tensor:
        if self.X.shape[0] <= BLOCK:
            # f = 0 + k(X, X) @ gamma in one fused pass (the JAX package
            # takes this branch below the same threshold).
            return self._fupdate(torch.zeros_like(gamma), self.X, gamma)
        return raw_scores_blocked(self.X, gamma, self.kernel)

    def apply_update(self, f: Tensor, sel: Selection,
                     delta: Tensor) -> Tensor:
        if sel.rows is not None:
            # A selector already produced the full columns.
            return f + sel.rows @ delta
        return self._fupdate(f, sel.X, delta)

    def delta_scores(self, f: Tensor, X_delta: Tensor,
                     g_delta: Tensor) -> Tensor:
        # The warm-start reconcile sweep IS the hot-loop update with the
        # correction set as the selected block; above BLOCK rows the JAX
        # package takes the plain pass, and so does this one.
        if X_delta.shape[0] == 0:
            return f
        if X_delta.shape[0] > BLOCK:
            return super().delta_scores(f, X_delta, g_delta)
        return self._fupdate(f, X_delta, g_delta)


# The reference's name for the fused provider (repro.core.engine).
PallasGram = FusedGram


class ShardedGram(FusedGram):
    """A rank's local rows under the row-sharded solver; f and gamma are
    local slices.

    ``gids`` are this rank's global row ids (``rank * m_local + i``);
    selections carry gathered (2P, d) row blocks, so the per-iteration
    update needs no communication at all — only ``init_scores`` gathers
    (once). The rank-2P update is ``FusedGram``'s ``fupdate`` launch on
    the local rows, with the tile rows, norms and wide layout it makes
    once.

    ``comm`` is the facade's ``MeshComm`` over the data axes: the init
    gathers go through it, so an attached ``CollectiveLedger`` sees every
    collective this provider issues.

    Precision: ``X_local`` arrives tile-rounded (the facade rounds once,
    before building provider and selector), so the selector's gathered
    rows are the rows the kernel streams.
    """

    name = "sharded"

    def __init__(self, X_local: Tensor, kernel: KernelFn, *, gids: Tensor,
                 rank: int, m_local: int, m_pad: int, comm,
                 precision: str = "f32"):
        super().__init__(X_local, kernel, precision=precision)
        self.gids = gids
        self.rank = rank
        self.m_local = m_local
        self.m_pad = m_pad
        self.comm = comm
        self.axes = comm.axes

    def init_scores(self, gamma_local: Tensor) -> Tensor:
        # The local f needs the global K @ gamma: gather X and gamma once,
        # then accumulate over column blocks of BLOCK rows (the JAX
        # package's plain pass, outside any kernel).
        X_all = self.comm.all_gather(self.X, tiled=True)
        g_all = self.comm.all_gather(gamma_local, tiled=True)
        acc = torch.zeros((self.m_local,), dtype=torch.float32,
                          device=self.X.device)
        for i in range(0, self.m_pad, BLOCK):
            acc = acc + self.kernel.cross(self.X, X_all[i:i + BLOCK]) \
                @ g_all[i:i + BLOCK]
        return acc

    def block(self, sel: Selection) -> Tensor:
        return self.kernel.cross(sel.X, sel.X)

    def diag_sel(self, sel: Selection) -> Tensor:
        return self.kernel.diag(sel.X)

    def scatter(self, gamma: Tensor, sel: Selection,
                delta: Tensor) -> Tensor:
        # Only the ids in this rank's range land here; the others add 0
        # at a clipped slot (no host read of how many are in range).
        loc = sel.ids - self.rank * self.m_local
        in_range = (loc >= 0) & (loc < self.m_local)
        return gamma.index_add(0, loc.clamp(0, self.m_local - 1),
                               torch.where(in_range, delta,
                                           torch.zeros_like(delta)))

    def append_rows(self, X_app, gamma: Tensor, f: Tensor):
        """Sharded append is a facade-level operation (row placement,
        gids and m_pad change on every rank), so the provider's share is
        the score algebra only (``delta_scores`` / ``reconcile_scores``
        on the local slice); the distributed facade re-shards and takes
        ``warm=``."""
        raise NotImplementedError(
            "sharded append is handled by the distributed facade "
            "(re-shard + warm=); use delta_scores for the local f algebra")

    def expire_rows(self, idx, gamma: Tensor, f: Tensor):
        raise NotImplementedError(
            "sharded expiry is handled by the distributed facade "
            "(re-shard + warm=); use delta_scores for the local f algebra")


def make_provider(gram_mode: str, X: Tensor, kernel: KernelFn,
                  precision: str = "f32"):
    """Build a local provider by name ("sharded" is constructed
    explicitly by the distributed facade: it needs the shard layout)."""
    if gram_mode == "precomputed":
        return PrecomputedGram(X, kernel, precision=precision)
    if gram_mode == "on_the_fly":
        return OnTheFlyGram(X, kernel, precision=precision)
    if gram_mode == "pallas":
        return FusedGram(X, kernel, precision=precision)
    raise ValueError(f"unknown gram_mode {gram_mode!r}")
