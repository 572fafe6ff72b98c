"""Rho recovery + KKT diagnostics + MVP gap, written once for every solver.

All statistics are local masked reductions followed by a combine through
a ``Comm`` object:

* ``LocalComm`` — one device: the combine is the identity (free).
* ``MeshComm``  — one process per rank under ``torch.distributed``: sums
  and maxes over the mesh's data axes. Min-reductions ride as negated
  maxes, so one ``pmax`` of a stacked vector covers every extremum and
  one ``psum`` every sum and count.

Two variants of the per-iteration statistics bundle:

* ``solver_stats_fresh`` — recover rho first, then measure violations
  against the fresh rho (the paper recomputes each step); the local
  default.
* ``solver_stats_prev`` — measure violations against the previous
  iteration's rho, so rho recovery and the diagnostics share one round
  trip (2 collectives); the sharded default. A one-step-stale violation
  count delays termination by at most one iteration (convergence is
  gated on the gap, which is always fresh).

``hi``/``lo``/``m`` are the box bounds and problem size. Every scalar
stays an f32 (or int32) tensor on the solve's device: the arithmetic is
the reference's f32 arithmetic, never Python doubles.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective: op kind, solve phase, the per-device payload bytes
    and the iter epoch (which solve's loop it belongs to)."""

    op: str       # "psum" | "pmax" | "all_gather" | "broadcast"
    phase: str    # "init" (once per solve) | "iter" (once per iteration)
    nbytes: int   # per-device payload estimate
    epoch: int = 0   # distinguishes iter phases of successive solves


class CollectiveLedger:
    """Collective-bytes accounting for the sharded solver.

    Every ``MeshComm`` reduction or gather records (op, phase, bytes)
    here. The records tagged phase="iter" are one iteration's collective
    bill — the O(P d) budget — and the "init" records the one-time
    start-up cost (the all-gather of X and gamma in
    ``ShardedGram.init_scores`` plus the two initial stats passes).

    The JAX package's ledger fills when the solve is traced, and its
    loop body is traced once. This one fills as the collectives run, so
    the driver records the "iter" phase for the first iteration of each
    solve and then stops recording (phase ``None``) until the next phase
    is set: ``iteration_bytes`` / ``iteration_ops`` mean the same in both
    packages. Where the JAX package's compile cache skips re-recording (a
    repeated "sweep" of the same geometry), this ledger counts what ran.

    Bytes are per-device payload estimates from the shapes: operand bytes
    for psum/pmax, gathered-output bytes for all_gather, whatever the
    backend's algorithm moves on the wire.

    Phases: "init" (once per solve), "iter" (once per iteration), and
    "sweep" (once per shrinking repack round — the sharded KKT sweep's
    O(m d) gather, kept out of the per-iteration bill).
    """

    def __init__(self):
        self.records: List[CollectiveRecord] = []
        self._phase: Optional[str] = "init"
        self._iter_epoch = 0
        # Host seconds spent in the collectives of every MeshComm holding
        # this ledger (the wait for the peers included), and their number:
        # every call, recorded or not.
        self.seconds = 0.0
        self.calls = 0

    def set_phase(self, phase: Optional[str]) -> None:
        # Entering "iter" starts a new epoch: one ledger threaded through
        # several solves (the sharded shrinking driver's rounds) reports
        # the per-iteration bill of ONE solve, not the sum of them.
        if phase == "iter" and self._phase != "iter":
            self._iter_epoch += 1
        self._phase = phase

    def record(self, op: str, nbytes: int) -> None:
        if self._phase is None:
            return
        self.records.append(CollectiveRecord(
            op, self._phase, int(nbytes),
            self._iter_epoch if self._phase == "iter" else 0))

    def phase_bytes(self, phase: str) -> int:
        if phase == "iter":
            return self.iteration_bytes
        return sum(r.nbytes for r in self.records if r.phase == phase)

    def phase_ops(self, phase: str) -> int:
        if phase == "iter":
            return self.iteration_ops
        return sum(1 for r in self.records if r.phase == phase)

    def _iter_epochs(self) -> dict:
        out: dict = {}
        for r in self.records:
            if r.phase == "iter":
                b, n = out.get(r.epoch, (0, 0))
                out[r.epoch] = (b + r.nbytes, n + 1)
        return out

    @property
    def iteration_bytes(self) -> int:
        """Per-device collective bytes of ONE iteration of the most
        expensive solve sharing this ledger."""
        ep = self._iter_epochs()
        return max((b for b, _ in ep.values()), default=0)

    @property
    def iteration_ops(self) -> int:
        ep = self._iter_epochs()
        return max((n for _, n in ep.values()), default=0)

    def summary(self) -> dict:
        out = {
            "init_bytes": self.phase_bytes("init"),
            "init_ops": self.phase_ops("init"),
            "iteration_bytes": self.iteration_bytes,
            "iteration_ops": self.iteration_ops,
        }
        for phase in sorted({r.phase for r in self.records}
                            - {"init", "iter"}):
            out[f"{phase}_bytes"] = self.phase_bytes(phase)
            out[f"{phase}_ops"] = self.phase_ops(phase)
        return out


def _payload_bytes(x: Tensor) -> int:
    return x.numel() * x.element_size()


class LocalComm:
    """Single-device combine: reductions are already global."""

    axes: Tuple[str, ...] = ()

    def psum(self, x: Tensor) -> Tensor:
        return x

    def pmax(self, x: Tensor) -> Tensor:
        return x


class MeshComm:
    """Sums, maxes and gathers over a mesh's data axes, one process per
    rank (``repro_torch.launch.mesh.SolverMesh``).

    ``psum``/``pmax`` are ``all_reduce`` (SUM / MAX) and ``all_gather`` is
    ``torch.distributed.all_gather`` on the process group over ``axes``;
    each returns a new tensor on the operand's device and leaves the
    operand alone. With no mesh, or a one-rank group, they are the
    identity (``all_gather(tiled=False)`` adds the leading axis of one).

    Both backends take the operands where they lie: NCCL on the card,
    gloo on the host or on the card (on an H100 with torch 2.11 gloo
    took CUDA tensors for every call made here — all_reduce SUM and MAX,
    all_gather, broadcast — staging them through the host itself), so no
    operand is copied to the host here.

    With ``ledger`` set, every call records its per-device payload there
    (gathered-output bytes for ``all_gather``: local bytes x n_shards) and
    adds its host seconds to ``ledger.seconds``.
    """

    def __init__(self, axes: Sequence[str], *,
                 sizes: Optional[Sequence[int]] = None,
                 ledger: Optional[CollectiveLedger] = None, mesh=None):
        self.axes = tuple(axes)
        if sizes is None and mesh is not None:
            sizes = tuple(mesh.shape[ax] for ax in self.axes)
        self.sizes = None if sizes is None else tuple(int(s) for s in sizes)
        self.ledger = ledger
        self.group = None if mesh is None else mesh.group(self.axes)

    @property
    def n_shards(self) -> Optional[int]:
        if self.sizes is None:
            return None
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def _record(self, op: str, nbytes: int) -> None:
        if self.ledger is not None:
            self.ledger.record(op, nbytes)

    def _timed(self, t0: float) -> None:
        if self.ledger is not None:
            self.ledger.seconds += time.perf_counter() - t0
            self.ledger.calls += 1

    @staticmethod
    def _operand(x: Tensor) -> Tensor:
        # A copy the collective may overwrite in place.
        return x.contiguous().clone()

    def _reduce(self, op: str, x: Tensor, red) -> Tensor:
        self._record(op, _payload_bytes(x))
        if self.group is None:
            return x
        t0 = time.perf_counter()
        y = self._operand(x)
        dist.all_reduce(y, op=red, group=self.group)
        self._timed(t0)
        return y

    def psum(self, x: Tensor) -> Tensor:
        return self._reduce("psum", x, dist.ReduceOp.SUM)

    def pmax(self, x: Tensor) -> Tensor:
        return self._reduce("pmax", x, dist.ReduceOp.MAX)

    def all_gather(self, x: Tensor, *, tiled: bool = True) -> Tensor:
        """Every rank's ``x`` in rank order: concatenated along axis 0
        (``tiled``) or stacked on a new leading axis."""
        n = self.n_shards
        self._record("all_gather",
                     _payload_bytes(x) * (n if n is not None else 1))
        if self.group is None:
            return x if tiled else x[None]
        t0 = time.perf_counter()
        y = self._operand(x)
        parts = [torch.empty_like(y)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, y, group=self.group)
        out = torch.cat(parts) if tiled else torch.stack(parts)
        self._timed(t0)
        return out

    def broadcast(self, x: Tensor) -> Tensor:
        """The group's first rank's ``x`` on every rank (the others pass
        a tensor of the same shape and type). The JAX package has no such
        call; the sharded shrinking driver uses it where the JAX package
        gathers the active set to one shard."""
        self._record("broadcast", _payload_bytes(x))
        if self.group is None:
            return x
        t0 = time.perf_counter()
        y = self._operand(x)
        dist.broadcast(y, src=dist.get_global_rank(self.group, 0),
                       group=self.group)
        self._timed(t0)
        return y


LOCAL_COMM = LocalComm()


def _f32(v, like: Tensor) -> Tensor:
    # torch.full, not torch.tensor: a fill launches on the device instead
    # of copying from the host and waiting for it.
    return torch.full((), v, dtype=like.dtype, device=like.device)


def slab_margin(scores: Tensor, rho1: Tensor, rho2: Tensor) -> Tensor:
    """f_bar(x) = min(s - rho1, rho2 - s) (paper eq. 56)."""
    return torch.minimum(scores - rho1, rho2 - scores)


def violation(gamma: Tensor, scores: Tensor, rho1: Tensor, rho2: Tensor, *,
              hi: float, lo: float, m: int,
              valid: Optional[Tensor] = None,
              bound_tol: float = 1e-8) -> Tensor:
    """Per-sample KKT violation magnitude (>= 0), the paper's 5 cases
    (eq. 49-53) phrased as per-plane score distances:

        gamma_i = 0          -> rho1 <= s_i <= rho2
        0 < gamma_i < hi     -> s_i = rho1
        gamma_i = hi         -> s_i <= rho1
        lo < gamma_i < 0     -> s_i = rho2
        gamma_i = lo         -> s_i >= rho2
    """
    bt_hi = hi * bound_tol * m
    bt_lo = -lo * bound_tol * m

    at_zero = torch.abs(gamma) <= min(bt_hi, bt_lo)
    at_hi = gamma >= hi - bt_hi
    at_lo = gamma <= lo + bt_lo
    free_pos = (~at_zero) & (~at_hi) & (gamma > 0)
    free_neg = (~at_zero) & (~at_lo) & (gamma < 0)

    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    v = torch.where(
        at_zero,
        torch.clamp_min(torch.maximum(rho1 - scores, scores - rho2), 0.0),
        zero)
    v = torch.where(free_pos, torch.abs(scores - rho1), v)
    v = torch.where(at_hi, torch.clamp_min(scores - rho1, 0.0), v)
    v = torch.where(free_neg, torch.abs(scores - rho2), v)
    v = torch.where(at_lo, torch.clamp_min(rho2 - scores, 0.0), v)
    if valid is not None:
        v = torch.where(valid, v, zero)
    return v


def _masked(valid: Optional[Tensor], mask: Tensor) -> Tensor:
    return mask if valid is None else (valid & mask)


def _rho_from_parts(sum1, n1, sum2, n2, r1_lo, r1_hi, r2_lo, r2_hi, big):
    """Free-SV means with KKT-interval-midpoint fallback (eq. 20-21)."""
    mean1 = sum1 / torch.clamp_min(n1, 1.0)
    mean2 = sum2 / torch.clamp_min(n2, 1.0)
    half = big / 2
    r1_mid = torch.where((r1_lo > -half) & (r1_hi < half),
                         0.5 * (r1_lo + r1_hi),
                         torch.where(r1_hi < half, r1_hi, r1_lo))
    r2_mid = torch.where((r2_lo > -half) & (r2_hi < half),
                         0.5 * (r2_lo + r2_hi),
                         torch.where(r2_lo > -half, r2_lo, r2_hi))
    rho1 = torch.where(n1 > 0, mean1, r1_mid)
    rho2 = torch.where(n2 > 0, mean2, r2_mid)
    return rho1, rho2


def _rho_masks(gamma: Tensor, valid: Optional[Tensor], *, hi: float,
               lo: float, m: int, tol: float):
    ghi = hi * tol * m      # absolute slack scaled to the box size
    glo = -lo * tol * m
    return dict(
        free_lower=_masked(valid, (gamma > ghi) & (gamma < hi - ghi)),
        free_upper=_masked(valid, (gamma < -glo) & (gamma > lo + glo)),
        at_hi=_masked(valid, gamma >= hi - ghi),
        at_lo=_masked(valid, gamma <= lo + glo),
        nonneg=_masked(valid, gamma >= -glo),   # gamma >= 0: s <= rho2 side
        nonpos=_masked(valid, gamma <= ghi),    # gamma <= 0: s >= rho1 side
    )


def recover_rhos(gamma: Tensor, scores: Tensor, *, hi: float, lo: float,
                 m: int, comm: LocalComm = LOCAL_COMM,
                 valid: Optional[Tensor] = None,
                 tol: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """rho1 / rho2 from on-margin SVs, midpoint fallback when a plane has
    no free SV. ``big`` is the f32 sentinel finfo.max / 4, as a tensor of
    the scores' dtype."""
    dtype = scores.dtype
    big = _f32(torch.finfo(dtype).max / 4, scores)
    zero = torch.zeros((), dtype=dtype, device=scores.device)
    mk = _rho_masks(gamma, valid, hi=hi, lo=lo, m=m, tol=tol)

    ps = comm.psum(torch.stack([
        torch.sum(torch.where(mk["free_lower"], scores, zero)),
        torch.sum(mk["free_lower"]).to(dtype),
        torch.sum(torch.where(mk["free_upper"], scores, zero)),
        torch.sum(mk["free_upper"]).to(dtype),
    ]))
    pm = comm.pmax(torch.stack([
        torch.max(torch.where(mk["at_hi"], scores, -big)),
        torch.max(torch.where(mk["nonneg"], scores, -big)),
        -torch.min(torch.where(mk["nonpos"], scores, big)),
        -torch.min(torch.where(mk["at_lo"], scores, big)),
    ]))
    return _rho_from_parts(ps[0], ps[1], ps[2], ps[3],
                           pm[0], -pm[2], pm[1], -pm[3], big)


def _gap_masks(gamma: Tensor, valid: Optional[Tensor], *, hi: float,
               lo: float):
    bnd = 1e-8 * (hi - lo)            # bound-identification slack
    up = _masked(valid, gamma < hi - bnd)    # can increase
    dn = _masked(valid, gamma > lo + bnd)    # can decrease
    return up, dn


def solver_stats_fresh(gamma: Tensor, f: Tensor, rho1_prev: Tensor,
                       rho2_prev: Tensor, recompute_rho: bool, *, hi: float,
                       lo: float, m: int, tol: float,
                       comm: LocalComm = LOCAL_COMM,
                       valid: Optional[Tensor] = None):
    """(rho1, rho2, n_viol, max_viol, gap) with violations vs FRESH rho."""
    neg = _f32(-float("inf"), f)
    pos = _f32(float("inf"), f)

    if recompute_rho:
        rho1, rho2 = recover_rhos(gamma, f, hi=hi, lo=lo, m=m, comm=comm,
                                  valid=valid)
    else:
        rho1, rho2 = rho1_prev, rho2_prev

    v = violation(gamma, f, rho1, rho2, hi=hi, lo=lo, m=m, valid=valid)
    up, dn = _gap_masks(gamma, valid, hi=hi, lo=lo)
    n_viol = comm.psum(torch.sum(v > tol).to(f.dtype)).to(torch.int32)
    pm = comm.pmax(torch.stack([
        torch.max(v),
        torch.max(torch.where(dn, f, neg)),
        -torch.min(torch.where(up, f, pos)),
    ]))
    gap = pm[1] + pm[2]
    return rho1, rho2, n_viol, pm[0], gap


def solver_stats_prev(gamma: Tensor, f: Tensor, rho1_prev: Tensor,
                      rho2_prev: Tensor, recompute_rho: bool, *, hi: float,
                      lo: float, m: int, tol: float,
                      comm: LocalComm = LOCAL_COMM,
                      valid: Optional[Tensor] = None):
    """(rho1, rho2, n_viol, max_viol, gap) in exactly 2 collectives.

    psum vector: [sum_free_lower_f, n_free_lower, sum_free_upper_f,
                  n_free_upper, n_violators]
    pmax vector: [r1_lo, r2_lo, -r1_hi, -r2_hi, max_viol,
                  max_f_down, -min_f_up]       (mins as negated maxes)

    Violations are measured against ``rho*_prev`` so the rho sums and the
    violation stats share one round trip.
    """
    dtype = f.dtype
    big = _f32(torch.finfo(dtype).max / 4, f)
    neg = _f32(-float("inf"), f)
    pos = _f32(float("inf"), f)
    zero = torch.zeros((), dtype=dtype, device=f.device)

    mk = _rho_masks(gamma, valid, hi=hi, lo=lo, m=m, tol=1e-6)
    up, dn = _gap_masks(gamma, valid, hi=hi, lo=lo)
    v = violation(gamma, f, rho1_prev, rho2_prev, hi=hi, lo=lo, m=m,
                  valid=valid)

    ps = comm.psum(torch.stack([
        torch.sum(torch.where(mk["free_lower"], f, zero)),
        torch.sum(mk["free_lower"]).to(dtype),
        torch.sum(torch.where(mk["free_upper"], f, zero)),
        torch.sum(mk["free_upper"]).to(dtype),
        torch.sum(v > tol).to(dtype),
    ]))
    pm = comm.pmax(torch.stack([
        torch.max(torch.where(mk["at_hi"], f, -big)),
        torch.max(torch.where(mk["nonneg"], f, -big)),
        -torch.min(torch.where(mk["nonpos"], f, big)),
        -torch.min(torch.where(mk["at_lo"], f, big)),
        torch.max(v),
        torch.max(torch.where(dn, f, neg)),
        -torch.min(torch.where(up, f, pos)),
    ]))

    if recompute_rho:
        rho1, rho2 = _rho_from_parts(ps[0], ps[1], ps[2], ps[3],
                                     pm[0], -pm[2], pm[1], -pm[3], big)
    else:
        rho1, rho2 = rho1_prev, rho2_prev
    return rho1, rho2, ps[4].to(torch.int32), pm[4], pm[5] + pm[6]
