"""Micro-batching request loop over a ``BatchScorer``.

Scoring cost is dominated by the support-set pass, not the query rows —
so the service coalesces queued requests into one kernel launch: submit
enqueues and returns a handle, ``flush`` concatenates queued rows up to
the top padding bucket, scores the group once, and scatters each slice
back to its handle. Per-bucket latency/throughput counters expose where
the traffic actually lands (``chip_smoke.py``'s [fleet] phase prints
them).

Synchronous by design: this loop is the deterministic core the
admission layer (``repro_torch.serve.admission``) wraps — it decides *when*
to flush, this class decides *what one flush does*. Time enters only
through the injectable ``clock`` (default ``time.monotonic``), so
every latency counter — and every policy built on top of them — is
unit-testable with a fake clock and zero sleeps.

Requests are host rows at the service boundary (a tensor request is
copied to the host), so each launch's scores come back through a
device-to-host copy that waits for the kernel: every recorded launch
time ends at the device.

During a ``repro_torch.utils.trace`` recording, each coalesced group is
one ``repro_torch.service.flush`` span (rows, requests) with the
children ``.concat`` (the host rows joined) and ``.scatter`` (each
handle set, its done-callbacks run) beside the scorer's own.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.engine.state import host_f32
from repro_torch.serve.scorer import BUCKETS, BatchScorer
from repro_torch.utils import trace


@dataclasses.dataclass
class BucketStats:
    """Counters for one padding bucket.

    A launch recorded ``cold=True`` (the bucket's first launch on an
    un-warmed scorer, which may pay the kernel's build) is counted in the
    throughput totals but EXCLUDED from ``mean_latency_s`` once any warm
    observation exists — the admission layer's deadline estimates read
    that mean, and one build-laden sample would make every window
    after a model refresh flush pathologically early.
    """

    batches: int = 0          # kernel launches (cold included)
    queries: int = 0          # live (unpadded) rows scored
    requests: int = 0         # handles served
    total_s: float = 0.0      # summed launch wall-clock (cold included)
    last_s: float = 0.0
    cold_batches: int = 0     # first launches of an un-warmed bucket
    cold_s: float = 0.0       # their summed wall-clock

    def record(self, queries: int, requests: int, dt: float,
               cold: bool = False) -> None:
        """One launch's worth of accounting — flush records each kernel
        launch individually, so a record IS a launch."""
        self.batches += 1
        self.queries += queries
        self.requests += requests
        self.total_s += dt
        self.last_s = dt
        if cold:
            self.cold_batches += 1
            self.cold_s += dt

    @property
    def warm_batches(self) -> int:
        return self.batches - self.cold_batches

    @property
    def mean_latency_s(self) -> float:
        """Mean launch latency for ESTIMATES: warm launches only, unless
        cold launches are all we have (then the cold mean — which
        over-estimates and therefore flushes early, the safe side)."""
        if self.warm_batches > 0:
            return (self.total_s - self.cold_s) / self.warm_batches
        return self.total_s / self.batches if self.batches else 0.0

    @property
    def throughput_qps(self) -> float:
        return self.queries / self.total_s if self.total_s > 0 else 0.0


class Pending:
    """Handle for a submitted request; ``result()`` flushes if needed."""

    def __init__(self, service: "ScoringService", n: int):
        self._service = service
        self.n = n
        self._result = None
        self._done = False
        self._done_cbs: List[Callable[[], None]] = []

    def _set(self, scores) -> None:
        self._result = scores
        self._done = True
        cbs, self._done_cbs = self._done_cbs, []
        for cb in cbs:
            cb()

    def add_done_callback(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` when the scores land (immediately if they already
        have). Callbacks fire on the flushing thread — the async
        admission layer uses this to resolve awaitables without polling."""
        if self._done:
            cb()
        else:
            self._done_cbs.append(cb)

    @property
    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done:
            self._service.flush()
        return self._result


class ScoringService:
    """Coalesces queued scoring requests into bucket-sized launches."""

    def __init__(self, scorer: BatchScorer, *,
                 max_batch: int = BUCKETS[-1],
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.scorer = scorer
        self.max_batch = max_batch
        # All BucketStats timing goes through this: inject a fake to make
        # latency counters (and the admission policies fed by them)
        # deterministic in tests.
        self.clock = clock
        # deque: flush pops from the head per group — list.pop(0) is
        # O(queue) per pop, O(n^2) to drain a deep queue.
        self._queue: Deque[Tuple] = deque()   # [(q, Pending)]
        self.stats: Dict[int, BucketStats] = {}
        # Guards stats dict *shape* changes vs concurrent iteration: a
        # monitoring thread scraping stats_dict() while a flush files a
        # first-seen bucket must not hit "dict changed size". Single
        # .get() reads stay lock-free (atomic under the GIL).
        self._stats_lock = threading.Lock()
        # Buckets this service has already launched: the FIRST launch of
        # a bucket neither here nor pre-warmed on the scorer may pay the
        # kernel's build and is recorded cold (excluded from deadline
        # estimates).
        self._launched: set = set()
        # Per-group flush overhead: wall-clock spent OUTSIDE the kernel
        # launches (concat, host transfer, scatter, done callbacks).
        # Roughly fixed per window, so for fast models it dominates the
        # launches — an estimate built from launch means alone would
        # have the admission layer flush too late no matter the safety
        # factor (a multiplier cannot cover an additive cost).
        self.flush_groups: int = 0
        self.flush_overhead_s: float = 0.0

    @property
    def mean_flush_overhead_s(self) -> float:
        """Observed mean non-launch cost of serving one coalesced group
        (0.0 until a flush has run) — the additive term the admission
        layer's deadline estimate charges per window."""
        if self.flush_groups == 0:
            return 0.0
        return self.flush_overhead_s / self.flush_groups

    def warmup(self) -> None:
        """Launch every bucket once (building the kernel on first use);
        launches after a warmup are never recorded cold."""
        self.scorer.warmup()

    @property
    def queued_rows(self) -> int:
        return sum(p.n for _, p in self._queue)

    def submit(self, q) -> Pending:
        """Enqueue one request (n, d), n >= 1; returns its handle."""
        self.scorer._check(q)
        if int(q.shape[0]) < 1:
            raise ValueError("need at least one query row per request")
        p = Pending(self, int(q.shape[0]))
        self._queue.append((q, p))
        return p

    def score(self, q):
        """Submit + flush convenience for a single request."""
        return self.submit(q).result()

    def flush(self) -> int:
        """Drain the queue: group -> one launch per group -> scatter.

        Requests are grouped in arrival order until adding the next one
        would cross ``max_batch`` rows (an oversized single request forms
        its own group; the service scores it chunk by chunk so each
        launch is timed and filed under the bucket it actually used —
        full chunks land in the top bucket, the remainder in its own,
        possibly smaller, bucket). Returns the number of kernel
        launches. Group rows are concatenated host-side (requests arrive
        as host arrays at the service boundary; a tensor request is
        copied to the host).
        """
        launches = 0
        while self._queue:
            group = [self._queue.popleft()]
            rows = group[0][1].n
            while (self._queue
                   and rows + self._queue[0][1].n <= self.max_batch):
                item = self._queue.popleft()
                group.append(item)
                rows += item[1].n

            with trace.span("repro_torch.service.flush", rows=rows,
                            requests=len(group)):
                launches += self._serve_group(group, rows)
        return launches

    def _serve_group(self, group: List[Tuple], rows: int) -> int:
        """One coalesced group of ``rows`` rows: concatenate, one scorer
        call per planned launch, scatter; returns its launches."""
        t_group = self.clock()
        launch_s = 0.0
        with trace.span("repro_torch.service.concat"):
            if len(group) == 1:
                batch = host_f32(group[0][0])
            else:
                batch = np.concatenate([host_f32(q) for q, _ in group])

        # One scorer call per planned launch so every launch's
        # wall-clock and rows are credited to the bucket that really
        # served it (an oversized group spans several; the remainder
        # chunk's bucket can be smaller than the top one). The
        # group's request count is filed with the first launch — a
        # request belongs to one group. The per-chunk sync is the
        # price of honest per-launch timing: an oversized group pays
        # one host-device round-trip per extra chunk, on a path that
        # is already multiple full-bucket kernel launches deep.
        plan = self.scorer.launch_plan(rows)
        parts = []
        off = 0
        for i, (chunk_rows, bucket) in enumerate(plan):
            cold = (bucket not in self._launched
                    and bucket not in getattr(self.scorer,
                                              "warmed_buckets", ()))
            self._launched.add(bucket)
            t0 = self.clock()
            # numpy in, numpy out: the scores' device-to-host copy
            # waits for the kernel, so dt ends at the device.
            part = self.scorer.score(batch[off:off + chunk_rows])
            dt = self.clock() - t0
            launch_s += dt
            with self._stats_lock:
                self.stats.setdefault(bucket, BucketStats()).record(
                    chunk_rows, len(group) if i == 0 else 0, dt,
                    cold=cold)
            # Host-side from here: the launch is already synced (the
            # timing above blocks); numpy slices are O(1) views, and
            # results are host arrays, symmetric with the host-array
            # request boundary.
            parts.append(part)
            off += chunk_rows
        with trace.span("repro_torch.service.scatter"):
            scores = parts[0] if len(parts) == 1 else np.concatenate(parts)
            off = 0
            for _, p in group:
                p._set(scores[off:off + p.n])
                off += p.n
        with self._stats_lock:
            self.flush_groups += 1
            self.flush_overhead_s += max(
                0.0, (self.clock() - t_group) - launch_s)
        return len(plan)

    def stats_lines(self) -> List[str]:
        """Human/CSV-ready per-bucket counter lines."""
        with self._stats_lock:
            stats = dict(self.stats)
        lines = []
        for b in sorted(stats):
            s = stats[b]
            lines.append(
                f"bucket={b},batches={s.batches},requests={s.requests},"
                f"queries={s.queries},mean_ms={s.mean_latency_s*1e3:.2f},"
                f"last_ms={s.last_s*1e3:.2f},qps={s.throughput_qps:.0f},"
                f"cold={s.cold_batches}")
        return lines

    def stats_dict(self) -> Dict[int, Dict[str, float]]:
        with self._stats_lock:
            return {b: dataclasses.asdict(s) for b, s in self.stats.items()}


def run_request_stream(service: ScoringService, requests,
                       coalesce: Optional[int] = None) -> List:
    """Feed a request iterable through the service in coalesced windows.

    ``coalesce`` requests are submitted before each flush (default: let
    the queue grow to one full window per flush ~ the micro-batching
    sweet spot). Returns the scores in request order.
    """
    window = coalesce if coalesce is not None else 16
    handles = []
    for i, q in enumerate(requests):
        handles.append(service.submit(q))
        if (i + 1) % window == 0:
            service.flush()
    service.flush()
    return [h.result() for h in handles]
