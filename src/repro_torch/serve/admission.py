"""Deadline-aware admission: coalescing windows in front of the service.

The synchronous ``ScoringService`` loop is the deterministic core —
it decides what one flush does. This layer decides *when* a flush
happens, per model, from three signals:

* **bucket fill** — a model's open window reaching ``max_batch`` rows
  flushes immediately at submit time (more coalescing can't help: the
  next row would start a second launch anyway);
* **deadline pressure** — ``poll()`` flushes a window when waiting any
  longer would miss its earliest deadline, *given the observed
  per-bucket latency* from that model's ``BucketStats``: the window is
  due once ``now + estimated_flush_latency >= earliest_deadline``.
  Buckets never observed cost ``fallback_latency_s`` (default 0.0 =
  coalesce maximally until evidence arrives);
* **explicit** — ``flush_model`` / ``drain`` / ``handle.result()``;
* **dead deadline** — a submit onto a window whose earliest deadline has
  ALREADY passed (or whose own deadline passed while the model's
  first-use fit ran) flushes inline at submit time: queueing behind a
  dead deadline would otherwise wait for the next ``poll()``, which
  under real traffic may never come (the event-loop driver in
  ``repro_torch.serve.async_driver`` exists so one does, but correctness must
  not depend on it).

Windows are **continuous**: a flush pops the model's window and a
concurrent submit immediately opens the next one — late arrivals join
the next launch instead of blocking on the in-flight one (admission
takes only the short state lock once the model's service is warm; the
per-model lock serializes the launches, not the queueing). Per-model
window occupancy counters (``windows opened/flushed``, rows and
requests per flush) ride ``stats_dict``.

Requests carry ``(model, deadline)``; over-quota traffic (the
registry's per-model ``quota``, in rows held queued) is rejected at
submit with the typed ``QuotaExceededError`` — a full window sheds load
instead of growing an unbounded backlog.

Awaitable admission: ``submit_async`` resolves an ``asyncio`` future
when the batch lands (no busy-wait on ``Pending``); the background
``AsyncDriver`` wakes on ``next_due_time()`` via the ``add_waker`` hook
and calls ``poll()`` so deadlines are honored with nobody polling.

Time enters ONLY through the injected ``clock`` (default
``time.monotonic``), shared with every per-model ``ScoringService`` the
controller builds — so every policy decision (``due``, latency
estimates, deadline ordering) is unit-testable with a fake clock and no
sleeps. Deadlines are absolute times on that clock.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serve.scorer import BUCKETS
from repro_torch.serve.service import Pending, ScoringService


class QuotaExceededError(RuntimeError):
    """Typed rejection: admitting the request would hold more rows
    queued for the model than its registered quota allows."""

    def __init__(self, model: str, quota: int, queued_rows: int,
                 requested_rows: int):
        self.model = model
        self.quota = quota
        self.queued_rows = queued_rows
        self.requested_rows = requested_rows
        super().__init__(
            f"model {model!r}: admitting {requested_rows} rows onto "
            f"{queued_rows} already queued would exceed the quota of "
            f"{quota} rows")


class AdmissionHandle:
    """Handle for one admitted request.

    ``result()`` forces the owning model's window if the controller has
    not flushed it yet — the synchronous escape hatch, mirroring
    ``Pending.result``.
    """

    def __init__(self, controller: "AdmissionController", model: str,
                 n: int, deadline: Optional[float]):
        self._controller = controller
        self.model = model
        self.n = n
        self.deadline = deadline
        self._pending: Optional[Pending] = None
        self._error: Optional[BaseException] = None
        self._cb_lock = threading.Lock()
        self._done_cbs: List[Callable[["AdmissionHandle"], None]] = []

    # -- completion plumbing (flush thread side) ----------------------------
    def _bind(self, pending: Pending) -> None:
        # chains the service handle's completion to ours, so a flush —
        # whoever runs it — resolves awaitables without any polling
        self._pending = pending
        pending.add_done_callback(self._fire)

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._fire()

    def _fire(self) -> None:
        with self._cb_lock:
            cbs, self._done_cbs = self._done_cbs, []
        for cb in cbs:
            cb(self)

    def add_done_callback(
            self, cb: Callable[["AdmissionHandle"], None]) -> None:
        """Run ``cb(handle)`` once the request resolves — with scores or
        with a flush-time error (immediately if it already has).
        Callbacks fire on whichever thread completes the flush."""
        with self._cb_lock:
            if not self.done:
                self._done_cbs.append(cb)
                return
        cb(self)

    @property
    def flushed(self) -> bool:
        """The request has left the admission window for the service."""
        return self._pending is not None

    @property
    def done(self) -> bool:
        """Resolved — with scores, or with a flush-time error that
        ``result()`` will raise (e.g. the recipe was replaced with an
        incompatible feature dim after this request was admitted)."""
        if self._error is not None:
            return True
        return self._pending is not None and self._pending.done

    def result(self):
        # Route through the controller (model lock) whenever the score
        # isn't ready — not only when un-flushed. If another thread is
        # mid-flush (_pending bound, launches still running), going
        # straight to Pending.result() would re-enter the non-thread-
        # safe service flush; flush_model instead blocks on the model
        # lock until that flush completes.
        if not self.done:
            self._controller.flush_model(self.model)
        if self._error is not None:
            raise self._error
        return self._pending.result()


class _Window:
    """One model's open coalescing window."""

    __slots__ = ("items", "rows", "earliest_deadline", "opened_at")

    def __init__(self, now: float):
        self.items: List[Tuple[object, AdmissionHandle]] = []
        self.rows = 0
        self.earliest_deadline = math.inf
        self.opened_at = now


@dataclasses.dataclass
class _WindowStats:
    """Per-model window occupancy: how full launches actually run.

    ``opened``/``flushed`` count windows; ``flushed_rows`` over
    ``flushed`` gives the mean fill a flush ships (against ``max_batch``
    that is the coalescing efficiency). ``inline_flushes`` counts
    dead-deadline submits (window flushed at submit time because its
    earliest deadline had already passed); ``aborted`` counts requests
    failed by ``abort_pending`` (driver crash surfacing).
    """

    opened: int = 0
    flushed: int = 0
    flushed_rows: int = 0
    flushed_requests: int = 0
    max_rows: int = 0
    inline_flushes: int = 0
    aborted: int = 0


class AdmissionController:
    """Per-model deadline-aware windows over per-model scoring services.

    ``registry`` is anything with ``get(name) -> ServingModel`` and
    ``quota(name) -> Optional[int]`` — a ``ModelRegistry`` in
    production, a stub in tests. Services are built lazily per model
    (first submit for a name pays that name's fit-on-first-use through
    the registry) and share the controller's injected ``clock``; if the
    registry exposes a ``version(name)`` lifecycle counter (the real
    one does), a version bump — evict/refresh/replace — rebuilds the
    memoized service, so post-refresh traffic scores against the fresh
    model instead of a stale scorer.

    Locking is two-level so the fleet never serializes on one model:
    a short controller-wide state lock guards the window/service maps,
    and a per-model lock serializes the expensive work — fit-on-first-
    use and the actual kernel launches of a flush. One model's cold fit
    or slow launch never blocks another model's admission.

    ``safety_factor`` scales latency estimates (>1 flushes earlier than
    the point estimate says is necessary); ``max_wait_s`` bounds how
    long a *deadline-less* window may sit open before ``poll`` flushes
    it (None = only bucket fill / explicit flushes move it; windows
    with deadlines are governed by deadline pressure alone).

    Note the quota/bucket-fill interaction: quota bounds rows that
    would *remain* queued, and an admission that reaches ``max_batch``
    flushes the window instead of growing it — a rejection therefore
    needs ``quota < queued_rows < max_batch``, so only quotas of at
    most ``max_batch - 2`` can ever bind; the controller warns once per
    model when a registered quota cannot.
    """

    def __init__(self, registry, *,
                 clock: Callable[[], float] = time.monotonic,
                 max_batch: int = BUCKETS[-1],
                 fallback_latency_s: float = 0.0,
                 safety_factor: float = 1.0,
                 max_wait_s: Optional[float] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if safety_factor <= 0:
            raise ValueError(f"safety_factor must be > 0, "
                             f"got {safety_factor}")
        self.registry = registry
        self.clock = clock
        self.max_batch = max_batch
        self.fallback_latency_s = fallback_latency_s
        self.safety_factor = safety_factor
        self.max_wait_s = max_wait_s
        self._services: Dict[str, ScoringService] = {}
        self._service_versions: Dict[str, int] = {}
        self._windows: Dict[str, _Window] = {}
        self._model_locks: Dict[str, threading.RLock] = {}
        self._quota_warned: set = set()
        self.rejected: Dict[str, int] = {}
        self._window_stats: Dict[str, _WindowStats] = {}
        # Wakers: zero-arg callables poked after every admission that
        # leaves a window open — the async driver registers one so a new
        # (possibly earlier) deadline re-arms its sleep immediately.
        self._wakers: List[Callable[[], None]] = []
        # Short state lock (window/service/counter maps only — never
        # held across a fit or a kernel launch). RLock: policy helpers
        # re-enter it from poll()/due().
        self._lock = threading.RLock()

    # -- locking ------------------------------------------------------------
    def _model_lock(self, model: str) -> threading.RLock:
        with self._lock:
            lk = self._model_locks.get(model)
            if lk is None:
                lk = self._model_locks[model] = threading.RLock()
            return lk

    def _registry_version(self, model: str) -> int:
        version = getattr(self.registry, "version", None)
        return version(model) if version is not None else 0

    # -- services -----------------------------------------------------------
    def service(self, model: str) -> ScoringService:
        """The model's scoring service (built on first use — this is
        where an unfitted registered recipe pays its one fit, under the
        MODEL's lock only). Rebuilt when the registry's lifecycle
        version for the name moves (evict/refresh/replace) — but the
        old service's observed per-bucket latencies carry over: a
        refresh swaps the model weights, not the launch cost of a
        bucket, and resetting the estimates to ``fallback_latency_s``
        would blind the deadline policy right after every refresh."""
        # Fast path first, WITHOUT the model lock: a memoized service at
        # the current registry version is an immutable read, and taking
        # the model lock here would stall every warm submit behind an
        # in-flight flush's kernel launches — the opposite of continuous
        # admission.
        ver = self._registry_version(model)
        with self._lock:
            svc = self._services.get(model)
            if svc is not None \
                    and self._service_versions.get(model) == ver:
                return svc
        with self._model_lock(model):
            ver = self._registry_version(model)
            with self._lock:
                svc = self._services.get(model)
                if svc is not None \
                        and self._service_versions.get(model) == ver:
                    return svc
            old = svc
            sm = self.registry.get(model)    # may fit: no state lock held
            svc = ScoringService(sm.scorer(), max_batch=self.max_batch,
                                 clock=self.clock)
            if old is not None:
                with old._stats_lock:
                    svc.stats = dict(old.stats)
            self._warn_unbindable_quota(model)
            with self._lock:
                self._services[model] = svc
                self._service_versions[model] = ver
            return svc

    def _warn_unbindable_quota(self, model: str,
                               quota: Optional[int] = None) -> None:
        # A rejection needs quota < rows+n < max_batch (reaching
        # max_batch flushes instead), so a binding quota satisfies
        # quota <= max_batch - 2; anything above can never reject.
        if quota is None:
            quota = self.registry.quota(model)
        if quota is None or quota <= self.max_batch - 2:
            return
        with self._lock:
            if model in self._quota_warned:
                return
            self._quota_warned.add(model)
        warnings.warn(
            f"model {model!r}: quota {quota} rows cannot bind with "
            f"max_batch {self.max_batch} — rejection needs "
            f"quota < queued_rows < max_batch, and any admission "
            f"reaching max_batch triggers the bucket-fill flush first; "
            f"set quota <= {self.max_batch - 2} to shed load",
            RuntimeWarning, stacklevel=3)

    # -- admission ----------------------------------------------------------
    def submit(self, model: str, q, *,
               deadline: Optional[float] = None) -> AdmissionHandle:
        """Admit one request for ``model``; returns its handle.

        ``deadline`` is an absolute time on the controller's clock by
        which the caller wants the request *served* (None = indifferent:
        the request rides whatever flush its window gets). Raises
        ``QuotaExceededError`` when admitting would leave more rows
        *queued* than the model's quota — an admission that immediately
        triggers the bucket-fill flush drains the window instead of
        growing it, so it can never breach the quota. Routing errors
        (``UnknownModelError``) surface from the registry unchanged.

        Admission is continuous: once the model's service is warm, the
        append runs under the short state lock only, so submits land in
        the NEXT window while a flush's launches are still running under
        the model lock. A submit onto a window whose earliest deadline
        has already passed flushes it inline (see module docstring —
        correctness must not depend on anyone polling).
        """
        if getattr(q, "ndim", None) != 2:
            raise ValueError(f"queries must be (n, d), got "
                             f"{getattr(q, 'shape', q)}")
        n = int(q.shape[0])
        if n < 1:
            raise ValueError("need at least one query row per request")
        # Admission decisions run BEFORE the service is resolved: a
        # rejected request must not pay (or trigger) the model's
        # fit-on-first-use. registry.quota also routes, so unknown
        # names fail here, cheaply.
        quota = self.registry.quota(model)
        # re-checked per submit: set_quota() after the service was
        # memoized must still trip the one-time unbindable warning
        self._warn_unbindable_quota(model, quota)
        with self._lock:
            win = self._windows.get(model)
            rows = win.rows if win is not None else 0
        if quota is not None and rows + n < self.max_batch \
                and rows + n > quota:
            with self._lock:
                self.rejected[model] = self.rejected.get(model, 0) + 1
            raise QuotaExceededError(model, quota, rows, n)
        svc = self.service(model)       # memoized fast path: no model lock
        svc.scorer._check(q)            # feature dim needs the model
        handle = AdmissionHandle(self, model, n, deadline)
        with self._lock:
            # The append — and the quota re-check, which must be atomic
            # with it now that admission races flushes — runs under the
            # state lock only. A concurrent flush pops the window under
            # this same lock, so this submit either rides the outgoing
            # window or opens the next one; it never waits for launches.
            win = self._windows.get(model)
            rows = win.rows if win is not None else 0
            full = rows + n >= self.max_batch   # admit -> instant flush
            if quota is not None and not full and rows + n > quota:
                self.rejected[model] = self.rejected.get(model, 0) + 1
                raise QuotaExceededError(model, quota, rows, n)
            if win is None:
                # no window is created for a rejected request (above):
                # an empty one would backdate the next admitted
                # request's age under max_wait_s
                win = self._windows[model] = _Window(self.clock())
                self._wstats(model).opened += 1
            win.items.append((q, handle))
            win.rows += n
            if deadline is not None:
                win.earliest_deadline = min(win.earliest_deadline,
                                            deadline)
            # Dead deadline: already passed — possibly while THIS call
            # paid the model's fit-on-first-use above. Queueing behind
            # it would wait for a poll() that may never come.
            dead = win.earliest_deadline <= self.clock()
            if dead:
                self._wstats(model).inline_flushes += 1
        if full or dead:
            self.flush_model(model)
        else:
            self._notify_wakers()
        return handle

    def queued_rows(self, model: str) -> int:
        """Rows currently held in the model's open window."""
        with self._lock:
            win = self._windows.get(model)
            return win.rows if win is not None else 0

    def _wstats(self, model: str) -> _WindowStats:
        # caller holds self._lock
        ws = self._window_stats.get(model)
        if ws is None:
            ws = self._window_stats[model] = _WindowStats()
        return ws

    def submit_async(self, model: str, q, *,
                     deadline: Optional[float] = None):
        """Awaitable admission: like ``submit`` but returns an
        ``asyncio`` future that resolves with the scores when the batch
        lands (or raises the flush-time error).

        Must be called from a running event loop (the future is bound to
        it; completion hops threads via ``call_soon_threadsafe`` — the
        flush runs wherever the driver or a poller runs). Admission-time
        errors (quota, routing, shape) still raise synchronously, before
        any future exists: they are the caller's bug or back-pressure
        signal, not a batch outcome. Nothing here flushes: pair with a
        running ``AsyncDriver`` (or explicit polling) or the future may
        never resolve.
        """
        import asyncio

        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        handle = self.submit(model, q, deadline=deadline)

        def _on_done(h: AdmissionHandle) -> None:
            err, pending = h._error, h._pending

            def _apply() -> None:
                if fut.cancelled():
                    return
                if err is not None:
                    fut.set_exception(err)
                else:
                    fut.set_result(pending.result())  # done: no flush

            loop.call_soon_threadsafe(_apply)

        handle.add_done_callback(_on_done)
        return fut

    # -- driver hooks --------------------------------------------------------
    def add_waker(self, waker: Callable[[], None]) -> None:
        """Register a zero-arg callable poked after every admission that
        leaves a window open — the driver's re-arm signal."""
        with self._lock:
            self._wakers.append(waker)

    def remove_waker(self, waker: Callable[[], None]) -> None:
        with self._lock:
            try:
                self._wakers.remove(waker)
            except ValueError:
                pass

    def _notify_wakers(self) -> None:
        with self._lock:
            wakers = list(self._wakers)
        for w in wakers:        # outside the lock: wakers take their own
            w()

    def next_due_time(self) -> Optional[float]:
        """Earliest clock time any open window becomes due on its own —
        the driver sleeps until then. None when no window can (empty
        fleet, or deadline-less windows with no ``max_wait_s`` bound:
        only bucket fill or an explicit flush moves those)."""
        with self._lock:
            t: Optional[float] = None
            now = self.clock()
            for m, win in self._windows.items():
                if not win.items:
                    continue
                if win.rows >= self.max_batch:
                    cand = now                  # already due
                elif math.isfinite(win.earliest_deadline):
                    cand = win.earliest_deadline \
                        - self.estimate_latency_s(m)
                elif self.max_wait_s is not None:
                    cand = win.opened_at + self.max_wait_s
                else:
                    continue
                t = cand if t is None else min(t, cand)
            return t

    def abort_pending(self, exc: BaseException) -> int:
        """Fail every queued (un-flushed) request with ``exc``; returns
        how many were failed. The driver calls this when it dies with
        windows still open: a crashed driver must surface to awaiting
        callers, not strand them on futures that never resolve. Handles
        raise ``exc`` from ``result()``; in-flight flushes (already
        popped) complete normally."""
        with self._lock:
            wins = dict(self._windows)
            self._windows.clear()
            for m, win in wins.items():
                self._wstats(m).aborted += len(win.items)
        failed = 0
        for win in wins.values():
            for _, h in win.items:
                h._fail(exc)
                failed += 1
        return failed

    # -- policy -------------------------------------------------------------
    def estimate_latency_s(self, model: str,
                           rows: Optional[int] = None) -> float:
        """Expected wall-clock to serve ``rows`` (default: the model's
        current window) if flushed now.

        Sums the observed mean latency of each launch the scorer's
        ``launch_plan`` predicts, read from the service's per-bucket
        ``BucketStats``, plus the service's observed per-window flush
        overhead (concat/scatter/callbacks — roughly fixed per window,
        so for a fast model it dominates the launches and no
        multiplicative margin could cover it); a bucket with no
        observations yet costs ``fallback_latency_s``. Scaled by
        ``safety_factor``.
        """
        with self._lock:
            svc = self._services.get(model)
            if rows is None:
                rows = self.queued_rows(model)
            if rows <= 0:
                return 0.0
            if svc is None:
                return self.fallback_latency_s * self.safety_factor
            total = svc.mean_flush_overhead_s
            for _, bucket in svc.scorer.launch_plan(rows):
                s = svc.stats.get(bucket)
                total += (s.mean_latency_s if s is not None and s.batches
                          else self.fallback_latency_s)
        return total * self.safety_factor

    def due(self, model: str, now: Optional[float] = None) -> bool:
        """Should ``model``'s window flush now?

        True when the window is at capacity or under deadline pressure:
        flushing takes ``estimate_latency_s``, so once
        ``now + estimate >= earliest_deadline`` any further coalescing
        would miss the deadline. ``max_wait_s`` applies only to windows
        with NO deadline — a deadline is a stronger statement of when
        the caller needs the rows, and the age bound must not override
        it by flushing early.
        """
        with self._lock:
            win = self._windows.get(model)
            if win is None or not win.items:
                return False
            if win.rows >= self.max_batch:
                return True
            if now is None:
                now = self.clock()
            if math.isfinite(win.earliest_deadline):
                return now + self.estimate_latency_s(model) \
                    >= win.earliest_deadline
            return (self.max_wait_s is not None
                    and now - win.opened_at >= self.max_wait_s)

    # -- flushing -----------------------------------------------------------
    def poll(self) -> int:
        """Flush every due window, earliest deadline first; returns the
        number of kernel launches. Call this from the serving loop
        between arrivals — it never blocks on anything but the launches
        themselves (and on no other model's lock: the due list is taken
        under the short state lock, the launches run per model)."""
        with self._lock:
            now = self.clock()
            due = [m for m in list(self._windows) if self.due(m, now)]
            due.sort(key=lambda m: (self._windows[m].earliest_deadline, m))
        return sum(self.flush_model(m) for m in due)

    def flush_model(self, model: str) -> int:
        """Flush one model's window unconditionally."""
        with self._model_lock(model):
            return self._flush_under_model_lock(model)

    def drain(self) -> int:
        """Flush everything (earliest deadline first) — end of stream."""
        with self._lock:
            order = sorted(
                self._windows,
                key=lambda m: (self._windows[m].earliest_deadline, m))
        return sum(self.flush_model(m) for m in order)

    def _flush_under_model_lock(self, model: str) -> int:
        # caller holds this model's lock, so no one else can mutate this
        # model's window or service underneath us. Resolve the service
        # BEFORE popping the window: if it raises (the name was
        # unregistered between submit and flush, or a post-evict re-fit
        # failed), the window — and every queued request in it — stays
        # intact, the error surfaces to the caller, and a later flush
        # can still serve the handles once the name is healthy again.
        with self._lock:
            win = self._windows.get(model)
            if win is None or not win.items:
                return 0
        svc = self.service(model)
        with self._lock:
            win = self._windows.pop(model, None)
            if win is not None and win.items:
                # occupancy is recorded at the pop — the instant the
                # window closes and the next one can open
                ws = self._wstats(model)
                ws.flushed += 1
                ws.flushed_rows += win.rows
                ws.flushed_requests += len(win.items)
                ws.max_rows = max(ws.max_rows, win.rows)
        if win is None or not win.items:
            return 0
        for q, handle in win.items:
            try:
                handle._bind(svc.submit(q))
            except Exception as e:
                # Exception, NOT BaseException: KeyboardInterrupt/
                # SystemExit must stop the loop, not be filed away.
                # This request is permanently unservable against the
                # CURRENT model (admission validated against the old one
                # before a replace): fail ITS handle — result() raises —
                # and keep serving the rest of the window. Raising here
                # would abort poll()'s loop over other healthy models.
                handle._fail(e)
        if all(h._pending is None for _, h in win.items):
            return 0
        return svc.flush()

    def forget(self, model: str) -> None:
        """Release every per-model structure for a retired name: the
        memoized service (and with it the packed model buffers the
        scorer pins), window, lock, and counters.

        The open window is flushed first so nothing queued is silently
        dropped — call this BEFORE ``registry.unregister`` (or after a
        ``drain``), while the name still resolves. Without it a
        long-lived controller over a churning fleet would pin each
        retired tenant's packed support set forever.
        """
        with self._model_lock(model):
            self._flush_under_model_lock(model)
            with self._lock:
                self._services.pop(model, None)
                self._service_versions.pop(model, None)
                self._windows.pop(model, None)
                self.rejected.pop(model, None)
                self._window_stats.pop(model, None)
                self._quota_warned.discard(model)
                # the lock entry itself stays: popping it while another
                # thread is blocked on it would let a later submit mint
                # a second lock and run two "model-locked" sections
                # concurrently on one service. An RLock per name ever
                # seen is noise next to the model buffers released above.

    # -- introspection ------------------------------------------------------
    def _stat_names(self) -> List[str]:
        # every name the controller has state for — a model whose only
        # traffic was rejected (service never resolved, by design: a
        # reject must not pay the fit) still shows its shed load
        with self._lock:
            return sorted(set(self._services) | set(self._windows)
                          | set(self.rejected) | set(self._window_stats))

    def stats_dict(self) -> Dict[str, dict]:
        """Per-model stats: the service's per-bucket counters plus the
        window occupancy / rejection state — the multi-model BENCH JSON
        shape."""
        with self._lock:
            return {
                m: {"buckets": (self._services[m].stats_dict()
                                if m in self._services else {}),
                    "queued_rows": self.queued_rows(m),
                    "rejected": self.rejected.get(m, 0),
                    "windows": dataclasses.asdict(
                        self._window_stats.get(m, _WindowStats()))}
                for m in self._stat_names()
            }

    def stats_lines(self) -> List[str]:
        lines = []
        with self._lock:
            for m in self._stat_names():
                rej = self.rejected.get(m, 0)
                ws = self._window_stats.get(m, _WindowStats())
                fill = (ws.flushed_rows / ws.flushed) if ws.flushed else 0.0
                lines.append(f"model={m},queued_rows={self.queued_rows(m)},"
                             f"rejected={rej},windows={ws.flushed}/"
                             f"{ws.opened},mean_fill_rows={fill:.1f}")
                svc = self._services.get(m)
                if svc is not None:
                    lines.extend("  " + ln for ln in svc.stats_lines())
        return lines
