"""Event-loop admission driver: deadlines honored with nobody polling.

``AdmissionController.poll()`` is pull-only — before this module, a
window's deadline was honored only if some caller happened to poll in
time. ``AsyncDriver`` closes that hole with one background daemon
thread that sleeps until the EARLIEST time any open window becomes due
(``controller.next_due_time()``), wakes, polls, and re-arms. It is
event-driven, not interval-polling: with no deadline pending the driver
parks indefinitely, and every admission pokes it through the
controller's waker hook so a new (possibly earlier) deadline re-arms
the sleep immediately.

A daemon *thread*, not an asyncio task, on purpose: a flush runs kernel
launches and blocks on device completion — parked on an event loop that
would freeze every coroutine between launches. The asyncio side only
ever parks on futures (``submit_async`` / ``serve_async``); completion
hops back to the loop via ``call_soon_threadsafe``.

On the card the thread makes no CUDA context or stream of its own: it
launches on the process's one context and on the device's current
stream (the default stream, as on the main thread), and every flush
ends in the scores' device-to-host copy, so nothing it launched is left
unsynchronized.

Lifecycle: ``start()`` → traffic → ``stop()`` (drains open windows by
default, so nothing admitted is silently dropped). If the driver thread
dies — poll raised, service rebuild failed, anything — the crash does
not vanish into a dead thread: every queued request is failed with
``DriverCrashed`` (awaiters see it raised from their future /
``result()``), and the next ``stop()``/``check()`` re-raises it on the
caller's thread.

Fake clocks: the driver sleeps in *clock deltas* interpreted as wall
seconds. Under the test fake clock real sleeps are meaningless, so
tests drive the driver through the waker (every submit pokes it) and
``step()`` — the single poll the thread loop runs, exposed for
deterministic use.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

from repro_torch.serve.admission import AdmissionController


class DriverCrashed(RuntimeError):
    """The background admission driver died.

    Raised from pending handles/futures the driver aborted on its way
    down, and re-raised by ``stop()``/``check()``. ``cause`` is the
    exception that killed the driver thread.
    """

    def __init__(self, cause: BaseException):
        self.cause = cause
        super().__init__(f"admission driver crashed: {cause!r}")


class AsyncDriver:
    """Background deadline-wake poller over one ``AdmissionController``.

    Usable as a context manager (``with AsyncDriver(ctrl):`` starts it
    and stops-with-drain on exit). One driver per controller: two
    drivers would double-poll harmlessly but pointlessly.
    """

    def __init__(self, controller: AdmissionController, *,
                 name: str = "repro-torch-admission-driver"):
        self.controller = controller
        self.name = name
        self._thread: Optional[threading.Thread] = None
        self._cond = threading.Condition()
        self._stop_flag = False
        self._poke = False
        self._crash: Optional[DriverCrashed] = None

    # -- lifecycle -----------------------------------------------------------
    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def crashed(self) -> Optional[DriverCrashed]:
        return self._crash

    def check(self) -> None:
        """Raise the driver's crash on the calling thread, if it had one
        — the liveness probe for long-running servers."""
        if self._crash is not None:
            raise self._crash

    def start(self) -> "AsyncDriver":
        if self.alive:
            raise RuntimeError(f"driver {self.name!r} already running")
        self.check()    # a crashed driver's state explains itself; no
        #                 silent restart over an un-diagnosed corpse
        self._stop_flag = False
        self._poke = False
        self.controller.add_waker(self._wake)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.name)
        self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = 30.0) -> None:
        """Stop the driver thread; by default drain every open window
        first-class (nothing admitted is dropped). Re-raises a crash."""
        with self._cond:
            self._stop_flag = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self.controller.remove_waker(self._wake)
        self.check()
        if drain:
            self.controller.drain()

    def __enter__(self) -> "AsyncDriver":
        return self.start()

    def __exit__(self, *exc) -> None:
        # a crash raised here would mask the body's exception; prefer
        # the body's, fall back to the crash (still on .crashed)
        body_failed = exc and exc[0] is not None
        try:
            self.stop(drain=not body_failed)
        except DriverCrashed:
            if not body_failed:
                raise

    # -- the loop ------------------------------------------------------------
    def _wake(self) -> None:
        with self._cond:
            self._poke = True
            self._cond.notify_all()

    def step(self) -> int:
        """One driver iteration's worth of flushing: poll every due
        window. Exposed for fake-clock tests (advance clock, step,
        assert) — the thread loop calls exactly this."""
        return self.controller.poll()

    def _run(self) -> None:
        ctrl = self.controller
        try:
            while True:
                t = ctrl.next_due_time()
                now = ctrl.clock()
                if t is not None and t <= now:
                    self.step()
                    continue
                with self._cond:
                    if self._stop_flag:
                        return
                    if self._poke:
                        # a submit landed after next_due_time() was
                        # computed: recompute before sleeping, or we
                        # could sleep straight past its deadline
                        self._poke = False
                        continue
                    if t is None:
                        self._cond.wait()           # park: nothing can
                        #                             become due on its own
                    else:
                        self._cond.wait(timeout=max(0.0, t - now))
                    if self._stop_flag:
                        return
                    self._poke = False
        except BaseException as e:     # noqa: BLE001 — the whole point:
            #   any escape kills the thread, and that MUST surface
            crash = DriverCrashed(e)
            self._crash = crash
            ctrl.abort_pending(crash)


# -- process-default fleet ----------------------------------------------------
_default_lock = threading.Lock()
_default: Optional[Tuple[AdmissionController, AsyncDriver]] = None


def default_driver(registry=None, **controller_kwargs
                   ) -> Tuple[AdmissionController, AsyncDriver]:
    """The process-default (controller, running driver) pair, built
    lazily over ``default_registry()`` (or ``registry``) on first use.
    ``controller_kwargs`` only apply to that first build."""
    global _default
    with _default_lock:
        if _default is None:
            if registry is None:
                from repro_torch.serve.registry import default_registry
                registry = default_registry()
            ctrl = AdmissionController(registry, **controller_kwargs)
            _default = (ctrl, AsyncDriver(ctrl).start())
        return _default


def reset_default_driver() -> None:
    """Stop and discard the process-default pair (tests; fork hygiene
    before spawning shm workers — the driver thread does not survive a
    fork)."""
    global _default
    with _default_lock:
        pair, _default = _default, None
    if pair is not None:
        pair[1].stop(drain=True)


async def serve_async(model: str, q, *,
                      deadline: Optional[float] = None,
                      controller: Optional[AdmissionController] = None):
    """Score ``q`` against registered ``model``, asynchronously.

    The coroutine front door: admission happens synchronously on the
    calling loop thread (quota/routing errors raise here), then the
    caller awaits the batch instead of busy-waiting on ``Pending`` —
    the background driver (the process-default one unless a
    ``controller`` with its own driver is passed) flushes when the
    window fills or the deadline demands it. ``deadline`` is absolute on
    the controller's clock, like ``submit``.
    """
    if controller is None:
        controller, _ = default_driver()
    return await controller.submit_async(model, q, deadline=deadline)
