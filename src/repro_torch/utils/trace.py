"""Program spans on the profiler's host clock, from any thread.

``span(name, **fields)`` marks one step of a layer of the scoring path,
named ``repro_torch.<layer>.<step>``:

    with trace.span("repro_torch.service.flush", rows=n) as sp:
        ...
        sp.set(requests=k)          # a field known only later

Spans record only inside ``recording()``, which a tracer enters inside
its ``torch.profiler.profile`` on the thread that started it:

    with torch.profiler.profile(...) as prof, trace.recording():
        ...                         # the traced window
    rec = trace.spans()

Outside it a span records nothing: each use reads one module flag and
returns a shared no-op context, reading no clock and entering no
``record_function``. A profiler alone does not turn spans on, so a
tracer that does not enter ``recording()`` sees the program as it runs
untraced. Inside it, each span keeps ``(name, native thread id,
start_ns, end_ns, parent, fields)`` in a bounded buffer, on any thread:
the profiler's own host spans (``record_function``) are recorded only on
the thread that started it, so a flush on a driver thread would leave no
host span there. Stamps come from ``time.time_ns()``, the clock of the
profiler's host events, and never from the serving layers' injected
``clock``. The parent is the id of the enclosing span on the same thread
(-1 at the top). Fields are ints, strings or None; any other value is
kept as its ``repr``. The buffer keeps the first ``CAPACITY`` spans of a
recording and counts the rest as dropped. It holds them as 64-bit
integers in an ``array``, strings by their index in a table of names: an
object a span, left for the garbage collector, would set off young
collections that carry the program's live objects into the oldest
generation, and with them full collections.

Where a profiler records the thread that enters ``recording()``, the
entry records one calibration pair: a ``record_function(CLOCK)`` with
``time_ns()`` stamps before, inside and after it, so that a reader of the
profiler's trace measures the offset between the two clocks instead of
assuming it.

A ``gc.callbacks`` hook, registered once at import, records every full
(generation 2) garbage collection during a recording, as the span
``repro_torch.gc``.

Reading: ``spans()`` returns the buffer (``Recording``), also after the
recording ended; ``reset()`` empties it.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from array import array
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

# Spans the buffer keeps a recording.
CAPACITY = 1 << 20
# The calibration pair's profiler span.
CLOCK = "repro_torch.trace.clock"
GC = "repro_torch.gc"


class Span(NamedTuple):
    id: int
    name: str
    tid: int
    start_ns: int
    end_ns: int
    parent: int
    fields: Dict[str, object]


class Recording(NamedTuple):
    """The buffer as ``spans()`` returns it: the spans in the order they
    began, how many it dropped, its capacity, the calibration
    pair, ``(tid, before_ns, inside_ns, after_ns)`` around the profiler
    span ``CLOCK`` (None where no profiler recorded the thread that
    entered ``recording()``), and
    ``threads``, {native thread id: ``threading.get_ident()``} of every
    thread that opened a span (the profiler names some threads by the
    latter)."""

    spans: List[Span]
    dropped: int
    capacity: int
    clock: Optional[Tuple[int, int, int, int]]
    threads: Dict[int, int]


class _Buffer:
    """Records appended at each span's end to ``ints`` (one C call, so
    whole under the GIL): id (taken at the start, ``next(ids)``), name
    code, thread id, start, end, parent, the number of fields, then a
    (key code << 2 | kind, value) pair a field, kind 0 for an int, 1 for
    a string (the value its code), 2 for None."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.ints = array("q")
        self.ids = itertools.count()
        self.dropped = 0
        self.clock: Optional[Tuple[int, int, int, int]] = None


# Strings by code, the codes by string: names, field keys and values
# (code 0 is no string's, so that a code is never false).
_names: List[str] = [""]
_codes: Dict[str, int] = {}
_codes_lock = threading.Lock()


def _code(text: str) -> int:
    c = _codes.get(text)
    if c is None:
        with _codes_lock:
            c = _codes.get(text)
            if c is None:
                c = _codes[text] = len(_names)
                _names.append(text)
    return c


_ring = _Buffer(CAPACITY)
_recording = False
_local = threading.local()
_threads: Dict[int, int] = {}


def _thread() -> Tuple[List[int], int]:
    """The calling thread's stack of open span ids and its native id,
    read once a thread: ``threading.get_native_id`` is a system call,
    which costs microseconds on some hosts."""
    st = getattr(_local, "state", None)
    if st is None:
        tid = threading.get_native_id()
        st = _local.state = ([], tid)
        _threads[tid] = threading.get_ident()
    return st


def _calibrate(ring: _Buffer) -> None:
    # only a thread the profiler records can place CLOCK in its trace
    if not torch.autograd._profiler_enabled():
        return
    before = time.time_ns()
    with torch.profiler.record_function(CLOCK):
        inside = time.time_ns()
    ring.clock = (_thread()[1], before, inside, time.time_ns())


class _Null:
    """The span outside a recording: does nothing, and is false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        return False

    def __bool__(self):
        return False

    def set(self, **fields) -> None:
        pass

    def close(self) -> None:
        pass


NULL = _Null()


class _Span:
    """A span that started when it was made; ``close()`` (or the end of
    its ``with`` block) ends it."""

    __slots__ = ("name", "fields", "id", "parent", "start", "ring",
                 "stack", "tid")

    def __init__(self, name: str, fields: dict):
        self.name = name
        self.fields = fields
        ring = self.ring = _ring
        stack, self.tid = getattr(_local, "state", None) or _thread()
        self.stack = stack
        self.parent = stack[-1] if stack else -1
        self.id = i = next(ring.ids)
        stack.append(i)
        self.start = time.time_ns()

    def set(self, **fields) -> None:
        """Add fields known only inside the span."""
        self.fields.update(fields)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, typ, val, tb) -> None:
        end = time.time_ns()
        stack, i = self.stack, self.id
        if stack and stack[-1] == i:
            stack.pop()
        ring = self.ring
        if i >= ring.capacity:
            ring.dropped += 1
            return
        f, get = self.fields, _codes.get
        rec = [i, get(self.name) or _code(self.name), self.tid, self.start,
               end, self.parent, len(f)]
        for k, v in f.items():
            k = (get(k) or _code(k)) << 2
            if v is None:
                rec += (k | 2, 0)
            elif isinstance(v, int) and -1 << 63 <= v < 1 << 63:
                rec += (k, v)
            else:           # a string, or any other value as its repr
                v = v if isinstance(v, str) else repr(v)
                rec += (k | 1, get(v) or _code(v))
        ring.ints.extend(rec)

    def close(self) -> None:
        self.__exit__(None, None, None)


def span(name: str, **fields):
    """A span from now to the end of its ``with`` block (or its
    ``close()``, where no block can hold it), recorded inside
    ``recording()``; outside it the shared no-op, at the cost of one flag
    read."""
    if not _recording:
        return NULL
    return _Span(name, fields)


def spans() -> Recording:
    """The spans of the last recording, in the order they
    began (those still open left out), with the count the buffer
    dropped."""
    ring, names = _ring, _names
    ints = ring.ints.tolist()
    out, k = [], 0
    while k < len(ints):
        i, name, tid, a, b, parent, n = ints[k:k + 7]
        fields = {}
        for j in range(k + 7, k + 7 + 2 * n, 2):
            key, v = ints[j], ints[j + 1]
            kind = key & 3
            fields[names[key >> 2]] = (v if kind == 0 else
                                       names[v] if kind == 1 else None)
        out.append(Span(i, names[name], tid, a, b, parent, fields))
        k += 7 + 2 * n
    out.sort(key=lambda sp: sp.id)
    return Recording(out, ring.dropped, ring.capacity, ring.clock,
                     dict(_threads))


def reset() -> None:
    """Empty the buffer (``CAPACITY`` spans)."""
    global _ring
    _ring = _Buffer(CAPACITY)


@contextlib.contextmanager
def recording():
    """Record spans, on every thread, until the block ends: empty the
    buffer, record the calibration pair where a profiler records the
    calling thread, and turn the spans on. The buffer stays to be read."""
    global _recording
    reset()
    _calibrate(_ring)
    _recording = True
    try:
        yield
    finally:
        _recording = False


def _on_gc(phase: str, info: dict) -> None:
    if not _recording or info["generation"] != 2:
        return
    if phase == "start":
        _local.gc = _Span(GC, {"generation": 2})
        return
    sp = getattr(_local, "gc", None)
    if sp is not None:
        _local.gc = None
        sp.set(collected=info["collected"],
               uncollectable=info["uncollectable"])
        sp.close()


gc.callbacks.append(_on_gc)
