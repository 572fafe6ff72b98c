"""What the program's own spans read (``benchlib.spans``), the reader of
``prep_device_ms.rate``, and the spans' join to a profiler's trace."""
from collections import namedtuple

import pytest
import torch

from benchlib import cells, spans, trace

Span = namedtuple("Span", "id name tid start_ns end_ns parent fields")
MS = 1_000_000


def _span(i, name, tid, a, b, parent=-1, **fields):
    return Span(i, name, tid, a, b, parent, fields)


def _ring(dropped=0, capacity=1000):
    s = spans
    p = [
        _span(0, s.SUBMIT, 1, 0, 1 * MS, window=1, model="m", rows=4),
        _span(1, s.SUBMIT, 1, 2 * MS, 3 * MS, window=1, model="m", rows=4),
        _span(2, s.IDLE, 2, 0, 5 * MS, due_ns=4 * MS),
        _span(3, s.LOCK_WAIT, 2, 5 * MS, 6 * MS, model="m"),
        _span(4, s.FLUSH, 2, 6 * MS, 10 * MS, model="m", window=1, rows=8,
              requests=2, reason="due"),
        _span(5, s.SERVICE_FLUSH, 2, 6 * MS, 10 * MS, parent=4),
        _span(6, "repro_torch.scorer.score", 2, 7 * MS, 9 * MS, parent=5),
        _span(7, s.FETCH, 2, 8 * MS, 9 * MS, parent=6),
        # the third request's own submit flushes its window: its wait
        # runs from its submit's start to the flush
        _span(8, s.SUBMIT, 1, 11 * MS, 20 * MS, window=2, model="m",
              rows=4),
        _span(9, s.LOCK_WAIT, 1, 12 * MS, 15 * MS, parent=8, model="m"),
        _span(10, s.FLUSH, 1, 15 * MS, 19 * MS, parent=8, model="m",
              window=2, rows=4, requests=1, reason="full"),
        _span(11, s.IDLE, 2, 10 * MS, 30 * MS, due_ns=None),
        _span(12, s.FLUSH, 2, 31 * MS, 32 * MS, model="m", window=3,
              rows=4, requests=1, reason="dead"),
        _span(13, s.FLUSH, 2, 33 * MS, 34 * MS, model="m", window=4,
              rows=4, requests=1, reason="due"),
    ]
    return {"spans": p, "dropped": dropped, "capacity": capacity,
            "clock": None, "threads": {}}


def _ctx(requests=3):
    kernels = {"void repro::split_simt_kernel<float>(...)": (3, 0.5),
               "void repro::split_reduce_kernel(...)": (3, 0.1),
               "Memcpy HtoD (Pageable -> Device)": (3, 0.002),
               "void at::native::reduce_kernel(...)": (3, 0.001)}
    return {"window": {"requests": requests},
            "trace": {"busy_s": 1.0, "window_s": 2.0, "kernels": kernels}}


def _read(name, ctx):
    return cells.module("metrics", name).read(ctx)


def test_readings_of_the_program_s_spans():
    p = _ring()
    # 6 - 1 and 6 - 3 ms, and 15 - 11 for the request that flushed
    assert spans.admission_waits_ns(p) == [5 * MS, 3 * MS, 4 * MS]
    # 2 of 4 closed windows full or dead
    assert spans.closes(p) == {"due": 2, "full": 1, "dead": 1}
    assert spans.readings(p, 3) == pytest.approx({
        "admit_wait_p95_ms": 5.0, "lock_wait_p95_ms": 3.0,
        # one wake-up with a due time, 5 - 4 ms late; not the parked one
        "wake_lag_p95_ms": 1.0,
        "inline_flush_pct": 50.0,
        # the service flush less the fetch inside it: 4 - 1 ms
        "flush_host_ms": 3.0})
    # 3 ms of device work outside the decision's kernels, 3 requests
    assert _read("prep_device_ms.rate", _ctx()) == pytest.approx(1.0)


def test_readings_find_nothing_to_read():
    for p in (_ring(dropped=1), None):
        assert set(spans.readings(p, 3).values()) == {None}
    # more requests than the ring holds: no per-request reading
    out = spans.readings(_ring(capacity=2), 3)
    assert out["admit_wait_p95_ms"] is None
    assert out["lock_wait_p95_ms"] == pytest.approx(3.0)
    # no decision kernels in the trace, or no trace
    ctx = _ctx()
    ctx["trace"]["kernels"] = {"Memcpy HtoD": (1, 0.01)}
    assert _read("prep_device_ms.rate", ctx) is None
    assert _read("prep_device_ms.rate", dict(ctx, trace=None)) is None


def test_read_spans_reads_a_recording_and_nothing_else():
    from repro_torch.utils import trace as ptrace
    ptrace.reset()
    try:
        assert spans.read_spans() is None        # nothing recorded
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with ptrace.span(spans.LOCK_WAIT, model="m"):
                pass                             # a profiler alone
        assert spans.read_spans() is None
        with ptrace.recording(), ptrace.span(spans.LOCK_WAIT, model="m"):
            pass
        p = spans.read_spans()
        assert [sp.name for sp in p["spans"]] == [spans.LOCK_WAIT]
        assert p["dropped"] == 0 and p["clock"] is None
        assert spans.readings(p, 1)["lock_wait_p95_ms"] >= 0
    finally:
        ptrace.reset()


def test_program_spans_meet_the_trace_on_its_clock():
    us = 1_000
    events = [(trace.WINDOW, False, 0, 100 * us),
              (spans.CLOCK, False, 10 * us, 12 * us)]
    # the program's stamp inside the profiler's span: no shift
    assert spans.clock_shift(events, (1, 9 * us, 11 * us, 13 * us))[0] == 0
    # the program's stamp 5 us before the profiler's span
    shift, clock = spans.clock_shift(events, (1, 3 * us, 5 * us, 6 * us))
    assert shift == 5 * us and clock["start_ns"] == 5 * us
    assert spans.clock_shift(events, None) == (0, None)
    moved = spans.aligned([_span(0, "a", 1, 0, 10, due_ns=4),
                           _span(1, "b", 1, 200 * us, 300 * us)],
                          5, 0, 100 * us)
    assert moved == [_span(0, "a", 1, 5, 15, due_ns=9)]


class _Event:
    def __init__(self, name, dev, a, b, corr=0, tid=0):
        self._v = (name, dev, a, b, corr, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return False


class _Prof:
    def __init__(self, events):
        self.profiler = type("K", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})()})()


def test_the_join_names_gaps_and_device_work_by_program_span():
    ns = 1_000_000_000
    ident = 0x7F12E4E03C40         # the driver thread's get_ident()
    events = [_Event(trace.WINDOW, False, 1 * ns, 3 * ns),
              _Event("cudaLaunchKernel", False, ns, ns + 10, 11, 8),
              _Event("cudaLaunchKernel", False, int(1.2 * ns),
                     int(1.2 * ns) + 10, 12, spans.int32(ident)),
              _Event("kernel_a", True, 1 * ns, int(1.5 * ns), 11),
              _Event("kernel_b", True, int(2.5 * ns), 3 * ns, 12)]
    ring = {"clock": None, "threads": {9: ident}, "spans": [
        _span(0, spans.IDLE, 7, int(1.4 * ns), int(2.6 * ns), due_ns=2),
        _span(1, "repro_torch.scorer.score", 8, 0, 3 * ns),
        _span(2, spans.STAGE, 8, int(0.9 * ns), int(1.1 * ns), parent=1),
        _span(3, "repro_torch.admission.flush", 9, int(1.1 * ns),
              int(1.3 * ns)),
        _span(4, "repro_torch.old", 8, 0, int(0.5 * ns))]}     # before
    raw = [(e.name(), e._v[1], e.start_ns(), e.end_ns()) for e in events]
    out = spans.program_trace(_Prof(events), raw, ring)
    # 1.5-2.5 is covered by the score and the driver's idle: the later
    assert dict(out["idle_gaps"]) == {spans.IDLE: pytest.approx(1.0)}
    assert [sp.id for sp in out["spans"]] == [0, 1, 2, 3]
    # kernel_a launched in the stage; kernel_b by the thread the trace
    # names by its ident, inside that thread's flush
    assert out["device_s_by_span"] == {
        spans.STAGE: pytest.approx(0.5),
        "repro_torch.admission.flush": pytest.approx(0.5)}
    assert out["clock"] is None
