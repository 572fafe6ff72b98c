"""The port's own spans (``repro_torch.utils.trace``), on the CPU.

* Outside ``trace.recording()`` a span is the shared no-op, with or
  without a profiler running: nothing is recorded, no clock is read and
  no ``record_function`` is entered, and the injected clock is read as
  often as without the spans.
* In a recording under ``torch.profiler``, spans from the caller's thread
  and from a running ``AsyncDriver``'s thread land in the buffer, nested,
  with their window numbers; the calibration pair's stamps lie within
  50 us of the profiler's record of its span; a full collection shows as
  ``repro_torch.gc``; a full buffer counts what it drops.
* The admission flush spans of a fake-clock script give each window's
  reason as the script closes it, and number the flushed windows.
"""
import gc
import threading
import time
import types

import numpy as np
import pytest
import torch

import repro_torch.serve as tserve
from repro_torch.core import SlabSpec
from repro_torch.core.kernel_fn import KernelFn
from repro_torch.core.ocssvm import OCSSVMModel
from repro_torch.serve import admission, async_driver
from repro_torch.utils import trace

D = 8
US = 1000


class ManualClock:
    def __init__(self, t=0.0):
        self.t, self.reads = t, 0

    def __call__(self):
        self.reads += 1
        return self.t

    def advance(self, s):
        self.t += s


class OneModel:
    def __init__(self, served):
        self.served = served

    def get(self, name):
        return self.served

    def quota(self, name):
        return None


@pytest.fixture(scope="module")
def served():
    g = torch.Generator().manual_seed(3)
    t = torch.randn((64, D), generator=g)
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5,
                    kernel=KernelFn(name="rbf", gamma=1.0 / D))
    model = OCSSVMModel(gamma=torch.full((64,), 1.0 / 64),
                        rho1=torch.tensor(0.2), rho2=torch.tensor(0.9),
                        X=t, spec=spec)
    return tserve.pack_model(model, precision="f32")


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.reset()
    yield
    trace.reset()


def _q(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _flushes():
    return [sp for sp in trace.spans().spans
            if sp.name == "repro_torch.admission.flush"]


def _close_script(served, clock):
    """One window closed for each reason but ``explicit``, which closes
    two; returns the controller."""
    ctrl = admission.AdmissionController(
        OneModel(served), clock=clock, max_batch=256, max_wait_s=0.05,
        fallback_latency_s=0.002)
    ctrl.submit("m", _q(10), deadline=clock.t + 0.5)
    ctrl.submit("m", _q(300))                          # full
    ctrl.submit("m", _q(5), deadline=clock.t - 1.0)    # dead
    ctrl.submit("m", _q(5), deadline=clock.t + 0.5)
    clock.advance(0.6)
    assert ctrl.poll() == 1                            # due
    ctrl.submit("m", _q(6))
    clock.advance(0.1)
    assert ctrl.poll() == 1                            # aged
    ctrl.submit("m", _q(7))
    assert ctrl.drain() == 1                           # drain
    ctrl.submit("m", _q(8))
    ctrl.flush_model("m")                              # explicit
    h = ctrl.submit("m", _q(9))
    h.result()                                         # explicit
    return ctrl


def test_flush_spans_give_each_window_s_reason_and_number(served):
    with trace.recording():
        ctrl = _close_script(served, ManualClock())
    flushes = _flushes()
    assert [sp.fields["reason"] for sp in flushes] == [
        "full", "dead", "due", "aged", "drain", "explicit", "explicit"]
    assert [sp.fields["window"] for sp in flushes] == list(range(1, 8))
    assert [sp.fields["requests"] for sp in flushes] == [2, 1, 1, 1, 1,
                                                         1, 1]
    windows = ctrl.stats_dict()["m"]["windows"]
    assert len(flushes) == windows["flushed"] == windows["opened"] == 7
    assert windows["inline_flushes"] == 1              # the dead one


def test_every_window_closes_through_flush_model(served, monkeypatch):
    # inline, due and drain flushes too: a tracer that wraps
    # ``flush_model`` sees every flush
    reasons = []
    real = admission.AdmissionController.flush_model

    def spy(self, model, **kw):
        reasons.append(kw.get("_reason", "explicit"))
        return real(self, model, **kw)

    monkeypatch.setattr(admission.AdmissionController, "flush_model", spy)
    _close_script(served, ManualClock())
    assert reasons == ["full", "dead", "due", "aged", "drain", "explicit",
                       "explicit"]


def test_outside_a_recording_spans_record_nothing_and_read_no_clock(
        served, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("read or entered with no profiler running")

    no_clock = types.SimpleNamespace(time_ns=boom)
    monkeypatch.setattr(trace, "time", no_clock)
    monkeypatch.setattr(async_driver, "time", no_clock)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert trace.span("repro_torch.x.y", rows=1) is trace.NULL
    with trace.span("repro_torch.x.y") as sp:
        sp.set(window=1)
    _close_script(served, ManualClock())
    ctrl = admission.AdmissionController(OneModel(served))
    with async_driver.AsyncDriver(ctrl):
        h = ctrl.submit("m", _q(4), deadline=time.monotonic() + 0.01)
        h.result()
    rec = trace.spans()
    assert rec.spans == [] and rec.dropped == 0 and rec.clock is None


def test_a_profiler_alone_turns_no_span_on(served):
    with _profile():
        assert trace.span("repro_torch.x.y") is trace.NULL
        _close_script(served, ManualClock())
        gc.collect()
    rec = trace.spans()
    assert rec.spans == [] and rec.dropped == 0 and rec.clock is None


def test_a_recording_ends_with_its_block_and_keeps_its_spans():
    with trace.recording():              # no profiler: no calibration
        with trace.span("repro_torch.x.in"):
            pass
    assert trace.span("repro_torch.x.out") is trace.NULL
    rec = trace.spans()
    assert [sp.name for sp in rec.spans] == ["repro_torch.x.in"]
    assert rec.clock is None
    with trace.recording():              # a new recording empties it
        pass
    assert trace.spans().spans == []


def test_spans_read_the_injected_clock_no_more_than_without_them(served):
    plain = ManualClock()
    _close_script(served, plain)
    traced = ManualClock()
    with _profile(), trace.recording():
        _close_script(served, traced)
    assert traced.reads == plain.reads
    names = {sp.name for sp in trace.spans().spans}
    assert {"repro_torch.admission.submit", "repro_torch.admission.flush",
            "repro_torch.service.flush", "repro_torch.scorer.stage",
            "repro_torch.decision.launch"} <= names


def test_spans_from_the_caller_and_the_driver_thread_land_in_the_buffer(
        served):
    ctrl = admission.AdmissionController(OneModel(served))
    driver = async_driver.AsyncDriver(ctrl)
    with _profile(), trace.recording():
        driver.start()
        done = threading.Event()
        handles = []
        for i, n in enumerate((3, 5, 7)):
            handles.append(ctrl.submit("m", _q(n, i),
                                       deadline=time.monotonic() + 0.2))
        handles[-1].add_done_callback(lambda h: done.set())
        assert done.wait(10)
        driver_tid = driver._thread.native_id
        driver.stop()
    for h in handles:
        assert h.done and h.result().shape == (h.n,)
    rec = trace.spans()
    assert rec.dropped == 0
    by_id = {sp.id: sp for sp in rec.spans}
    main = threading.get_native_id()
    submits = [sp for sp in rec.spans
               if sp.name == "repro_torch.admission.submit"]
    assert [sp.fields["rows"] for sp in submits] == [3, 5, 7]
    assert {sp.tid for sp in submits} == {main}
    assert {sp.fields["window"] for sp in submits} == {1}
    (flush,) = [sp for sp in rec.spans
                if sp.name == "repro_torch.admission.flush"]
    assert flush.tid == driver_tid and flush.tid != main
    assert flush.fields == {"model": "m", "window": 1, "rows": 15,
                            "requests": 3, "reason": "due"}
    assert flush.start_ns >= max(sp.end_ns for sp in submits)

    def chain(name):
        (sp,) = [s for s in rec.spans if s.name == name]
        out = []
        while sp is not None:
            out.append(sp.name.split(".", 1)[1])
            sp = by_id.get(sp.parent)
        return out

    assert chain("repro_torch.decision.prepare") == [
        "decision.prepare", "scorer.score", "service.flush",
        "admission.flush"]
    assert chain("repro_torch.scorer.fetch")[1:] == [
        "scorer.score", "service.flush", "admission.flush"]
    assert chain("repro_torch.service.scatter")[1:] == [
        "service.flush", "admission.flush"]
    idle = [sp for sp in rec.spans if sp.name == "repro_torch.driver.idle"]
    assert idle and {sp.tid for sp in idle} == {driver_tid}
    woke = [sp for sp in idle if sp.fields["due_ns"] is not None]
    assert woke and all(sp.end_ns <= flush.start_ns for sp in woke)
    for sp in rec.spans:
        assert sp.start_ns <= sp.end_ns
        if sp.parent in by_id:
            p = by_id[sp.parent]
            assert p.tid == sp.tid
            assert p.start_ns <= sp.start_ns and sp.end_ns <= p.end_ns


def test_the_calibration_pair_agrees_with_the_profiler_s_clock():
    with _profile() as prof:
        with torch.profiler.record_function("warm"):
            pass
        with trace.recording(), trace.span("repro_torch.x.first"):
            pass
    rec = trace.spans()
    tid, before, inside, after = rec.clock
    assert tid == threading.get_native_id()
    (a, b), = [(e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.name() == trace.CLOCK]
    assert before <= a + 50 * US
    assert a - 50 * US <= inside <= b + 50 * US
    assert after >= b - 50 * US
    (sp,) = rec.spans
    assert sp.start_ns >= inside


def test_a_full_collection_shows_as_a_span():
    with trace.recording():
        with trace.span("repro_torch.x.outer"):
            gc.collect()
    rec = trace.spans()
    (outer,) = [sp for sp in rec.spans if sp.name != trace.GC]
    (col,) = [sp for sp in rec.spans
              if sp.name == trace.GC and sp.parent == outer.id]
    assert col.fields["generation"] == 2 and "collected" in col.fields
    assert outer.start_ns <= col.start_ns <= col.end_ns <= outer.end_ns
    gc.collect()                        # no recording: not recorded
    assert len(trace.spans().spans) == len(rec.spans)


def test_fields_come_back_as_they_were_given():
    with trace.recording():
        with trace.span("repro_torch.x.a", n=-3, big=2 ** 62,
                        huge=2 ** 70, s="slab", none=None, flag=True,
                        f=0.5) as sp:
            sp.set(late="due")
        with trace.span("repro_torch.x.b"):
            pass
    a, b = trace.spans().spans
    assert a.fields == {"n": -3, "big": 2 ** 62, "huge": repr(2 ** 70),
                        "s": "slab", "none": None, "flag": 1, "f": "0.5",
                        "late": "due"}
    assert (b.name, b.fields) == ("repro_torch.x.b", {})


def test_a_full_buffer_keeps_the_first_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    with trace.recording():
        for i in range(10):
            with trace.span("repro_torch.x.step", i=i):
                pass
    rec = trace.spans()
    assert rec.capacity == 4 and rec.dropped == 6
    assert [sp.fields["i"] for sp in rec.spans] == [0, 1, 2, 3]
