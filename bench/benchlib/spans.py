"""The program's own spans (``repro_torch.utils.trace``): what they
read, and their join to the profiler's trace.

The program records its spans, on any thread, only inside
``repro_torch.utils.trace.recording()``, which the harness's ``Tracer``
does not enter: ``bench/tools/spans_check.py`` enters it inside the
profiler of a traced run, and reads the buffer after the run
(``read_spans``). ``readings`` gives what the spans say of an open-loop
window: None each where the buffer dropped spans, and, for a reading
that needs a span per request, where the window sent more requests than
the buffer holds.

``program_trace`` joins the spans to a profiler's trace: the spans on the
trace's clock (by the calibration pair, the profiler span
``repro_torch.trace.clock`` with the program's stamp inside it), the idle
gaps named by program spans as well as host spans, and device seconds by
the innermost program span around the CUDA runtime call that launched
them (same correlation id).
"""
from __future__ import annotations

import importlib
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchlib.yardstick import gaps, percentile

PROGRAM_TRACE = "repro_torch.utils.trace"
CLOCK = "repro_torch.trace.clock"
SUBMIT = "repro_torch.admission.submit"
LOCK_WAIT = "repro_torch.admission.lock_wait"
FLUSH = "repro_torch.admission.flush"
IDLE = "repro_torch.driver.idle"
SERVICE_FLUSH = "repro_torch.service.flush"
FETCH = "repro_torch.scorer.fetch"
STAGE = "repro_torch.scorer.stage"
PREPARE = "repro_torch.decision.prepare"
# Why a window closed, where the sender's thread flushed it.
INLINE = ("full", "dead")
NO_PROGRAM_SPAN = "(no program span)"


def read_spans() -> Optional[dict]:
    """The program's spans as they stand, or None for a program without
    spans or with none recorded."""
    try:
        ptrace = importlib.import_module(PROGRAM_TRACE)
    except ImportError:
        return None
    rec = ptrace.spans()
    if not rec.spans:
        return None
    return {"spans": rec.spans, "dropped": rec.dropped,
            "capacity": rec.capacity, "clock": rec.clock,
            "threads": rec.threads}


def named(p: dict, name: str) -> List:
    return [sp for sp in p["spans"] if sp.name == name]


def p95_ms(values_ns: List[float]) -> Optional[float]:
    return percentile(values_ns, 95) / 1e6 if values_ns else None


def admission_waits_ns(p: dict) -> List[int]:
    """Each admitted request's wait in admission: from the end of its
    submit to the start of its window's flush; where its own submit
    flushed the window (the flush inside the submit), from the submit's
    start."""
    flushes = {(sp.fields.get("model"), sp.fields["window"]): sp
               for sp in named(p, FLUSH)}
    out = []
    for sp in named(p, SUBMIT):
        f = flushes.get((sp.fields.get("model"), sp.fields.get("window")))
        if f is None:
            continue
        inside = sp.start_ns <= f.start_ns <= sp.end_ns
        out.append(f.start_ns - (sp.start_ns if inside else sp.end_ns))
    return out


def wake_lags_ns(p: dict) -> List[int]:
    return [sp.end_ns - sp.fields["due_ns"] for sp in named(p, IDLE)
            if sp.fields.get("due_ns") is not None]


def flush_host_ns(p: dict) -> List[int]:
    """Each service flush's span less the scores' fetches inside it."""
    by_id = {sp.id: sp for sp in p["spans"]}
    fetched: Dict[int, int] = defaultdict(int)
    for sp in named(p, FETCH):
        up = by_id.get(sp.parent)
        while up is not None and up.name != SERVICE_FLUSH:
            up = by_id.get(up.parent)
        if up is not None:
            fetched[up.id] += sp.end_ns - sp.start_ns
    return [sp.end_ns - sp.start_ns - fetched[sp.id]
            for sp in named(p, SERVICE_FLUSH)]


def closes(p: dict) -> Counter:
    """The window's closed windows by why each closed (the reason of each
    ``repro_torch.admission.flush`` span)."""
    return Counter(sp.fields.get("reason") for sp in named(p, FLUSH))


def readings(p: Optional[dict], requests: int) -> Dict[str, Optional[float]]:
    """What the spans ``p`` say of an open-loop window of ``requests``
    requests: the 95th percentile of a request's wait in admission, of the
    wait for the model lock and of the driver's lateness at a wake-up, in
    ms; the windows the sender's thread flushed (closed ``full`` or
    ``dead``) over all, in %; the mean host ms of a service flush, less
    the fetches inside it."""
    out = dict.fromkeys(("admit_wait_p95_ms", "lock_wait_p95_ms",
                         "wake_lag_p95_ms", "inline_flush_pct",
                         "flush_host_ms"))
    if not p or p["dropped"]:
        return out
    if requests <= p["capacity"]:
        out["admit_wait_p95_ms"] = p95_ms(admission_waits_ns(p))
    out["lock_wait_p95_ms"] = p95_ms([sp.end_ns - sp.start_ns
                                      for sp in named(p, LOCK_WAIT)])
    out["wake_lag_p95_ms"] = p95_ms(wake_lags_ns(p))
    d = closes(p)
    if d:
        out["inline_flush_pct"] = (100.0 * sum(d[k] for k in INLINE)
                                   / sum(d.values()))
    host = flush_host_ns(p)
    if host:
        out["flush_host_ms"] = sum(host) / len(host) / 1e6
    return out


# -- the join to a profiler's trace ------------------------------------------

def clock_shift(events: List[tuple], clock) -> Tuple[int, Optional[dict]]:
    """Nanoseconds to add to the program's stamps to put them on the
    trace's clock: 0 while its stamp inside the calibration span lies
    inside the profiler's record of that span, else the distance to the
    nearer edge; with the pair's readings (ns from the inside stamp).
    ``events`` as ``benchlib.trace.raw_events`` gives them."""
    rec = [(a, b) for n, dev, a, b in events if n == CLOCK and not dev]
    if clock is None or not rec:
        return 0, None
    _, before, inside, after = clock
    a, b = rec[0]
    shift = a - inside if inside < a else (b - inside if inside > b else 0)
    return shift, {"start_ns": a - inside, "end_ns": b - inside,
                   "before_ns": before - inside, "after_ns": after - inside,
                   "shift_ns": shift}


def aligned(spans: list, shift: int, lo: int, hi: int) -> list:
    """The spans that overlap [lo, hi], their stamps (``_ns`` fields
    too) moved by ``shift``."""
    out = []
    for sp in spans:
        if sp.end_ns + shift <= lo or sp.start_ns + shift >= hi:
            continue
        fields = {k: (v + shift if k.endswith("_ns") and v is not None
                      else v) for k, v in sp.fields.items()}
        out.append(sp._replace(start_ns=sp.start_ns + shift,
                               end_ns=sp.end_ns + shift, fields=fields))
    return out


def int32(ident: int) -> int:
    return (ident & 0xFFFFFFFF) - ((ident & 0x80000000) << 1)


def runtime_links(prof, threads: Dict[int, int]):
    """({correlation id: (native thread id, start_ns)} of the CUDA
    runtime calls, [(correlation id, start_ns, end_ns)] of the device
    intervals) of a profiler's trace. The trace names a runtime call's
    thread by its native id or by the low 32 bits, signed, of its
    ``threading.get_ident()``."""
    from torch.autograd import DeviceType
    alias = {int32(ident): native for native, ident in threads.items()}
    runtime, device = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.correlation_id(), e.start_ns(), e.end_ns()))
        elif e.name().startswith("cu"):     # cudaLaunchKernel, cuLaunch...
            tid = e.device_resource_id()
            runtime[e.correlation_id()] = (alias.get(tid, tid), e.start_ns())
    return runtime, device


def device_by_span(spans: list, runtime: dict, device: list, lo: int,
                   hi: int) -> Dict[str, float]:
    """Device seconds inside [lo, hi] by the innermost program span around
    the runtime call that launched them; ``NO_PROGRAM_SPAN`` for the rest.
    A span is looked for on the call's thread, on any thread when the
    program has no span there."""
    by_tid: Dict[Optional[int], list] = defaultdict(list)
    for sp in spans:
        by_tid[sp.tid].append(sp)
    by_tid[None] = list(spans)
    index = {}
    for tid, lst in by_tid.items():
        lst.sort(key=lambda sp: sp.start_ns)
        index[tid] = (np.array([sp.start_ns for sp in lst], dtype=np.int64),
                      lst)
    by_id = {sp.id: sp for sp in spans}

    def innermost(tid, t):
        starts, lst = index.get(tid, index[None])
        k = int(np.searchsorted(starts, t, side="right")) - 1
        sp = lst[k] if k >= 0 else None
        # spans on one thread nest: the latest to start before t holds t,
        # or one of its ancestors does
        while sp is not None and sp.end_ns < t:
            sp = by_id.get(sp.parent)
        return sp

    out: Dict[str, float] = defaultdict(float)
    for corr, a, b in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        call = runtime.get(corr)
        sp = innermost(*call) if call is not None and spans else None
        out[sp.name if sp is not None else NO_PROGRAM_SPAN] += (b - a) / 1e9
    return dict(out)


def program_trace(prof, events: List[tuple], p: dict) -> dict:
    """The program's spans ``p`` joined to the profiler's trace: the
    calibration pair's readings, the idle gaps named by host and program
    spans (``benchlib.trace.attribute_gaps``), and the device seconds by
    program span. ``events`` as ``benchlib.trace.raw_events`` gives
    them."""
    from benchlib.trace import WINDOW, attribute_gaps
    wins = [(a, b) for n, dev, a, b in events if n == WINDOW and not dev]
    lo, hi = max(wins, key=lambda w: w[1] - w[0])
    shift, clock = clock_shift(events, p["clock"])
    mine = aligned(p["spans"], shift, lo, hi)
    dev = [(max(a, lo), min(b, hi)) for n, d, a, b in events
           if d and b > lo and a < hi]
    host = [(a, b, n) for n, d, a, b in events
            if not d and n != WINDOW and b > a and b > lo and a < hi]
    host += [(sp.start_ns, sp.end_ns, sp.name) for sp in mine
             if sp.end_ns > sp.start_ns]
    runtime, device = runtime_links(prof, p["threads"])
    return {"clock": clock, "spans": mine,
            "idle_gaps": attribute_gaps(gaps(dev, lo, hi), host),
            "device_s_by_span": device_by_span(mine, runtime, device,
                                               lo, hi)}
