"""The traced window: torch.profiler around the measured window, and its
reduction to what the per-layer readers and the breakdown need.

The window is marked by a ``record_function("bench.window")`` span; every
device interval is clipped to it. Busy seconds are the union of the
device's own intervals (kernels, copies, sets), the arithmetic of the
program's ``chip_smoke.py::_traced`` at the time this copy was taken.
Idle gaps are the stretches of the window that no device interval covers;
each of the longest is put down to the innermost host span that covers
most of it, at least half: an operator, a runtime call, or one of the
spans the benchmark wraps around the program's layers while tracing
(``SPANS``).
"""
from __future__ import annotations

import contextlib
import importlib
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from benchlib.yardstick import gaps, union_seconds

WINDOW = "bench.window"
NAME_CHARS = 160
TOP = 10
# Gaps attributed to host spans, longest first.
GAPS_ATTRIBUTED = 400

# Calls into the program's layers that carry a span while tracing:
# (module, attribute path). One the program no longer has is skipped.
SPANS = (
    ("repro_torch.serve.admission", "AdmissionController.submit"),
    ("repro_torch.serve.admission", "AdmissionController.flush_model"),
    ("repro_torch.serve.service", "ScoringService.flush"),
    ("repro_torch.serve.scorer", "BatchScorer.score"),
    ("repro_torch.serve.scorer", "BatchScorer._pad_queries"),
    ("repro_torch.kernels.decision.ops", "prepare_packed"),
    ("repro_torch.kernels.decision.ops", "_run"),
)


def _wrap(fn, label):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    wrapped.__wrapped__ = fn
    return wrapped


@contextlib.contextmanager
def spans():
    """Wrap the calls of ``SPANS`` in profiler spans; restore on exit."""
    undo = []
    try:
        for mod_name, path in SPANS:
            try:
                owner = importlib.import_module(mod_name)
            except ImportError:
                continue
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part, None)
            fn = getattr(owner, attr, None) if owner is not None else None
            if fn is None:
                continue
            setattr(owner, attr, _wrap(fn, f"{mod_name}.{path}"))
            undo.append((owner, attr, fn))
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)


class Tracer:
    """``with tracer.profiling():`` around the set-up of the window's loop,
    ``with tracer.window():`` around the measured window itself. Disabled,
    both do nothing."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.summary: Optional[dict] = None

    @contextlib.contextmanager
    def profiling(self):
        if not self.enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with spans(), torch.profiler.profile(activities=acts) as prof:
            yield
        self.summary = summarize(raw_events(prof))

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(WINDOW):
            yield


def _labels() -> set:
    return {WINDOW} | {f"{m}.{p}" for m, p in SPANS}


def raw_events(prof) -> List[tuple]:
    """(name, on_device, start_ns, end_ns) of every event of the trace.
    The profiler mirrors host spans onto the device's timeline (its GPU
    user annotations); those are not device work and count as host
    spans."""
    from torch.autograd import DeviceType
    labels = _labels()
    out = []
    # the raw events: prof.events() would build a tree of every event
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and (e.is_user_annotation() or name in labels):
            continue
        out.append((name, on_device, e.start_ns(), e.end_ns()))
    return out


def summarize(events: List[tuple]) -> dict:
    """busy_s, window_s, device seconds and calls by name, and the
    breakdown (top device ops, longest idle gaps by host span)."""
    wins = [(a, b) for n, dev, a, b in events if n == WINDOW and not dev]
    if not wins:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    lo, hi = max(wins, key=lambda w: w[1] - w[0])
    dev = [(max(a, lo), min(b, hi), n) for n, d, a, b in events
           if d and b > lo and a < hi]
    busy_ns = union_seconds((a, b) for a, b, _ in dev)
    kernels: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for a, b, n in dev:
        k = kernels[n]
        k[0] += 1
        k[1] += (b - a) / 1e9
    idle = gaps(((a, b) for a, b, _ in dev), lo, hi)
    host = [(a, b, n) for n, d, a, b in events
            if not d and n != WINDOW and b > a and b > lo and a < hi]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (hi - lo) / 1e9,
        "kernels": {n: (c, s) for n, (c, s) in kernels.items()},
        "breakdown": {
            "device_ops": [[n[:NAME_CHARS], s] for n, (c, s) in sorted(
                kernels.items(), key=lambda kv: -kv[1][1])[:TOP]],
            "idle_gaps": attribute_gaps(idle, host)},
    }


def attribute_gaps(idle: List[tuple], host: List[tuple]) -> List[list]:
    """Seconds of the longest idle gaps by the host span that covers most
    of each (the innermost on a tie), summed by name, longest first; a
    gap that no span covers half of is "(no host span)": the host was
    waiting, or busy outside the spans."""
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:GAPS_ATTRIBUTED]
    by_name: Dict[str, float] = defaultdict(float)
    if host:
        starts = np.array([a for a, _, _ in host], dtype=np.float64)
        ends = np.array([b for _, b, _ in host], dtype=np.float64)
        names = [n for _, _, n in host]
    for a, b in longest:
        name = "(no host span)"
        if host:
            over = np.minimum(ends, b) - np.maximum(starts, a)
            best = over.max()
            if best >= 0.5 * (b - a):
                # among the spans covering the most, the latest to start
                cand = np.flatnonzero(over >= best)
                name = names[int(cand[np.argmax(starts[cand])])]
        by_name[name[:NAME_CHARS]] += (b - a) / 1e9
    return [[n, s] for n, s in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
