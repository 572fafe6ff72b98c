"""The cost of a ``repro_torch.utils.trace`` span site, outside and inside
a recording, against a bare loop and ``record_function``.

    PYTHONPATH=src python tools/span_cost.py [--n 1000000]

Prints one JSON line of nanoseconds a use (the fastest of five rounds):
``site_off`` is ``with trace.span(name, rows=n): pass`` outside a
recording (one flag read and the shared no-op context), ``site_on`` the
same inside ``trace.recording()`` under a CPU profiler (the span
recorded in the buffer), ``record_function_off`` and
``record_function_on`` the profiler's own span with no profiler and
under it, for comparison.
"""
from __future__ import annotations

import argparse
import json
import sys
import timeit

import torch

from repro_torch.utils import trace


def per_use_ns(fn, n: int) -> float:
    return min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e9


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    n = args.n

    def bare():
        pass

    def site():
        with trace.span("repro_torch.x.step", rows=n):
            pass

    def rf():
        with torch.profiler.record_function("x.step"):
            pass

    out = {"torch": torch.__version__, "n": n}
    base = per_use_ns(bare, n)
    out["bare_call"] = base
    out["site_off"] = per_use_ns(site, n) - base
    out["record_function_off"] = per_use_ns(rf, n // 10) - base
    m = min(n // 10, trace.CAPACITY // 8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.recording():
            out["site_on"] = per_use_ns(site, m) - base
        out["record_function_on"] = per_use_ns(rf, m) - base
    trace.reset()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
