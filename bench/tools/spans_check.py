"""What the program's own spans say about one traced run of a cell.

    python3 bench/tools/spans_check.py --workload sift128.online \
        [--seed 12345] [--seconds 40] [--no-bench-spans] \
        [--json build/spans.json]

Runs the cell traced, as ``bench/run.py --trace 1`` does, with the
program's spans recorded inside the profiler
(``repro_torch.utils.trace.recording()``, which the harness's ``Tracer``
does not enter), and prints, beside its metrics (and an open-loop cell's
``score_p95_ms``, which a traced run does not print): the program's
spans by name (count, seconds) and, joined to the profiler's trace
(``benchlib.spans.program_trace``), the calibration pair's readings, the
idle gaps named by host and program spans, and the device seconds by
program span. For an open-loop cell also: the spans' readings of the
window (``benchlib.spans.readings``); the window's flush spans by
reason against the windows the controller's ``stats_dict`` flushed; the
median of a request's admission wait plus its window's flush (and plus
the flush of its own service group) against the median of the
benchmark's latency less the sender's lateness; and the seconds of each
full garbage collection in the window.
``--no-bench-spans`` leaves out the profiler spans that
``benchlib.trace.SPANS`` wraps around the program's calls.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent / "src")]


def served_ms(p: dict, spans) -> dict:
    """Per request whose window's flush the spans hold: its admission
    wait plus its window's flush (``window``), and plus the flush up to
    the end of its own service group (``group``; a window's requests go
    to its groups in submit order), in ms."""
    flushes = {(sp.fields.get("model"), sp.fields["window"]): sp
               for sp in spans.named(p, spans.FLUSH)}
    groups = defaultdict(list)
    for sp in spans.named(p, spans.SERVICE_FLUSH):
        groups[sp.parent].append(sp)
    by_window = defaultdict(list)
    for sp in spans.named(p, spans.SUBMIT):
        key = (sp.fields.get("model"), sp.fields.get("window"))
        if key in flushes:
            by_window[key].append(sp)
    window, group = [], []
    for key, subs in by_window.items():
        f = flushes[key]
        waits = spans.admission_waits_ns({"spans": subs + [f]})
        ends = []
        for g in sorted(groups.get(f.id, []), key=lambda g: g.start_ns):
            ends += [g.end_ns] * g.fields["requests"]
        ends += [f.end_ns] * (len(subs) - len(ends))
        for wait, end in zip(waits, ends):
            window.append((wait + f.end_ns - f.start_ns) / 1e6)
            group.append((wait + end - f.start_ns) / 1e6)
    return {"window": window, "group": group}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--no-bench-spans", action="store_true")
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    import repro_torch.api as api
    from repro_torch.utils import trace as ptrace
    from benchlib import cells, harness, spans, trace
    from benchlib.yardstick import percentile

    seen = {"full_collections": []}
    module, raw_events = cells.module, trace.raw_events

    def count_full(phase, info):
        if info["generation"] == 2:
            seen["full_collections"].append((phase, time.perf_counter()))

    def keep_window(kind, name):
        m = module(kind, name)
        if kind == "drivers":
            window = m.window

            def kept(state, seconds, tracer):
                gc.callbacks.append(count_full)
                try:
                    seen["window"] = window(state, seconds, tracer)
                finally:
                    gc.callbacks.remove(count_full)
                return seen["window"]
            m.window = kept
        return m

    def keep_events(prof):
        seen["prof"] = prof
        seen["events"] = raw_events(prof)
        return seen["events"]

    profiling = trace.Tracer.profiling

    @contextlib.contextmanager
    def recorded(tracer):
        with profiling(tracer), ptrace.recording():
            yield

    cells.module, trace.raw_events = keep_window, keep_events
    trace.Tracer.profiling = recorded
    if args.no_bench_spans:
        trace.SPANS = ()
    device = api.resolve_device("cuda")
    r = harness.run(args.workload, args.seed, args.seconds, True, device)
    w = seen["window"]
    out = {"workload": args.workload, "seed": args.seed,
           "bench_spans": not args.no_bench_spans, "correct": r["correct"],
           "metrics": {k: v["value"] for k, v in r["metrics"].items()},
           "idle_gaps": r.get("breakdown", {}).get("idle_gaps")}
    marks = [t for _, t in seen["full_collections"]]
    out["full_collections_s"] = [b - a for a, b in zip(marks[::2],
                                                       marks[1::2])]
    if w.get("latencies_s"):
        out["score_p95_ms"] = 1e3 * percentile(w["latencies_s"], 95)
    p = spans.read_spans()
    if p:
        by_name = defaultdict(lambda: [0, 0.0])
        for sp in p["spans"]:
            by_name[sp.name][0] += 1
            by_name[sp.name][1] += (sp.end_ns - sp.start_ns) / 1e9
        joined = spans.program_trace(seen["prof"], seen["events"], p)
        out.update(spans=len(p["spans"]), dropped=p["dropped"],
                   by_name=dict(by_name), clock=joined["clock"],
                   idle_gaps_with_program=joined["idle_gaps"],
                   device_s_by_span=joined["device_s_by_span"])
        requests = w.get("requests") or 0
        by_span = joined["device_s_by_span"]
        if requests:
            out["prep_device_ms_by_span"] = 1e3 * (
                by_span.get(spans.STAGE, 0.0)
                + by_span.get(spans.PREPARE, 0.0)) / requests
        if "stats_after" in w:
            mine = dict(p, spans=joined["spans"])
            closes = spans.closes(mine)
            flushed = (w["stats_after"]["windows"]["flushed"]
                       - w["stats_before"]["windows"]["flushed"])
            served = served_ms(p, spans)
            lat = [1e3 * (a - b) for a, b in
                   zip(w["latencies_s"], w["gen_lag_s"])]
            out.update(
                readings=spans.readings(mine, requests),
                closes=dict(closes), closes_sum=sum(closes.values()),
                windows_flushed=flushed,
                median_wait_plus_window_flush_ms=statistics.median(
                    served["window"]),
                median_wait_plus_group_flush_ms=statistics.median(
                    served["group"]),
                median_latency_less_lag_ms=statistics.median(lat),
                requests_matched=len(served["window"]), requests=len(lat))
    print(json.dumps(out, default=str), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
