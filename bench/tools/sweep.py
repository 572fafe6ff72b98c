"""The knee of an open-loop cell, by a sweep of fixed rates on the card.

    python3 bench/tools/sweep.py --workload sift128.online \
        --rates 400000,800000,1200000 --seconds 5 --deadline-ms 12 \
        [--json build/sweep.json]

Sets the cell up once, times one full top-bucket flush through the
service 30 times (the deadline's yardstick), then runs the cell's traffic at each rate (rows a
second) for ``--seconds`` and prints, for each: the requests' p50 / p95 /
p99 latency from their due times, the generator's p95 lateness, the
median latency of the last quarter of requests against the first (a
backlog that grows shows as a rise), the windows' mean rows, the mean
launch time and the rows served a second. Nothing is traced.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="sift128.online")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    import numpy as np
    import torch

    import repro_torch.api as api
    from benchlib import cells, readers, yardstick
    from benchlib.trace import Tracer

    device = api.resolve_device("cuda")
    bench = cells.load_benchmark()
    w = cells.workload(bench, args.workload)
    cfg = cells.config(bench, w["config"])
    traffic = cells.traffic(w["traffic"])
    if args.deadline_ms is not None:
        traffic["deadline_ms"] = args.deadline_ms
    driver = cells.module("drivers", traffic["loop"])
    state = driver.setup(cfg, traffic, args.seed, device)
    ctrl, host = state.program["ctrl"], state.program["host"]

    # One full top-bucket flush, 30 times: the deadline's yardstick.
    from repro_torch.serve.scorer import BUCKETS
    top = BUCKETS[-1]
    probe = []
    for i in range(30):
        t0 = time.perf_counter()
        ctrl.submit("slab", host[i * 64:i * 64 + top])
        ctrl.flush_model("slab")
        probe.append(time.perf_counter() - t0)
    out = {"card": torch.cuda.get_device_name(device),
           "flush_ms": {"median": 1e3 * statistics.median(probe),
                        "min": 1e3 * min(probe), "max": 1e3 * max(probe)},
           "deadline_ms": traffic["deadline_ms"], "rates": []}
    print(json.dumps(out), flush=True)
    for rate in [float(r) for r in args.rates.split(",") if r]:
        state.program["traffic"] = dict(traffic, rate_rows_per_s=rate)
        win = driver.window(state, args.seconds, Tracer(False, device))
        lat = np.asarray(win["latencies_s"]) * 1e3
        q = len(lat) // 4
        ctx = {"window": win, "trace": None, "config": cfg}
        wins = readers.admission_windows(ctx)
        launches = readers.service_launches(ctx)
        rec = {"rate_rows_per_s": rate, "requests": len(lat),
               "failed": win["failed"],
               "p50_ms": yardstick.percentile(lat.tolist(), 50),
               "p95_ms": yardstick.percentile(lat.tolist(), 95),
               "p99_ms": yardstick.percentile(lat.tolist(), 99),
               "gen_lag_p95_ms": 1e3 * yardstick.percentile(
                   [x for x in win["gen_lag_s"] if x == x], 95),
               "first_quarter_p50_ms": float(np.median(lat[:q])),
               "last_quarter_p50_ms": float(np.median(lat[-q:])),
               "window_rows": (wins["flushed_rows"] / wins["flushed"]
                               if wins.get("flushed") else None),
               "flush_ms": (1e3 * launches["total_s"] / launches["batches"]
                            if launches.get("batches") else None),
               "served_rows_per_s": win["rows"] / win["window_s"]}
        out["rates"].append(rec)
        print(json.dumps(rec), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
