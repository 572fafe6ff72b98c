"""The device's idle share through one cold fit on the card, traced.

    python3 bench/tools/fit_idle.py --rows 131072 [--d 128]

A shrinking fit (``repro_torch.fit``, strategy "auto") of ``--rows``
seeded rows (the program's ``make_toy``), spec nu1 = 0.5, nu2 = 0.05,
eps = 0.5, rbf(1/d), P = 16, tol = 1e-3, under torch.profiler with the
device's activity only: the fit's wall seconds, iterations, and the union
of the device's intervals over the wall time. Not a cell: the fit is paced
by the host today, and this records by how much.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=131072)
    ap.add_argument("--d", type=int, default=128)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from benchlib.trace import raw_events
    from benchlib.yardstick import union_seconds
    from repro_torch.core import SlabSpec, rbf
    from repro_torch.data import make_toy

    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=rbf(1.0 / args.d))
    X = make_toy(0, args.rows, d=args.d)[0]
    # a first, small fit builds the kernels outside the trace
    repro_torch.fit(X[:4096], spec, strategy="auto", P=16, tol=1e-3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = repro_torch.fit(X, spec, strategy="auto", P=16, tol=1e-3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    dev = [(a, b) for _, on_dev, a, b in raw_events(prof) if on_dev]
    busy = union_seconds(dev) / 1e9
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "rows": args.rows, "d": args.d,
                      "iters": int(res.iters), "wall_s": wall,
                      "busy_s": busy, "idle_share": 1 - busy / wall,
                      "device_events": len(dev),
                      "parse_s": time.perf_counter() - t1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
