"""The readings that the check's limits are set from, on the card.

    python3 bench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--faults stale,altered] [--seconds 2] \
        [--json build/readings.json]

For each seed, one run of the cell as ``bench/run.py`` makes it (set-up,
a short window, the check) with the program, and with ``--control-seeds``
one with the control in the program's place (``benchlib.faults``): the
reference at the precision below the configuration's. ``--faults`` plants
each named fault in the program on the control seeds. Prints each run's
numbers compared; all runs share one process, so the set-up's build is
paid once.
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    import torch

    import repro_torch.api as api
    from benchlib import cells, faults, harness, model

    device = api.resolve_device("cuda")
    bench = cells.load_benchmark()
    cfg = cells.config(bench, cells.workload(bench, args.workload)["config"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    kinds = [f for f in args.faults.split(",") if f]
    out = {"workload": args.workload,
           "card": torch.cuda.get_device_name(device), "runs": []}

    def one(label, seed, ctx_fn):
        t0 = time.perf_counter()
        with ctx_fn():
            r = harness.run(args.workload, seed, args.seconds, False, device,
                            bench=bench)
        rec = {"label": label, "seed": seed, "correct": r["correct"],
               "attempted": r["attempted"],
               "check": {k: v["value"] for k, v in r["check"].items()},
               "seconds": time.perf_counter() - t0}
        out["runs"].append(rec)
        print(json.dumps(rec), flush=True)

    import contextlib
    for s in seeds:
        one("program", s, contextlib.nullcontext)
    traffic = cells.traffic(cells.workload(bench, args.workload)["traffic"])
    for s in control_seeds:
        # the control takes the seed's own slab, drawn as the driver does
        def ctl(s=s):
            slab, _ = model.draw(s % (1 << 63), cfg, traffic, device)
            return faults.control(slab, cfg["check"]["control"])
        one("control", s, ctl)
        for kind in kinds:
            one(f"fault:{kind}", s, lambda kind=kind: faults.fault(kind))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
