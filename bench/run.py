"""Run one cell of the benchmark of ``repro_torch`` on one CUDA card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up (draws the served model and the
queries from the seed on the card, packs the model with the program's own
packing, warms the shapes the cell's traffic sends), measures for
``--seconds``, checks the answers against the plain reference, prints the
numbers compared with their limits as the last lines of standard error,
and one JSON object as the last line of standard output. With
``--trace 0`` its metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a profiler trace of the
window. It exits with 2 and prints no result when no card is there, and
with 3 when a module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Modules that must not be loaded in the process that prints the result,
# compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout. The program's
    own nvcc builds go to <checkout>/build/repro_torch (its
    ``kernels/_build.py``)."""
    base = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_dirs()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from benchlib import cells, harness

    bench = cells.load_benchmark()
    chips = cells.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    import repro_torch.api as api
    device = api.resolve_device("cuda")

    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device, bench=bench,
                         t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"bench: the process loaded {bad}; the benchmark measures "
              f"repro_torch alone", file=sys.stderr)
        return 3
    print(f"bench: card {card_line()}", file=sys.stderr)
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
