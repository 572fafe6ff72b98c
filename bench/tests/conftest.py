"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
root of the repository. Cards' tests carry the ``gpu`` marker and skip
inside the test when no card is there."""
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (BENCH_DIR, BENCH_DIR.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def small_config(name: str) -> dict:
    """A configuration of the benchmark cut to a size the CPU runs in a
    second: its kinds, precision and spec, 16 features, 512 support
    rows."""
    from benchlib import cells
    cfg = cells.config(cells.load_benchmark(), name)
    d = 16
    return dict(cfg, d=d, support_rows=512, train_rows=1024,
                kernel=dict(cfg["kernel"], gamma=1.0 / d))


def small_traffic(name: str) -> dict:
    from benchlib import cells
    t = dict(cells.traffic(name), pool_bytes=1 << 16, pool_requests=4,
             warmup=1)
    if t["loop"] == "closed":
        t["rows"] = [min(t["rows"][0], 64)]
    else:
        t["rows"] = [16, 32, 64]
        t["rate_rows_per_s"] = 20000
        t["deadline_ms"] = 20
    return t


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
