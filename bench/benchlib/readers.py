"""Arithmetic that several metric readers share (``bench/metrics``).

Every reader takes the run's context: ``window`` (what the driver
measured and counted), ``trace`` (the traced window's summary, or None),
``config`` and ``setup_s``. A reader that finds nothing to read returns
None, and the metric is left out of the line.
"""
from __future__ import annotations

from typing import Optional

from benchlib import yardstick

# The decision's device kernels as the profiler names them: the split
# kernels of the program's csrc/split_rows.cuh with the slab rule as the
# epilogue (the only split kernels on the scoring path).
DECISION_KERNELS = ("split_simt_kernel", "split_wgmma_kernel",
                    "split_reduce_kernel")


def decision_kernel_s(trace: Optional[dict]) -> Optional[float]:
    if not trace:
        return None
    secs = sum(s for name, (_, s) in trace["kernels"].items()
               if any(k in name for k in DECISION_KERNELS))
    return secs if secs > 0 else None


def useful_flops(ctx: dict) -> float:
    w, c = ctx["window"], ctx["config"]
    return yardstick.decision_flops(w["rows"], w["support_rows"], c["d"])


def decision_roofline(ctx: dict) -> Optional[float]:
    """The least time the window's decision work could take on the card,
    over the device time its kernels took, in %."""
    w, c = ctx["window"], ctx["config"]
    kernel_s = decision_kernel_s(ctx["trace"])
    if kernel_s is None or not w.get("launches"):
        return None
    nbytes = yardstick.decision_bytes(w["rows"], w["launches"],
                                      w["support_rows"], c["d"],
                                      c["precision"])
    return yardstick.share_pct(
        yardstick.bound_s(useful_flops(ctx), nbytes, c["precision"]),
        kernel_s)


def mfu(ctx: dict) -> Optional[float]:
    """The window's useful decision FLOPs over the traced window at the
    peak of the configuration's tile precision, in %."""
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    peak = yardstick.PEAK_FLOPS[ctx["config"]["precision"]]
    return yardstick.share_pct(useful_flops(ctx), t["window_s"] * peak)


def device_idle(ctx: dict) -> Optional[float]:
    """The share of the traced window with nothing running on the
    device, in %."""
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def _delta(ctx: dict, key: str) -> dict:
    """The window's share of a cumulative counter group of the service:
    after minus before, by field (``buckets``: summed over buckets, with
    ``bucket_rows`` the launches times their bucket's rows)."""
    w = ctx["window"]
    before, after = w.get("stats_before"), w.get("stats_after")
    if not after or key not in after:
        return {}
    if key == "windows":
        b = (before or {}).get("windows", {})
        return {k: v - b.get(k, 0) for k, v in after["windows"].items()
                if isinstance(v, (int, float))}
    out = {"batches": 0, "queries": 0, "total_s": 0.0, "bucket_rows": 0}
    b_all = (before or {}).get("buckets", {})
    for bucket, s in after["buckets"].items():
        b = b_all.get(bucket, {})
        n = s["batches"] - b.get("batches", 0)
        out["batches"] += n
        out["queries"] += s["queries"] - b.get("queries", 0)
        out["total_s"] += s["total_s"] - b.get("total_s", 0.0)
        out["bucket_rows"] += n * int(bucket)
    return out


def service_launches(ctx: dict) -> dict:
    return _delta(ctx, "buckets")


def admission_windows(ctx: dict) -> dict:
    return _delta(ctx, "windows")
