"""One run of one cell: set-up, the measured window, the metrics, the check.

``run`` is what ``bench/run.py`` calls on the card; the tests call it on
the CPU at a small size, with the program's kernels in their plain
versions. Order, as the check wants it: set-up (timed from the process's
start), the window (traced or not), the device's peak memory, the
metrics, then the program's state is dropped and the reference works the
answers out again.
"""
from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from benchlib import cells
from benchlib.trace import Tracer
from reference import slab as reference


@dataclass
class State:
    """What a driver's set-up hands to its window: the benchmark's own
    inputs (``slab``, the query ``pool`` on the device) and the program's
    objects (``program``), which ``release`` drops before the check."""

    device: torch.device
    slab: Any
    pool: torch.Tensor
    program: Dict[str, Any] = field(default_factory=dict)

    def release(self) -> None:
        self.program.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare(answers: torch.Tensor, index: torch.Tensor,
            ref: torch.Tensor) -> float:
    """The widest gap between an answer and the reference's value for its
    row, over the largest |reference| of the pool."""
    if answers.numel() == 0:
        return math.nan
    scale = float(ref.abs().max())
    gap = (answers.to(ref.device, torch.float64)
           - ref[index.to(ref.device)]).abs().max()
    return float(gap) / scale


def check(state: State, answers: torch.Tensor, index: torch.Tensor,
          missing: int, config: dict) -> Dict[str, dict]:
    """The numbers compared, each with its limit."""
    s = state.slab
    ref = reference.decision(state.pool, s.t, s.gamma, s.rho1, s.rho2,
                             s.kgamma, precision=config["precision"])
    err = compare(answers, index, ref)
    return {"err": {"value": err, "limit": config["check"]["err_limit"]},
            "missing": {"value": missing, "limit": 0}}


def is_correct(numbers: Dict[str, dict]) -> bool:
    # "not (v <= limit)" so that a NaN fails
    return all(v["value"] <= v["limit"] for v in numbers.values())


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run(cell: str, seed: int, seconds: float, trace: bool,
        device: torch.device, *, bench: Optional[dict] = None,
        config: Optional[dict] = None, traffic: Optional[dict] = None,
        t_start: Optional[float] = None) -> dict:
    """One run; returns the result line's object. ``config`` and
    ``traffic`` replace the files the cell names (the tests' small
    sizes)."""
    if t_start is None:
        t_start = time.perf_counter()
    seed = int(seed) % (1 << 63)
    bench = cells.load_benchmark() if bench is None else bench
    w = cells.workload(bench, cell)
    config = cells.config(bench, w["config"]) if config is None else config
    traffic = cells.traffic(w["traffic"]) if traffic is None else traffic
    driver = cells.module("drivers", traffic["loop"])

    state = driver.setup(config, traffic, seed, device)
    sync(device)
    # Set-up leaves some 180 k objects of the imports to a full garbage
    # collection; one that falls into the window would stall it by
    # ~0.1 s at a moment that differs from run to run. Collect here, in
    # set-up, so that the window starts from the steady state.
    gc.collect()
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(trace, device)
    with tracer.profiling():
        win = driver.window(state, seconds, tracer)
    dev = device_info(device)

    ctx = {"cell": cell, "config": config, "traffic": traffic,
           "setup_s": setup_s, "window": win, "trace": tracer.summary}
    metrics = {}
    for m in cells.metrics_of(bench, cell, trace):
        value = cells.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    answers, index, missing = driver.answers(state, win)
    state.release()
    numbers = check(state, answers, index, missing, config)

    result = {"correct": is_correct(numbers),
              "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev}
    if trace and tracer.summary is not None:
        dev["busy_s"] = tracer.summary["busy_s"]
        dev["window_s"] = tracer.summary["window_s"]
        result["breakdown"] = tracer.summary["breakdown"]
    result["check"] = numbers
    return result
