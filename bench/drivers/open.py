"""Open loop of independent clients through admission and the service.

Each request is one client's rows as host numpy rows (a slice of the
query pool, copied to the host in set-up), sent at its due time whether
or not earlier ones have finished, through ``AdmissionController.submit``
with the deadline ``due + deadline_ms``; an ``AsyncDriver`` thread flushes
the windows into the ``ScoringService`` over the model's ``BatchScorer``.
A request's latency runs from its due time to the moment its scores land
(its done callback), so a stall of the sender counts for every request
behind it; the sender's own lateness is kept apart.

The schedule is the same on every seed but for its order: ``rate`` rows
a second in requests of the sizes in ``rows``, equally many of each, and
inter-arrival gaps at the quantiles of the exponential distribution of
that rate (Poisson arrivals), both shuffled by the seed; the pool offsets
are drawn from the seed.

Traffic keys: ``rows``, ``rate_rows_per_s``, ``deadline_ms``,
``pool_bytes``, ``pool_requests``, ``warmup``.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchlib import model as bmodel
from benchlib.harness import State

NAME = "slab"
# Seconds past the last due time that a run waits for answers.
GRACE_S = 60.0


class _OneModel:
    """The registry the controller asks: one served model, no quota."""

    def __init__(self, served):
        self.served = served

    def get(self, name):
        return self.served

    def quota(self, name):
        return None


def setup(config: dict, traffic: dict, seed: int,
          device: torch.device) -> State:
    from repro_torch.serve.admission import AdmissionController
    from repro_torch.serve.scorer import BUCKETS
    slab, pool = bmodel.draw(seed, config, traffic, device)
    host = pool.cpu().numpy()
    served = bmodel.serving_model(slab, config)
    ctrl = AdmissionController(_OneModel(served), clock=time.perf_counter)
    # Coalesced windows land in any bucket: launch each through the
    # service a few times, so its latency estimates are warm ones.
    for rows in BUCKETS:
        for _ in range(int(traffic["warmup"])):
            ctrl.submit(NAME, host[:rows])
            ctrl.flush_model(NAME)
    return State(device=device, slab=slab, pool=pool,
                 program={"ctrl": ctrl, "served": served, "host": host,
                          "seed": seed, "traffic": traffic})


def schedule(traffic: dict, seconds: float, seed: int, pool_rows: int):
    """(sizes, due seconds from the start, pool offsets) of a run."""
    rng = np.random.default_rng(seed)
    kinds = np.asarray(traffic["rows"], dtype=np.int64)
    rate = float(traffic["rate_rows_per_s"]) / float(kinds.mean())
    per_kind = max(1, round(rate * seconds / len(kinds)))
    sizes = np.repeat(kinds, per_kind)
    rng.shuffle(sizes)
    n = sizes.size
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng.shuffle(gaps)
    due = np.cumsum(gaps) - gaps[0]
    offsets = rng.integers(0, pool_rows - sizes + 1)
    return sizes, due, offsets


def _snapshot(ctrl) -> dict:
    return ctrl.stats_dict().get(NAME, {})


def window(state: State, seconds: float, tracer) -> dict:
    from repro_torch.kernels.decision import ops as dec
    from repro_torch.serve.async_driver import AsyncDriver
    p = state.program
    ctrl, host, traffic = p["ctrl"], p["host"], p["traffic"]
    sizes, due, offs = schedule(traffic, seconds, p["seed"], host.shape[0])
    n = sizes.size
    deadline_s = float(traffic["deadline_ms"]) / 1e3
    done_at = np.full(n, np.nan)
    sent_at = np.full(n, np.nan)
    # Only the answers (numpy, which the garbage collector does not
    # track) outlive a request: holding the program's handles would
    # leave tens of thousands of objects for its full collections.
    results = [None] * n
    left = [n]
    lock = threading.Lock()
    all_done = threading.Event()

    def finished(i):
        def cb(handle):
            done_at[i] = time.perf_counter()
            if handle is not None:
                try:
                    results[i] = handle.result()   # landed: no flush
                except Exception:   # the request failed: no answer
                    results[i] = None
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    all_done.set()
        return cb

    before = _snapshot(ctrl)
    launches0 = dec.DECISION.launches
    driver = AsyncDriver(ctrl)
    with tracer.window():
        driver.start()
        t0 = time.perf_counter() + 0.002
        try:
            for i in range(n):
                wait = t0 + due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent_at[i] = time.perf_counter()
                q = host[offs[i]:offs[i] + sizes[i]]
                try:
                    h = ctrl.submit(NAME, q,
                                    deadline=t0 + due[i] + deadline_s)
                except Exception:   # refused: failed, never answered
                    finished(i)(None)
                    done_at[i] = np.nan
                    continue
                h.add_done_callback(finished(i))
                del h
            all_done.wait(timeout=float(due[-1]) + GRACE_S
                          - (time.perf_counter() - t0))
        finally:
            driver.stop(drain=True)
        t1 = time.perf_counter()
    after = _snapshot(ctrl)
    launches = dec.DECISION.launches - launches0
    # A request with no answer waited the whole run.
    lat = np.where(np.isnan(done_at), t1, done_at) - (t0 + due)
    return {"window_s": t1 - t0, "rows": int(sizes.sum()), "requests": n,
            "attempted": n, "failed": int(np.isnan(done_at).sum()),
            "latencies_s": lat.tolist(),
            "gen_lag_s": (sent_at - (t0 + due)).tolist(),
            "stats_before": before, "stats_after": after,
            "launches": launches,
            "support_rows": state.slab.t.shape[0],
            "results": results, "sizes": sizes, "offs": offs}


def answers(state: State, win: dict):
    """(every answer that came, its pool row, rows with no answer or a
    wrong one in length)."""
    outs, index, missing = [], [], 0
    for res, size, off in zip(win["results"], win["sizes"], win["offs"]):
        if res is None or np.shape(res) != (int(size),):
            missing += int(size)
            continue
        outs.append(np.asarray(res, dtype=np.float32))
        index.append(np.arange(off, off + size))
    win["results"] = None
    if not outs:
        return torch.empty(0), torch.empty(0, dtype=torch.long), missing
    return (torch.from_numpy(np.concatenate(outs)),
            torch.from_numpy(np.concatenate(index)), missing)
