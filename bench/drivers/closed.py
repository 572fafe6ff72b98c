"""Closed loop of device-tensor requests through ``BatchScorer.score``.

The queries already lie on the card, as a decoder or an embedder leaves
them: request i scores ``rows`` rows of the query pool from an offset
drawn from the seed, and the next request goes out as soon as fewer than
``depth`` are in flight (a CUDA event a request). The window ends with
the card synchronised, so every request sent is finished inside it.

The check reads a sample of the answers drawn from the seed: a reservoir
of ``KEPT`` requests (Algorithm R), so that the answers the benchmark
holds on the card stay the same few megabytes however many requests the
window sends, and set-up leaves the allocator's cache room for them: the
window makes no ``cudaMalloc`` of the benchmark's.

Traffic keys: ``rows`` (one size), ``depth``, ``pool_bytes``,
``pool_requests``, ``warmup``.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from benchlib import model as bmodel
from benchlib.harness import State, sync

# Requests whose answers the check reads.
KEPT = 1024


def setup(config: dict, traffic: dict, seed: int,
          device: torch.device) -> State:
    from repro_torch.kernels.decision import ops as dec
    (n,) = traffic["rows"]
    slab, pool = bmodel.draw(seed, config, traffic, device)
    served = bmodel.serving_model(slab, config)
    scorer = served.scorer()
    # The one shape this traffic sends, launched until it runs warm.
    for _ in range(int(traffic["warmup"])):
        scorer.score(pool[:n])
    depth = int(traffic["depth"])
    room = [torch.empty((n,), device=device)
            for _ in range(KEPT + 2 * depth)]
    del room
    sync(device)
    return State(device=device, slab=slab, pool=pool,
                 program={"served": served, "scorer": scorer,
                          "launches": dec.DECISION, "n": n, "depth": depth,
                          "rng": np.random.default_rng(seed)})


def window(state: State, seconds: float, tracer) -> dict:
    p = state.program
    scorer, n, depth, rng = p["scorer"], p["n"], p["depth"], p["rng"]
    pool = state.pool
    top = pool.shape[0] - n + 1
    cuda = state.device.type == "cuda"
    outs, offs, host_s = [], [], []
    inflight = deque()
    launches0 = p["launches"].launches
    i = 0
    with tracer.window():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if len(inflight) >= depth:
                inflight.popleft().synchronize()
            if i % 1024 == 0:   # offsets and reservoir slots, from the seed
                offsets = rng.integers(0, top, size=1024)
                slots = rng.integers(0, np.arange(i, i + 1024) + 1)
            off, slot = int(offsets[i % 1024]), int(slots[i % 1024])
            a = time.perf_counter()
            out = scorer.score(pool[off:off + n])
            host_s.append(time.perf_counter() - a)
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                inflight.append(ev)
            if i < KEPT:
                outs.append(out)
                offs.append(off)
            elif slot < KEPT:
                outs[slot], offs[slot] = out, off
            i += 1
        sync(state.device)
        t1 = time.perf_counter()
    return {"window_s": t1 - t0, "rows": n * i, "requests": i,
            "attempted": i, "failed": 0,
            "launches": p["launches"].launches - launches0,
            "scorer_host_s": host_s, "support_rows": state.slab.t.shape[0],
            "outs": outs, "offs": offs, "n": n}


def answers(state: State, win: dict):
    """(the sampled answers, their pool rows, answers missing): every
    request was finished inside the window; a sampled one whose answer has
    the wrong length counts its rows as missing."""
    n = win["n"]
    good = [(o.reshape(-1), off) for o, off in zip(win["outs"], win["offs"])
            if o.numel() == n]
    missing = n * (len(win["outs"]) - len(good))
    win["outs"].clear()
    if not good:
        return torch.empty(0), torch.empty(0, dtype=torch.long), missing
    out = torch.cat([o for o, _ in good])
    offs = torch.tensor([off for _, off in good], dtype=torch.long)
    index = (offs[:, None] + torch.arange(n)[None, :]).reshape(-1)
    return out, index, missing
