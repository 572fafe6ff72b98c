"""Fault-tolerant step loop: periodic async checkpoints, crash restart,
heartbeat-based straggler detection, failure injection for tests.

The loop is deliberately framework-shaped: a ``StepFn`` (anything from a
training step to the SMO solver's outer iterations) runs under
supervision; failures raise, the supervisor restores the latest
checkpoint (state and data cursor) and replays. At 1000+ nodes the same
structure holds — the checkpoint store becomes a distributed FS and the
heartbeat table a side-channel service; both are injected here as
interfaces.

The loop snapshots its initial state in host memory (every tensor copied
to the CPU, its device noted) and copies it back on a restart before the
first checkpoint: a step may update the live state in place, and a
snapshot on the card would double a full-width train state there
(about 40 GiB for llama3.2-3b with AdamW).

On a mesh (``shardings``: a tree of ``sharding.specs.NamedSharding``
over the state, each rank's state its shards), every rank runs the loop
with the same steps and failures: a checkpoint is saved through
``checkpoint.reshard.save_sharded`` (full arrays, written once by the
mesh's first rank, in the JAX package's format) and restored as each
rank's shards (``manager.restore(shardings=...)``). Without it the loop
writes its own state asynchronously, as on one rank.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import (AsyncCheckpointer, _map,
                                            restore_latest)
from repro_torch.checkpoint.reshard import save_sharded
from repro_torch.utils.tree import leaves


@dataclasses.dataclass
class HeartbeatTable:
    """Simulated per-node heartbeats with straggler / failure detection."""
    n_nodes: int
    timeout_s: float = 30.0
    straggler_factor: float = 2.0
    last_beat: Dict[int, float] = dataclasses.field(default_factory=dict)
    step_times: Dict[int, List[float]] = dataclasses.field(
        default_factory=dict)

    def beat(self, node: int, step_time: Optional[float] = None,
             now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self.last_beat[node] = now
        if step_time is not None:
            self.step_times.setdefault(node, []).append(step_time)

    def dead_nodes(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [n for n in range(self.n_nodes)
                if now - self.last_beat.get(n, now) > self.timeout_s]

    def stragglers(self) -> List[int]:
        medians = {n: float(np.median(t)) for n, t in self.step_times.items()
                   if t}
        if not medians:
            return []
        global_median = float(np.median(list(medians.values())))
        return [n for n, m in medians.items()
                if m > self.straggler_factor * global_median]


class _OnHost:
    """A tensor's host copy and the device it came from."""

    def __init__(self, t: torch.Tensor):
        self.t = t.detach().to("cpu", copy=True)
        self.device = t.device


def _to_host(tree):
    return _map(lambda path, leaf: _OnHost(leaf)
                if isinstance(leaf, torch.Tensor) else copy.deepcopy(leaf),
                tree)


def _from_host(tree):
    return _map(lambda path, leaf: leaf.t.to(leaf.device, copy=True)
                if isinstance(leaf, _OnHost) else copy.deepcopy(leaf), tree)


def _first_leaf(tree):
    leaves = []
    _map(lambda path, leaf: leaves.append(leaf), tree)
    return leaves[0] if leaves else None


class FaultTolerantLoop:
    """Supervised step loop with checkpoint/restart.

    step_fn(state, batch) -> (state, metrics);
    pipeline must expose next_batch()/state_dict()/load_state_dict().
    """

    def __init__(self, step_fn: Callable, init_state: Any, pipeline,
                 ckpt_dir: str, *, save_every: int = 50,
                 max_restarts: int = 5, keep: int = 3,
                 failure_injector: Optional[Callable[[int], None]] = None,
                 shardings: Any = None):
        self.step_fn = step_fn
        self.shardings = shardings
        self.state = init_state
        # A true snapshot, in host memory (every tensor copied, its dtype
        # and device kept): a step may update the live state in place.
        self._init_state = _to_host(init_state)
        self.pipeline = pipeline
        self._init_pipeline_state = dict(pipeline.state_dict())
        self.ckpt = AsyncCheckpointer(ckpt_dir, keep=keep)
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.failure_injector = failure_injector
        self.restarts = 0
        self.metrics_log: List[dict] = []

    def _save(self, step: int):
        extra = {"data": self.pipeline.state_dict()}
        if self.shardings is None:
            self.ckpt.save(step, self.state, extra=extra)
            return
        save_sharded(self.ckpt_dir, step, self.state, self.shardings,
                     extra=extra)
        mesh = leaves(self.shardings)[0].mesh
        if mesh.rank == mesh.ranks[0]:
            self.ckpt._gc()

    def _restore(self) -> int:
        # Make sure any in-flight write has landed before picking "latest".
        self.ckpt.wait()
        restored, step = restore_latest(self.ckpt_dir, self.state,
                                        shardings=self.shardings)
        if restored is None:
            # No checkpoint yet: restart from the TRUE initial state (the
            # live state has already been mutated by the failed attempt),
            # copied again so a later attempt cannot mutate the snapshot.
            self.state = _from_host(self._init_state)
            self.pipeline.load_state_dict(dict(self._init_pipeline_state))
            return 0
        self.state = restored
        with open(os.path.join(self.ckpt_dir, f"step_{step:09d}",
                               "manifest.json")) as f:
            extra = json.load(f)["extra"]
        if "data" in extra:
            self.pipeline.load_state_dict(extra["data"])
        return step + 1

    def run(self, n_steps: int) -> Any:
        step = self._restore()
        while step < n_steps:
            try:
                if self.failure_injector is not None:
                    self.failure_injector(step)
                t0 = time.monotonic()
                batch = self.pipeline.next_batch()
                self.state, metrics = self.step_fn(self.state, batch)
                leaf = _first_leaf(self.state)
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    torch.cuda.synchronize(leaf.device)
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["step"] = step
                metrics["step_time_s"] = time.monotonic() - t0
                self.metrics_log.append(metrics)
                if (step + 1) % self.save_every == 0:
                    self._save(step)
                step += 1
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                step = self._restore()
        self.ckpt.wait()
        return self.state
