"""Start SPMD ranks on one host: one process per rank, each with its
process group, for the sharded solver and scorer.

    results = spawn_ranks(fn, 2, backend="gloo", args=(...,))

runs ``fn(rank, world_size, *args)`` in ``world_size`` processes started
with ``torch.multiprocessing``'s ``spawn`` method. Each joins one process
group through a ``file://`` rendezvous in a new temporary directory, with
``timeout=`` on the group, and returns a picklable result; the caller
gets the results in rank order. ``fn`` must be importable by name (a
module-level function), and its module must not start work on import.

Nothing is swallowed: a rank that raises, dies or does not finish within
``timeout_s`` makes ``spawn_ranks`` raise, after every rank it started
has been stopped. A rank that diverges from its peers (a collective the
others do not make) fails at the group's timeout instead of hanging.

Several processes can share one card: gloo takes CUDA tensors (NCCL
refuses two ranks on one card). With NCCL, ``fn`` picks its card
(``torch.cuda.set_device``) before its first collective.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn_ranks"]


def _rank_main(fn, rank: int, world_size: int, backend: str, init: str,
               timeout_s: float, args: Sequence, results) -> None:
    try:
        dist.init_process_group(
            backend, init_method=init, world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def _stop(procs) -> None:
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()


def spawn_ranks(fn: Callable, world_size: int, *, backend: str = "gloo",
                args: Sequence = (), timeout_s: float = 300.0,
                dir: Optional[str] = None) -> List:
    """``[fn(0, world_size, *args), ..., fn(world_size - 1, ...)]``, each
    run in its own rank process (see the module docstring). ``dir`` is
    where the rendezvous directory is made (default: the system's
    temporary directory). Raises ``RuntimeError`` naming the ranks that
    failed, with their tracebacks, and ``TimeoutError`` when the ranks
    have not all reported within ``timeout_s``."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=dir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, init,
                                   timeout_s, tuple(args), results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        done, failed = {}, {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(done) + len(failed) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world_size)) - set(done))}"
                        f" did not finish within {timeout_s} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    # A rank that died without reporting (killed, or a
                    # crash below Python) would leave its peers waiting.
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None
                            and r not in done and r not in failed]
                    if dead:
                        time.sleep(0.5)     # its report may be in flight
                        if results.empty():
                            raise RuntimeError(
                                f"ranks {dead} exited with codes "
                                f"{[procs[r].exitcode for r in dead]} "
                                "without a result")
                    continue
                (done if ok else failed)[rank] = out
        finally:
            _stop(procs)
    if failed:
        raise RuntimeError(f"ranks {sorted(failed)} failed:\n" + "\n".join(
            f"--- rank {r}\n{failed[r]}" for r in sorted(failed)))
    return [done[r] for r in range(world_size)]
