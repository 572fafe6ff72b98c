"""Slab scoring-service launcher: the OCSSVM serving subsystem as a CLI.

Fits (or cache-hits) a slab on the toy problem, then drives a synthetic
request stream through the micro-batching ``ScoringService`` and prints
per-bucket latency/throughput counters. Runs on the CUDA card unless
given ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve_slab --m 2000 \
        --requests 64 --min-batch 8 --max-batch 512

    # sharded scoring: the stream runs SPMD in 4 rank processes (NCCL with
    # a card a rank; gloo on the CPU or when ranks share a card)
    PYTHONPATH=src python -m repro_torch.launch.serve_slab \
        --sharded-devices 4

    # multi-model: registry + deadline-aware admission windows (keep the
    # quota strictly below --max-batch, or bucket fill drains the window
    # before the quota can bind — the controller warns if it cannot)
    PYTHONPATH=src python -m repro_torch.launch.serve_slab \
        --models a=rbf:0.5 --models b=linear --deadline-ms 20 --quota 256

    # same fleet, flushed by the background event-loop driver instead of
    # the submit loop polling (deadlines honored with nobody polling)
    PYTHONPATH=src python -m repro_torch.launch.serve_slab \
        --models a=rbf:0.5 --models b=linear --deadline-ms 20 --driver

    # cross-process fleet: one process fits and publishes the packed
    # model to shared memory, N others attach (bitwise-identical, no fit)
    PYTHONPATH=src python -m repro_torch.launch.serve_slab --shm-publish warm-rbf
    PYTHONPATH=src python -m repro_torch.launch.serve_slab --shm-attach warm-rbf

The data are ``repro_torch.data.make_toy`` rows: the same construction as
the JAX package's CLI, other bits (numpy's generator, not jax.random).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

import repro_torch
from repro_torch.core import SlabSpec, linear, poly, rbf
from repro_torch.data import make_toy
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.spawn import spawn_ranks
from repro_torch.serve import (AdmissionController, AsyncDriver, ModelRegistry,
                               QuotaExceededError, ScoringService, attach,
                               live_refs, publish, run_request_stream)

# Time limit of the sharded stream's rank processes (and their group).
SHARDED_TIMEOUT_S = 600.0


def _make_kernel(name: str, gamma: float):
    if name == "linear":
        return linear()
    if name == "poly":
        return poly(gamma=gamma, coef0=1.0, degree=2)
    if name == "rbf":
        return rbf(gamma=gamma)
    raise ValueError(f"unknown kernel {name!r} (linear/rbf/poly)")


def _kernel(args):
    return _make_kernel(args.kernel, args.gamma)


def _parse_model_flag(flag: str, args) -> tuple:
    """``NAME=KERNEL[:GAMMA[:NU1[:NU2[:EPS]]]]`` -> (name, SlabSpec).

    Unspecified fields inherit the single-model CLI defaults, so
    ``--models a=rbf:0.5 --models b=linear`` is a complete fleet spec.
    """
    name, sep, conf = flag.partition("=")
    if not sep or not name or not conf:
        raise ValueError(f"--models wants NAME=KERNEL[:GAMMA[:NU1[:NU2"
                         f"[:EPS]]]], got {flag!r}")
    parts = conf.split(":")
    kernel_name = parts[0]
    floats = [float(p) for p in parts[1:]]
    gamma = floats[0] if len(floats) > 0 else args.gamma
    nu1 = floats[1] if len(floats) > 1 else args.nu1
    nu2 = floats[2] if len(floats) > 2 else args.nu2
    eps = floats[3] if len(floats) > 3 else args.eps
    return name, SlabSpec(nu1=nu1, nu2=nu2, eps=eps,
                          kernel=_make_kernel(kernel_name, gamma))


def _requests(args) -> list:
    rng = np.random.default_rng(args.seed)
    sizes = rng.integers(args.min_batch, args.max_batch + 1,
                         size=args.requests)
    return [make_toy(1000 + i, int(n))[0] for i, n in enumerate(sizes)]


def _run_multi_model(args):
    """Registry + admission-controller serving loop for ``--models``."""
    X, _ = make_toy(args.seed, args.m)
    registry = ModelRegistry()
    for flag in args.models:
        name, spec = _parse_model_flag(flag, args)
        registry.register(name, X, spec, quota=args.quota, tol=args.tol,
                          P=16, precision=args.precision,
                          device=args.device)
    names = registry.names()

    ctrl = AdmissionController(registry, max_batch=args.max_batch,
                               max_wait_s=args.max_wait_ms / 1e3)
    t0 = time.perf_counter()
    for name in names:
        svc = ctrl.service(name)          # fit-on-first-use happens here
        svc.scorer.warmup()
        sm = registry.get(name)
        print(f"model {name}: {sm.n_sv} SVs packed {tuple(sm.t_pad.shape)} "
              f"[{args.precision}] quota={registry.quota(name)}")
    print(f"fleet of {len(names)} models warm in "
          f"{(time.perf_counter() - t0)*1e3:.0f} ms "
          f"(cache {registry.cache.hits} hits / "
          f"{registry.cache.misses} misses)")

    requests = _requests(args)
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms else None
    handles, rejected = [], 0

    def submit_stream():
        nonlocal rejected
        for i, q in enumerate(requests):
            model = names[i % len(names)]
            deadline = (ctrl.clock() + deadline_s) if deadline_s else None
            try:
                handles.append(ctrl.submit(model, q, deadline=deadline))
            except QuotaExceededError:
                rejected += 1
            if not args.driver:
                ctrl.poll()

    t0 = time.perf_counter()
    if args.driver:
        # the background driver owns every flush: it sleeps until the
        # earliest pending window is due (deadline pressure, window age,
        # bucket fill) and polls — the submit loop never does
        with AsyncDriver(ctrl):
            submit_stream()
            wait_until = time.monotonic() + 60.0
            while (not all(h.done for h in handles)
                   and time.monotonic() < wait_until):
                time.sleep(0.002)
        # context exit stops the driver after a final drain
    else:
        submit_stream()
        ctrl.drain()
    stream_s = time.perf_counter() - t0
    served_q = sum(h.n for h in handles)
    mode = "driver" if args.driver else "inline poll"
    print(f"stream[{mode}]: {len(handles)}/{args.requests} requests "
          f"admitted ({rejected} over quota) / {served_q} queries in "
          f"{stream_s*1e3:.0f} ms ({served_q/max(stream_s, 1e-9):.0f} q/s)")
    for line in ctrl.stats_lines():
        print("  " + line)

    inside = sum(int((np.asarray(h.result()) >= 0).sum()) for h in handles)
    print(f"decisions: {inside}/{served_q} inside the slab")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"m": args.m, "models": list(names),
                       "precision": args.precision,
                       "deadline_ms": args.deadline_ms,
                       "quota": args.quota, "stream_s": stream_s,
                       "requests": args.requests, "admitted": len(handles),
                       "rejected": rejected, "queries": served_q,
                       "per_model": ctrl.stats_dict()}, fh, indent=2)
        print(f"wrote {args.json}")


def _stream(args, sm, scorer, cold_s: float) -> None:
    """The request stream through a ``ScoringService`` over ``scorer``:
    per-bucket counters, the inside-slab count and the JSON stats."""
    # warmup pre-launches every bucket this scorer will serve (the
    # sharded scorer's buckets per rank when sharded)
    scorer.warmup()
    requests = _requests(args)
    svc = ScoringService(scorer)
    t0 = time.perf_counter()
    scores = run_request_stream(svc, requests, coalesce=args.coalesce)
    stream_s = time.perf_counter() - t0
    total_q = sum(len(q) for q in requests)
    print(f"stream: {args.requests} requests / {total_q} queries in "
          f"{stream_s*1e3:.0f} ms ({total_q/stream_s:.0f} q/s)")
    for line in svc.stats_lines():
        print("  " + line)

    inside = sum(int((np.asarray(s) >= 0).sum()) for s in scores)
    print(f"decisions: {inside}/{total_q} inside the slab")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"m": args.m, "n_sv": sm.n_sv,
                       "precision": sm.precision, "cold_s": cold_s,
                       "stream_s": stream_s, "requests": args.requests,
                       "queries": total_q,
                       "buckets": svc.stats_dict()}, fh, indent=2)
        print(f"wrote {args.json}")


def _moved(sm, device):
    """``sm`` with every tensor on ``device``, bits unchanged (no fit
    artifact, no memoized scorer)."""
    model = sm.model._replace(gamma=sm.model.gamma.to(device),
                              rho1=sm.model.rho1.to(device),
                              rho2=sm.model.rho2.to(device),
                              X=sm.model.X.to(device))
    return dataclasses.replace(sm, model=model, t_pad=sm.t_pad.to(device),
                               gamma_pad=sm.gamma_pad.to(device),
                               t_norms=sm.t_norms.to(device),
                               artifact=None, _scorer=None)


def _sharded_rank(rank: int, world: int, args, host_sm, cold_s: float,
                  cards: int) -> None:
    """One rank of ``--sharded-devices``: every rank scores the same
    stream through ``scorer(mesh=)``; rank 0 prints and writes the
    JSON."""
    if torch.device(args.device).type == "cuda":
        torch.cuda.set_device(rank % cards)
        device = torch.device("cuda", rank % cards)
    else:
        device = torch.device(args.device)
    mesh = make_test_mesh((world,), ("data",))
    sm = _moved(host_sm, device)
    scorer = sm.scorer(mesh=mesh)
    if rank == 0:
        print(f"sharded scoring over {world} devices (axis 'data')")
        _stream(args, sm, scorer, cold_s)
        sys.stdout.flush()
    else:
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            _stream(argparse.Namespace(**dict(vars(args), json=None)), sm,
                    scorer, cold_s)


def _run_sharded(args, sm, cold_s: float) -> None:
    """The stream SPMD over ``--sharded-devices`` rank processes: NCCL
    with a card a rank, gloo on the CPU or when ranks share a card."""
    n = args.sharded_devices
    cards = torch.cuda.device_count() \
        if torch.device(args.device).type == "cuda" else 0
    backend = "nccl" if cards >= n else "gloo"
    sys.stdout.flush()
    spawn_ranks(_sharded_rank, n, backend=backend,
                args=(args, _moved(sm, "cpu"), cold_s, max(cards, 1)),
                timeout_s=SHARDED_TIMEOUT_S)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=2000, help="training rows")
    ap.add_argument("--kernel", choices=("linear", "rbf", "poly"),
                    default="rbf")
    ap.add_argument("--gamma", type=float, default=0.5)
    ap.add_argument("--nu1", type=float, default=0.5)
    ap.add_argument("--nu2", type=float, default=0.05)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--requests", type=int, default=32,
                    help="synthetic requests in the stream")
    ap.add_argument("--min-batch", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=512)
    ap.add_argument("--coalesce", type=int, default=8,
                    help="requests submitted per flush window")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", choices=("f32", "bf16", "f16"),
                    default="f32",
                    help="Gram tile precision for fit AND the packed "
                         "serving model (16-bit halves kernel HBM bytes)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where to fit and score (default: the CUDA card; "
                         "cpu runs the kernels' plain versions)")
    ap.add_argument("--sharded-devices", type=int, default=0,
                    help="score through the sharded scorer over this many "
                         "rank processes (NCCL with a card each, else gloo)")
    ap.add_argument("--json", type=str, default=None,
                    help="also write the stats to this path as JSON")
    ap.add_argument("--models", action="append", default=None,
                    metavar="NAME=KERNEL[:GAMMA[:NU1[:NU2[:EPS]]]]",
                    help="repeatable; switches on the multi-model "
                         "registry + admission-controller path (e.g. "
                         "--models a=rbf:0.5 --models b=linear)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for the admission windows "
                         "(multi-model path; default: no deadlines)")
    ap.add_argument("--quota", type=int, default=None,
                    help="per-model admission quota in queued rows "
                         "(multi-model path; default: unlimited)")
    ap.add_argument("--max-wait-ms", type=float, default=50.0,
                    help="age bound for deadline-less admission windows")
    ap.add_argument("--driver", action="store_true",
                    help="flush via the background AsyncDriver instead "
                         "of polling from the submit loop (multi-model "
                         "path)")
    ap.add_argument("--shm-publish", type=str, default=None, metavar="KEY",
                    help="publish the packed model to shared memory "
                         "under KEY (single-model path)")
    ap.add_argument("--shm-attach", type=str, default=None, metavar="KEY",
                    help="attach the packed model published under KEY "
                         "instead of fitting (single-model path)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    if args.models:
        return _run_multi_model(args)

    leases = []
    if args.shm_attach:
        # worker side of the cross-process fleet: rebuild the packed
        # model from shared memory — no fit, bitwise-identical scores
        t0 = time.perf_counter()
        sm, lease = attach(args.shm_attach, device=args.device)
        leases.append(lease)
        cold_s = time.perf_counter() - t0
        print(f"attach[{args.shm_attach!r}]: {sm.n_sv} SVs packed "
              f"{tuple(sm.t_pad.shape)} [{sm.precision}] in "
              f"{cold_s*1e3:.0f} ms (no fit; "
              f"{live_refs(args.shm_attach)} live leases)")
    else:
        spec = SlabSpec(nu1=args.nu1, nu2=args.nu2, eps=args.eps,
                        kernel=_kernel(args))
        X, _ = make_toy(args.seed, args.m)

        t0 = time.perf_counter()
        sm = repro_torch.serve(X, spec, tol=args.tol, P=16,
                               precision=args.precision, device=args.device)
        cold_s = time.perf_counter() - t0
        cache = repro_torch.serve.default_cache()
        print(f"serve: m={args.m} -> {sm.n_sv} SVs packed "
              f"{tuple(sm.t_pad.shape)} [{args.precision}] in "
              f"{cold_s*1e3:.0f} ms "
              f"(cache {cache.hits} hits / {cache.misses} misses)")
    try:
        if args.shm_publish:
            leases.append(publish(sm, args.shm_publish))
            print(f"publish[{args.shm_publish!r}]: segment live, "
                  f"{live_refs(args.shm_publish)} leases — workers attach "
                  f"with --shm-attach {args.shm_publish} (last lease out "
                  f"unlinks)")
        if args.sharded_devices:
            _run_sharded(args, sm, cold_s)
        else:
            _stream(args, sm, sm.scorer(), cold_s)
    finally:
        for lease in leases:
            lease.close()


if __name__ == "__main__":
    main()
