#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing the result line:

1. build    — compile every ``src/repro_torch/csrc/*.cu`` (one nvcc
              each, all at once), print ptxas's register/shared-memory
              lines and hold the autotuner's register estimate against
              them;
2. kernels  — call each kernel's wrapper at the main path's shapes (gram:
              the 8192 x 8192 matrix of the toy rows, a ragged shape and
              one whose rows are no multiple of a tile; fupdate: the hot
              loop at S = 16, 32 and the init pass; decision: every
              bucket against 4096 packed support rows, with the entry
              the bucket picks) and hold it against its plain PyTorch
              version on the card; relaunch decision on the same inputs
              (bitwise equal: its split sums are added in a fixed
              order); launch every menu entry of every family at a small
              ragged shape, in each precision its class takes, against
              its plain version and bitwise against its class's default
              entry;
3. main     — ``fit`` (f32 and bf16) then ``serve(...).score`` on the toy
              set at m = 8192, d = 128, with the kernels' launch counts
              set to 0 just before and read just after;
   shrink   — ``fit`` with no strategy at m = 32768 (f32 and bf16): it
              must take the shrinking driver, converge feasibly and agree
              with the blocked solve (``strategy="pallas"``) on the
              objective and both offsets; its solves (rows, offset,
              iterations) and fupdate's launches by class;
   paper    — the paper's Table 1 (linear, nu1 = 0.5, nu2 = 0.01,
              eps = 2/3, d = 2, m = 500-5000): the paper and mvp SMO,
              the blocked solver and the FISTA QP baseline, iterations,
              seconds (the second of two calls) and MCC; every SMO
              objective at most the QP's plus its tolerance;
   warm     — ``fit_update`` of the main path's f32 and bf16 fits after
              5% of the rows expire and 5% are appended, beside a cold
              fit of the same precision: warm route, every fupdate launch
              of the wide classes (the SIMT split tile, the wgmma split
              kernel), the same objective; the reconcile against the
              plain K @ gamma0; the artifact saved, loaded and refit
              bitwise;
   serve-wide — a bf16 model of d = 768 (BERT-base pooled embeddings)
              scored through the scorer at every bucket, and one of
              d = 2048 at the smallest, against the plain decision with
              no label flipped: each bucket takes a decision entry whose
              query tile fits d (the streamed one above 1664), and every
              entry that fits gives bitwise the same values;
   fleet    — the serving control plane: a ModelRegistry of three tenants
              (main-f32 and main-bf16 on the first 7783 [main] rows,
              wide-bf16 on [serve-wide]'s 4096 rows at d = 768), each
              fitted on first use; a few hundred requests of
              REQUEST_SIZES from one asyncio loop (``serve_async``)
              through an AdmissionController with per-tenant quotas and
              its AsyncDriver on the real clock, every result held against
              the tenant's direct score (bitwise at d = 128, within
              TOLERANCES at d = 768); one group that spans two buckets and
              one request over its quota (QuotaExceededError); a
              drift-gated refresh of main-f32 with the 409 remaining rows
              (warm: KS below 0.35, m = 8192, every fupdate launch wide)
              and with them shifted by 5 (cold), each objective within
              truth_tolerance of a cold fit of the same rows, the version
              bumped and later traffic scored by the new model; main-bf16
              published to shared memory and attached by a spawned process
              on the card that scores 1024 rows bitwise the publisher's,
              its leases counted 2, 1 and the segment unlinked; per bucket
              the traffic's launch latency (warm p50, p99) beside the
              scorer's and a ScoringService's on one quiet thread;
4. autotune — the autotuner's path, with the counts set to 0 just before
              and read just after: a quick sweep on the card over
              ``QUICK_CELLS`` and the main path's fupdate and gram cells,
              in f32 (gram's SIMT class) and then bf16 (its wgmma class),
              its winners and seconds; then the f32 fit with the committed
              tile table and with an empty one, which must be bitwise
              equal;
5. timing   — device times of each kernel and its plain version (CUDA
              events around a CUDA graph of repeated calls), each with the
              menu entry it launched and where that came from, beside the
              least time the card could take (its bound) and, for gram
              linear, the one PyTorch call that computes the same
              (``x @ y.T``; ``torch.mm(..., out_dtype=float32)`` for 16-bit
              rows); what sets the wgmma gram's pace (its time at d = 64,
              128, 256, the output fixed) and a one-CTA fupdate (the floor
              of a launch in a graph); decision at every bucket and
              precision against SUPPORT rows and against the served
              model's, beside its plain version, its bound and its rbf
              exp floor, and at the top bucket with the linear kernel
              (no exp) beside rbf; bf16 decision at d = 768 and 2048;
              fupdate's wide classes at the warm path's shapes in f32
              and bf16; the scorer's latency per bucket on the host's
              clock, and its host share (latency minus the kernel's time
              at the bucket);
6. trace    — a torch.profiler window over PROFILE_ITERS iterations of
              the f32 fit: the device's busy and idle share from its own
              events, the top kernels by device time and the top
              operations by host time.

The last three lines are a JSON line with one entry per kernel, the
card's name and power limit as nvidia-smi gives them, and the result line
``{"ok": true, "device": {...}}``. Needs one card, the CUDA toolkit
(nvcc) and the repository's ``src/`` beside this file; imports nothing of
JAX.

    python3 chip_smoke.py --cards N

runs [dist] alone over N NCCL ranks, one card each (the cross-card path
a one-card run cannot reach), held against single-device fits of the
same rows on the first card; it needs N cards.
"""
from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

SEED = 0
M, D = 8192, 128          # the largest m "auto" solves as one blocked solve
P, TOL = 16, 1e-3         # examples/serve_ocssvm.py's solver settings
# rbf width scaled with d (gamma * d = 1, as the example's 0.5 at d = 2).
# At d = 128 two toy rows lie ~39 apart in squared distance, so rbf(0.5)
# would make the Gram matrix nearly the identity and the uniform start
# nearly optimal: the solve could stop before its first iteration.
RBF_GAMMA = 1.0 / D
REQUEST_SIZES = (1, 63, 64, 65, 1000, 4096)
INIT_M = 2048             # the fused init pass: S = m <= BLOCK
# fupdate's (m, S): the hot loop at P = 8 and at P = 16, and the init pass.
FUPDATE_SHAPES = ((M, 16), (M, 2 * P), (INIT_M, INIT_M))
SUPPORT = 4096            # packed support rows the decision kernel meets
# [serve-wide]: the width of BERT-base pooled embeddings, scored at every
# bucket, and one past every resident 16-bit query tile (1664).
WIDE_D, WIDEST_D = 768, 2048
SHRINK_M = 32768          # [shrink]: "auto" takes the shrinking driver
SOLVER_ATOL_FLOOR = 5e-3  # tests/test_engine_parity.py's solver floor
# [fleet]: windows of up to two top buckets (a group past 4096 rows spans
# buckets); a quota that binds below that (<= max_batch - 2); traffic in
# waves of FLEET_PER_WAVE requests a tenant, each with a deadline.
FLEET_MAX_BATCH = 2 * 4096
FLEET_QUOTA = 8000
FLEET_WAVES, FLEET_PER_WAVE = 25, 4
FLEET_DEADLINE_S = 0.01
# [fleet]'s attaching process: attach a published model on the card, score
# 1024 toy rows, save them, and report the attach time (the card's context
# made first, timed apart) and live leases.
FLEET_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from repro_torch.data import make_toy
from repro_torch.serve import attach, live_refs
key, spool = sys.argv[2], sys.argv[3]
t0 = time.perf_counter()
torch.zeros(1, device="cuda")             # the card's context, first
torch.cuda.synchronize()
context_s = time.perf_counter() - t0
t0 = time.perf_counter()
sm, lease = attach(key, dir=spool)
torch.cuda.synchronize()
attach_s = time.perf_counter() - t0
np.save(sys.argv[5], sm.score(make_toy(int(sys.argv[4]), 1024, d=sm.d)[0]))
refs = live_refs(key, dir=spool)
lease.close()
print(json.dumps({"attach_s": attach_s, "context_s": context_s,
                  "live_refs": refs, "device": str(sm.t_pad.device)}))
"""
# [dist]: requests of twice each bucket (per rank: every bucket, 64-4096)
# and one odd size; each spawned job's time limit (also its process
# group's timeout).
DIST_REQUESTS = (128, 512, 2048, 8192, 1001)
DIST_TIMEOUT_S = 600
QP_SIZES = 4              # [paper] runs the QP at the first QP_SIZES sizes
PROFILE_ITERS = 100       # solver iterations inside the profiler window
# gram: the kernel matrix of the main path's rows, a ragged shape and one
# whose rows are no multiple of a tile.
GRAM_SHAPES = ((M, M, D), (130, 77, 129), (M + 1, 300, D))
MENU_ROWS, MENU_D = 203, 45   # the menu check's ragged shape
# fupdate's S in the menu check: the hot loop's (narrow class) and a wide
# one (the split classes).
MENU_S = {"narrow": 20, "wide": 77}
GRAM_TIMED = (("linear", "f32"), ("linear", "bf16"), ("linear", "f16"),
              ("rbf", "f32"), ("rbf", "bf16"), ("rbf", "f16"))
# gram's feature widths at a fixed output: whether the output or the
# inputs set the wgmma kernel's pace.
GRAM_PACE_D = (64, 128, 256)
# The rbf decision's exp floor: one expf a query-support pair on the SFUs,
# 16 a clock on each of the H100's 132 SMs, at 1.83 GHz (the clock of
# the card's published peak rates).
SFU_EXPS_PER_S = 132 * 16 * 1.83e9


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def _traced(fit) -> dict:
    """``fit()`` (a solve) under torch.profiler: wall seconds, iterations,
    the device's busy seconds (the union of its own events' intervals:
    the operators' rows of key_averages() carry their kernels' time too),
    its events, and the top kernels by device time and operations by host
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in on_card):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    per_name = {}
    for e in on_card:
        calls, us = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"iters": int(res.iters), "wall_s": wall, "busy_s": busy_us / 1e6,
            "events": len(on_card),
            "device": [(n[:60], c, us / 1e3) for n, (c, us) in sorted(
                per_name.items(), key=lambda kv: -kv[1][1])[:10]],
            "host": [(e.key[:60], e.count, e.self_cpu_time_total / 1e3)
                     for e in host[:10]]}


def _say_trace(tag: str, what: str, tr: dict) -> None:
    iters, busy, wall = max(1, tr["iters"]), tr["busy_s"], tr["wall_s"]
    say(f"{tag} {what} iters={tr['iters']} wall_s={wall:.4f} "
        f"device_busy_s={busy:.6f} device_idle_share={1 - busy / wall:.4f} "
        f"device_ms_per_iter={1e3 * busy / iters:.4f} "
        f"device_events_per_iter={tr['events'] / iters:.1f}" if busy > 0
        else f"{tag} device time: not measured (the profiler saw none)")
    for name, calls, ms in tr["device"]:
        say(f"{tag} device {name!r}: calls={calls} ms={ms:.3f}")
    for key, calls, ms in tr["host"]:
        say(f"{tag} host {key!r}: calls={calls} self_cpu_ms={ms:.3f}")


def _dist_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of [dist], in its own process on the card (see
    ``repro_torch.launch.spawn_ranks``): the distributed fits of
    ``job["precisions"]`` on [main]'s data; with ``job["full"]`` also a
    ledger solve at m = 2048, the sharded fit at SHRINK_M and the sharded
    warm refit; then the sharded scorer on [main]'s served model. Returns
    plain numbers and numpy arrays for the parent to check."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import repro_torch
    from repro_torch import api
    from repro_torch.core import SlabSpec, rbf
    from repro_torch.core.engine import (CollectiveLedger,
                                         artifact_from_result)
    from repro_torch.core.ocssvm import OCSSVMModel
    from repro_torch.data import make_toy
    from repro_torch.kernels import tiling
    from repro_torch.kernels.decision import ops as dec
    from repro_torch.kernels.fupdate import ops as fup
    from repro_torch.launch import make_solver_mesh
    from repro_torch.serve import pack_model

    torch.cuda.set_device(rank % job["cards"])     # cards=1: all on one
    dev = api.resolve_device("cuda")
    mesh, axes = make_solver_mesh()
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=rbf(RBF_GAMMA))
    X = make_toy(SEED, M, d=D)[0]
    narrow = {c.entry for c in tiling.menu("fupdate", 2 * P)}

    def reset():
        fup.FUPDATE.reset_counts()
        dec.DECISION.reset_counts()

    def drive(fn) -> tuple:
        reset()
        led = CollectiveLedger()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(led)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        iters = int(res.iters)
        by = fup.FUPDATE.by_entry
        n_narrow = sum(n for e, n in by.items() if e in narrow)
        return res, {
            "iters": iters, "seconds": secs,
            "ms_per_iter": 1e3 * secs / max(iters, 1),
            "converged": bool(res.converged),
            "gamma": res.model.gamma.cpu().numpy(),
            "rho": (float(res.model.rho1), float(res.model.rho2)),
            "fupdate": {"narrow": n_narrow,
                        "wide": sum(by.values()) - n_narrow},
            "decision": dec.DECISION.launches,
            "comm_s_per_iter": led.seconds / max(iters, 1),
            "comm_calls": led.calls, "ledger": led.summary()}

    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": torch.cuda.get_device_name(0), "fits": {}}
    main = {}
    for precision in job["precisions"]:
        main[precision], out["fits"][f"main-{precision}"] = drive(
            lambda led: repro_torch.fit(
                X, spec, strategy="distributed", mesh=mesh, data_axes=axes,
                P=P, tol=TOL, precision=precision, ledger=led))
    if job["full"]:
        _, out["fits"]["ledger-2048"] = drive(
            lambda led: repro_torch.fit(
                X[:2048], spec, strategy="distributed", mesh=mesh,
                data_axes=axes, P=P, tol=TOL, max_outer=50, ledger=led))
        routes, real = [], api.solve_sharded_shrinking

        def route_spy(*a, **k):
            routes.append("sharded-shrinking")
            return real(*a, **k)

        api.solve_sharded_shrinking = route_spy
        try:
            X_shr = make_toy(SEED, SHRINK_M, d=D)[0]
            _, rec = drive(lambda led: repro_torch.fit(
                X_shr, spec, strategy="sharded", mesh=mesh, data_axes=axes,
                P=P, tol=TOL, ledger=led))
        finally:
            api.solve_sharded_shrinking = real
        rec["routes"] = routes
        out["fits"]["shrink-f32"] = rec
        n_delta = M * 5 // 100
        X_new = np.concatenate([X[n_delta:],
                                make_toy(SEED + 7, n_delta, d=D)[0]])
        art = artifact_from_result(main["f32"], precision="f32")
        st = {}
        _, rec = drive(lambda led: repro_torch.fit_update(
            art, X_new, tol=TOL, mesh=mesh, data_axes=axes, stats_out=st,
            ledger=led))
        rec["stats"] = {k: st[k] for k in ("mode", "n_overlap", "n_fresh",
                                           "n_expired", "n_corr", "P")}
        out["fits"]["warm-f32"] = rec

    # Where a distributed iteration's time goes: a profiler window over
    # PROFILE_ITERS iterations (every rank runs it: the solve is SPMD).
    out["trace"] = _traced(lambda: repro_torch.fit(
        X, spec, strategy="distributed", mesh=mesh, data_axes=axes, P=P,
        tol=TOL, max_outer=PROFILE_ITERS))
    sv = job["served"]
    model = OCSSVMModel(
        gamma=torch.as_tensor(sv["gamma"], device=dev),
        rho1=torch.tensor(sv["rho1"], device=dev),
        rho2=torch.tensor(sv["rho2"], device=dev),
        X=torch.as_tensor(sv["X"], device=dev), spec=spec)
    sm = pack_model(model, tn=sv["tn"])
    scorer = sm.scorer(mesh=mesh, data_axis="data")
    queries = {n: make_toy(SEED + 1 + n, n, d=D)[0] for n in job["requests"]}
    reset()
    t0 = time.perf_counter()
    scores = {n: scorer.score(q) for n, q in queries.items()}
    torch.cuda.synchronize()
    out["score_seconds"] = time.perf_counter() - t0
    out["score_launches"] = {"decision": dec.DECISION.launches,
                             "fupdate": fup.FUPDATE.launches}
    out["scores"] = scores
    out["buckets"] = {n: scorer.bucket_used(n) for n in queries}
    # The rank's own single-device scorer (not counted: a check).
    out["local_bitwise"] = all(
        scores[n].tobytes() == sm.score(q).tobytes()
        for n, q in queries.items())
    return out


def _dist_phase(jobs: dict, ref: dict):
    """[dist]'s drive and checks: spawn each job's rank processes
    (``jobs``: backend -> (world size, job for ``_dist_rank``)) and hold
    what they return against the single-device results in ``ref`` (the
    card ``dev``, ``spec``, the served model ``sm``, the rows ``X`` /
    ``X_shr`` / ``X_new`` and the fits ``main`` (by precision), ``shrink``
    and ``warm``). Returns ({backend: fupdate launches by rank and fit},
    {backend: decision launches by rank})."""
    import numpy as np
    import torch
    from repro_torch.core import dual_objective_matfree
    from repro_torch.data import make_toy
    from repro_torch.kernels.precision import truth_tolerance
    from repro_torch.launch import spawn_ranks
    dev, spec, sm = ref["dev"], ref["spec"], ref["sm"]
    phase_t0 = time.perf_counter()
    ranks, job_s = {}, {}
    for backend, (world, job) in jobs.items():
        t0 = time.perf_counter()
        ranks[backend] = spawn_ranks(_dist_rank, world, backend=backend,
                                     args=(job,), timeout_s=DIST_TIMEOUT_S)
        job_s[backend] = time.perf_counter() - t0
    X_dev = torch.as_tensor(ref["X"], device=dev)
    Xs_shr = torch.as_tensor(ref["X_shr"], device=dev)
    Xn_warm = torch.as_tensor(ref["X_new"], device=dev)

    def held(rec, single, Xd, what, iters=True):
        """A rank's fit against the single-device fit of the same rows:
        converged, feasible, objective and offsets within truth_tolerance
        + SOLVER_ATOL_FLOOR, iterations within 10% (ROADMAP C.6)."""
        m = Xd.shape[0]
        g = torch.as_tensor(rec["gamma"], device=dev).double()
        check(rec["converged"], f"{what}: did not converge")
        check(abs(float(g.sum()) - spec.total()) < 1e-4,
              f"{what}: sum(gamma) = {float(g.sum())}")
        check(float(g.max()) <= spec.upper(m) + 1e-7
              and float(g.min()) >= spec.lower(m) - 1e-7,
              f"{what}: gamma leaves the box")
        o_d = float(dual_objective_matfree(g, Xd.double(), spec.kernel))
        o_s = float(dual_objective_matfree(single.model.gamma.double(),
                                           Xd.double(), spec.kernel))
        tol_o = truth_tolerance(precision_of[what], [o_s])
        check(abs(o_d - o_s) <= max(tol_o["atol"], SOLVER_ATOL_FLOOR)
              + tol_o["rtol"] * abs(o_s),
              f"{what}: objective {o_d} vs single-device {o_s}")
        rho_d = np.asarray(rec["rho"])
        rho_s = np.asarray([float(single.model.rho1),
                            float(single.model.rho2)])
        tol_r = truth_tolerance(precision_of[what], rho_s)
        check(np.all(np.abs(rho_d - rho_s)
                     <= max(tol_r["atol"], SOLVER_ATOL_FLOOR)
                     + tol_r["rtol"] * np.abs(rho_s)),
              f"{what}: rho {rho_d} vs single-device {rho_s}")
        i_s = int(single.iters)
        if iters:
            check(abs(rec["iters"] - i_s) <= max(1, 0.1 * i_s),
                  f"{what}: {rec['iters']} iterations vs single-device "
                  f"{i_s}")
        return o_d, o_s, i_s

    precision_of = {}
    dist_fupdate, dist_decision = {}, {}
    for backend, recs in ranks.items():
        world = len(recs)
        for key in recs[0]["fits"]:
            fits_k = [r["fits"][key] for r in recs]
            what = f"[dist] {backend} {key}"
            precision_of[what] = "bf16" if key.endswith("bf16") else "f32"
            check(all(f["iters"] == fits_k[0]["iters"] for f in fits_k),
                  f"{what}: iterations differ across ranks "
                  f"{[f['iters'] for f in fits_k]}")
            check(all(f["gamma"].tobytes() == fits_k[0]["gamma"].tobytes()
                      for f in fits_k),
                  f"{what}: gamma is not bitwise equal across ranks")
            for r, f in enumerate(fits_k):
                check(f["fupdate"]["narrow"] + f["fupdate"]["wide"] > 0,
                      f"{what} rank {r}: no fupdate launch")
                say(f"[dist] {backend} rank {r}/{world} {key}: iters="
                    f"{f['iters']} converged={f['converged']} seconds="
                    f"{f['seconds']:.3f} ms_per_iter={f['ms_per_iter']:.3f}"
                    f" fupdate_launches={f['fupdate']} decision_launches="
                    f"{f['decision']} comm_s_per_iter="
                    f"{f['comm_s_per_iter']:.6f} comm_calls="
                    f"{f['comm_calls']} ledger={json.dumps(f['ledger'])}")
            rec = fits_k[0]
            if key.startswith("main-"):
                p_ = key.split("-")[1]
                o_d, o_s, i_s = held(rec, ref["main"][p_], X_dev, what)
            elif key == "shrink-f32":
                check(rec["routes"] == ["sharded-shrinking"],
                      f"{what}: took {rec['routes']}, not the sharded "
                      f"shrinking driver")
                o_d, o_s, i_s = held(rec, ref["shrink"], Xs_shr, what)
            elif key == "warm-f32":
                st = rec["stats"]
                check(st["mode"] == "warm", f"{what}: {st['mode']} route")
                for r, f in enumerate(fits_k):
                    check(f["fupdate"]["narrow"] == 0
                          and f["fupdate"]["wide"] == f["iters"] + 1,
                          f"{what} rank {r}: {f['fupdate']} fupdate "
                          f"launches, not one wide per iteration plus the "
                          f"reconcile ({f['iters']} iters)")
                o_d, o_s, i_s = held(rec, ref["warm"], Xn_warm, what,
                                     iters=False)
                say(f"[dist] {backend} {key}: stats {json.dumps(st)}")
            else:
                continue
            say(f"[dist] {backend} {key}: objective {o_d:.9f} vs "
                f"single-device {o_s:.9f} (|diff| {abs(o_d - o_s):.3e}); "
                f"iterations {rec['iters']} vs {i_s}; gamma bitwise equal "
                f"on {world} rank(s)")
        # The O(P d) bill: the same per-iteration bytes at m = 8192 and
        # 2048, within tests/test_distributed.py's budget.
        if "ledger-2048" in recs[0]["fits"]:
            b_big = recs[0]["fits"]["main-f32"]["ledger"]["iteration_bytes"]
            b_small = recs[0]["fits"]["ledger-2048"]["ledger"][
                "iteration_bytes"]
            budget = 4 * world * P * (D + 4) * 4 + 256
            check(b_big == b_small and 0 < b_big <= budget,
                  f"[dist] iteration bytes {b_big} (m={M}) / {b_small} "
                  f"(m=2048), budget {budget}")
            say(f"[dist] {backend} ledger: iteration_bytes {b_big} at m={M} "
                f"and m=2048 (budget 4*n*P*(d+4)*4+256 = {budget})")
        # The sharded scorer, bitwise [main]'s single-device scores.
        for r, rec_r in enumerate(recs):
            check(rec_r["score_launches"]["decision"] > 0,
                  f"[dist] {backend} rank {r}: no decision launch")
            check(rec_r["local_bitwise"], f"[dist] {backend} rank {r}: "
                  f"sharded scores are not bitwise its local scorer's")
            for n, s_n in rec_r["scores"].items():
                q = make_toy(SEED + 1 + n, n, d=D)[0]
                check(s_n.shape == (n,) and
                      s_n.tobytes() == sm.score(q).tobytes(),
                      f"[dist] {backend} rank {r}: {n} rows not bitwise "
                      f"[main]'s single-device scores")
            say(f"[dist] {backend} rank {r}: scorer(mesh=) requests "
                f"{list(rec_r['scores'])} -> per-rank buckets "
                f"{list(rec_r['buckets'].values())}, seconds="
                f"{rec_r['score_seconds']:.4f}, launches="
                f"{rec_r['score_launches']}; bitwise [main]'s single-device "
                f"scores")
        dist_fupdate[backend] = {
            f"rank{r}": {k: f["fupdate"] for k, f in rec_r["fits"].items()}
            for r, rec_r in enumerate(recs)}
        dist_decision[backend] = {
            f"rank{r}": rec_r["score_launches"]["decision"]
            for r, rec_r in enumerate(recs)}
        _say_trace("[dist]", f"{backend} rank 0 distributed fit f32 m={M}",
                   recs[0]["trace"])
        say(f"[dist] {backend}: {world} rank(s) on "
            f"{recs[0]['device']}, job seconds={job_s[backend]:.2f}")
    say(f"[dist] phase seconds={time.perf_counter() - phase_t0:.2f}")
    return dist_fupdate, dist_decision


def _served(sm) -> dict:
    """A served model's compacted parts, for rank processes to repack."""
    return {"gamma": sm.model.gamma.cpu().numpy(),
            "X": sm.model.X.cpu().numpy(), "rho1": float(sm.model.rho1),
            "rho2": float(sm.model.rho2), "tn": sm.tn}


def _port_on_path() -> Optional[Path]:
    """The port's ``src/`` beside this file, put on the path, when a card
    is there and the sources are; else None, saying why on stderr."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return None
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {src}",
              file=sys.stderr)
        return None
    sys.path.insert(0, str(src))
    return src


def _say_cards_and_result() -> None:
    """The cards' names and power limits as nvidia-smi gives them, then
    the result line."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        say(line)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def cards_main(cards: int) -> int:
    """``chip_smoke.py --cards N``: [dist] alone over N NCCL ranks, one
    card each — the cross-card path a one-card run cannot reach — held
    against single-device fits of the same rows on the first card (the
    [main], [shrink] and [warm] solves, at their sizes). Prints the [dist]
    lines, the launches as JSON, the cards and the result line."""
    if _port_on_path() is None:
        return 1
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.api import resolve_device
    from repro_torch.core import SlabSpec, rbf
    from repro_torch.core.engine import artifact_from_result
    from repro_torch.data import make_toy
    from repro_torch.kernels import _build
    check(torch.cuda.device_count() >= cards,
          f"--cards {cards}: {torch.cuda.device_count()} card(s) here")
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.build()
    say(f"[build] seconds={time.perf_counter() - t0:.2f}")
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=rbf(RBF_GAMMA))
    X_np = make_toy(SEED, M, d=D)[0]
    fits = {p_: repro_torch.fit(X_np, spec, strategy="auto", P=P, tol=TOL,
                                precision=p_) for p_ in ("f32", "bf16")}
    sm = repro_torch.serve(X_np, spec, offsets="quantile", P=P, tol=TOL)
    X_shr = make_toy(SEED, SHRINK_M, d=D)[0]
    shrink = repro_torch.fit(X_shr, spec, P=P, tol=TOL)
    n_delta = M * 5 // 100
    X_new = np.concatenate([X_np[n_delta:],
                            make_toy(SEED + 7, n_delta, d=D)[0]])
    warm = repro_torch.fit_update(artifact_from_result(fits["f32"]), X_new,
                                  tol=TOL)
    torch.cuda.synchronize()
    jobs = {"nccl": (cards, dict(precisions=("f32", "bf16"), full=True,
                                 requests=DIST_REQUESTS, served=_served(sm),
                                 cards=cards))}
    fup_l, dec_l = _dist_phase(jobs, dict(
        dev=dev, spec=spec, sm=sm, X=X_np, X_shr=X_shr, X_new=X_new,
        main=fits, shrink=shrink, warm=warm))
    say(json.dumps({"dist_launches": {"fupdate": fup_l, "decision": dec_l}}))
    _say_cards_and_result()
    return 0


def main() -> int:
    src = _port_on_path()
    if src is None:
        return 1
    import torch

    import numpy as np
    import repro_torch
    from repro_torch.core import SlabSpec, linear, poly, rbf
    from repro_torch.data import make_toy
    from repro_torch.kernels import _build
    from repro_torch.kernels.decision import ops as dec
    from repro_torch.kernels.decision.ref import decision_plain
    from repro_torch.kernels import autotune, tiling
    from repro_torch.kernels.fupdate import ops as fup
    from repro_torch.kernels.fupdate.ref import fupdate_plain
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram.ref import gram_plain
    from repro_torch.kernels.precision import (PRECISIONS, TOLERANCES,
                                               truth_tolerance)
    from repro_torch.utils.roofline import terms
    from repro_torch.serve import BUCKETS, pack_model
    from repro_torch.api import resolve_device
    from repro_torch.core.ocssvm import OCSSVMModel
    from repro_torch.configs.ocssvm_paper import PAPER_SPEC, TABLE1_SIZES

    dev = resolve_device("cuda")   # also switches TF32 off
    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    say(f"[build] {len(built)} sources in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k}: {v.seconds:.2f} s' for k, v in built.items())})")
    for name, b in built.items():
        for line in b.ptxas:
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"[build] {name}: {line}")
    # The autotuner's feasibility model estimates registers from TR x TC;
    # ptxas says what each instantiation takes.
    regs = {}
    for name, b in built.items():      # the split kernels name no family
        regs.update(autotune.ptxas_registers(b.ptxas, name))
    if regs:            # the sources built here (a reused one prints none)
        n_inst = sum(len(tiling.precisions_of(f, tiling.config_of(e)))
                     for f, menu in tiling.MENUS.items() for e in menu
                     if built[f].ptxas)
        check(len(regs) == n_inst, f"ptxas named {len(regs)} kernel "
              f"instantiations, the menus {n_inst}")
        est = {k: autotune.register_estimate(k[0], tiling.config_of(k[2]))
               for k in regs}
        low = [(k, used, est[k]) for k, used in sorted(regs.items())
               if used > est[k]]
        say(f"[build] registers of {len(regs)} instantiations: "
            f"{min(regs.values())}-{max(regs.values())}; estimate below "
            f"ptxas for {len(low)}: {low}")
    else:
        say("[build] libraries reused: no ptxas lines to check")

    # -- 2. kernels against their plain versions ---------------------------
    # Check data: rbf on the main path's toy rows at its width; linear and
    # poly on the same rows scaled to unit length. On raw toy rows an
    # anomaly's linear or poly value is up to 1e4 times a target row's, and
    # a tolerance scaled by the largest output would not see an error on a
    # target row. Steps, weights and offsets are drawn so that what each
    # kernel adds is O(1) on most rows (see fupdate_operands and
    # support_model), and `hold` fails a cell whose tolerance is more than
    # 1% of the median of that work.
    X_np, _ = make_toy(SEED, M, d=D)
    unit = X_np / np.linalg.norm(X_np, axis=1, keepdims=True)
    rows = {"rbf": X_np, "linear": unit, "poly": unit}
    kernels = {"rbf": rbf(RBF_GAMMA), "linear": linear(),
               "poly": poly(gamma=1.0, coef0=1.0, degree=3)}

    def plain_kw(kind):
        k = kernels[kind]
        return dict(kind=kind, gamma=k.gamma, coef0=k.coef0, degree=k.degree)

    def hold(out, plain, work, what):
        """out against plain at the f32 tolerance of TOLERANCES, atol
        scaled by max |plain| as truth_tolerance scales it (both see the
        same operands, so only the summation order differs), a tolerance
        that must be at most 1% of the median |work|. On the card: the
        full-width gram matrices are 67M values. Returns (max abs err,
        max rel err, tolerance, tolerance / median |work|)."""
        out, plain, work = (a.float() for a in (out, plain, work))
        check(out.shape == plain.shape, f"{what}: shape {tuple(out.shape)}"
              f" against {tuple(plain.shape)}")
        check(bool(torch.isfinite(out).all()),
              f"{what}: non-finite kernel output")
        top = float(plain.abs().max())
        tol = dict(rtol=TOLERANCES["f32"]["rtol"],
                   atol=TOLERANCES["f32"]["atol"] * max(1.0, top))
        share = tol["atol"] / float(work.abs().median())
        check(share <= 1e-2, f"{what}: tolerance {tol} is {share:.3g} of "
              f"the median work of the kernel; the check would be blind")
        diff = (out - plain).abs()
        bad = int((diff > tol["atol"] + tol["rtol"] * plain.abs()).sum())
        err = float(diff.max())
        check(bad == 0, f"{what}: {bad} values outside {tol} "
              f"(max abs err {err:.3e})")
        return err, err / top, tol, share

    def fupdate_operands(kind, m, s, precision):
        """Prepared operands: s of the first m check rows at random, f
        uniform in [-1, 1], and a step scaled so that the largest update
        |k(x, xsel) @ delta| is 1."""
        x = torch.as_tensor(rows[kind][:m], device=dev)
        xsel = x[torch.as_tensor(rng.choice(m, s, replace=False),
                                 device=dev)]
        f = torch.as_tensor(rng.uniform(-1, 1, m).astype(np.float32),
                            device=dev)
        delta = torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                                device=dev)
        ops = fup.prepare(x, xsel, delta, torch.zeros_like(f),
                          precision=precision)
        step = fupdate_plain(*ops, **plain_kw(kind)).abs().max()
        return fup.prepare(x, xsel, delta / step, f, precision=precision)

    worst = {"fupdate": 0.0, "fupdate_wide": 0.0, "fupdate_wide_bf16": 0.0,
             "decision": 0.0, "decision_d768": 0.0, "gram": 0.0,
             "gram_bf16": 0.0}

    def worst_key(family, precision, s=None):
        """gram's f32 (SIMT) and 16-bit (wgmma) classes are two rows, and
        so are fupdate's wide classes (S > 32; bf16 and f16 one row)
        beside its narrow one."""
        if family == "fupdate" and s is not None \
                and s > tiling.FUPDATE_NARROW_MAX_S:
            return "fupdate_wide" + ("" if precision == "f32" else "_bf16")
        return family + ("_bf16" if family == "gram" and precision != "f32"
                         else "")
    for (m, s) in FUPDATE_SHAPES:
        for kind, kern in kernels.items():
            for precision in PRECISIONS:
                ops = fupdate_operands(kind, m, s, precision)
                out = fup.fupdate(*ops[:4], kern, precision=precision,
                                  xn=ops[4])
                torch.cuda.synchronize()
                plain = fupdate_plain(*ops, **plain_kw(kind))
                err, rel, tol, share = hold(
                    out, plain, plain - ops[3],
                    f"fupdate m={m} S={s} {kind} {precision}")
                key = worst_key("fupdate", precision, s)
                worst[key] = max(worst[key], err)
                say(f"[kernels] fupdate m={m} S={s} d={D} {kind:6s} "
                    f"{precision:4s} max_abs={err:.3e} max_rel={rel:.3e} "
                    f"tol={tol} tol/median_update={share:.2e}")

    def check_queries(kind, n, d=D):
        q = make_toy(SEED + n, n, d=d)[0]
        if kind != "rbf":
            q = q / np.linalg.norm(q, axis=1, keepdims=True)
        return torch.as_tensor(q, device=dev)

    def support_model(kind, precision, d=D):
        """A packed model of SUPPORT check rows of d features (rbf at
        gamma = 1/d away from the main width). Its weights are positive,
        as almost all of a fitted model's are, and scaled so that
        |s| <= 1 over the largest bucket's queries; its offsets sit at the
        quartiles of that s. The outputs take both signs, and s is O(1)
        (with weights of both signs, s of the linear kernel gathers near
        0 and its output near -s^2, small beside the tolerance)."""
        kern = kernels[kind] if d == D else rbf(1.0 / d)
        T = torch.as_tensor(rows[kind][:SUPPORT] if d == D
                            else make_toy(SEED, SUPPORT, d=d)[0], device=dev)
        g = torch.as_tensor(np.abs(rng.standard_normal(SUPPORT))
                            .astype(np.float32), device=dev)
        s = kern.cross(check_queries(kind, BUCKETS[-1], d), T) @ g
        g, s = g / s.abs().max(), s / s.abs().max()
        model = OCSSVMModel(gamma=g, rho1=torch.quantile(s, 0.25),
                            rho2=torch.quantile(s, 0.75), X=T,
                            spec=SlabSpec(kernel=kern))
        return pack_model(model, precision=precision, sv_threshold=0.0)

    def decision_operands(kind, sm, bucket, precision):
        q = torch.zeros((bucket, sm.t_pad.shape[1]), device=dev)
        q[:, :sm.d] = check_queries(kind, bucket, sm.d)
        return dec.prepare_packed(q, sm.t_pad, sm.gamma_pad, sm.t_norms,
                                  tm=min(bucket, 256), tn=sm.tn,
                                  precision=precision)

    for kind, kern in kernels.items():
        for precision in PRECISIONS:
            sm = support_model(kind, precision)
            rho1, rho2 = float(sm.model.rho1), float(sm.model.rho2)
            for bucket in BUCKETS:
                ops = decision_operands(kind, sm, bucket, precision)
                out = dec.decision_packed(
                    ops[0], sm.t_pad, sm.gamma_pad, sm.t_norms, rho1, rho2,
                    kern, tm=min(bucket, 256), tn=sm.tn, precision=precision)
                torch.cuda.synchronize()
                plain = decision_plain(*ops, rho1, rho2, **plain_kw(kind))
                # The work: how far s moves the output from its value at 0.
                err, rel, tol, share = hold(
                    out, plain, plain + rho1 * rho2,
                    f"decision bucket={bucket} {kind} {precision}")
                worst["decision"] = max(worst["decision"], err)
                cfg = dec.DECISION.last_config
                check(cfg == tiling.packed_decision_config(bucket,
                                                           precision),
                      f"decision bucket={bucket} {precision} launched {cfg}")
                again = dec.launch(*ops, rho1, rho2, kern, cfg)()
                torch.cuda.synchronize()
                check(torch.equal(out.view(torch.int32),
                                  again.view(torch.int32)),
                      f"decision bucket={bucket} {kind} {precision}: two "
                      f"launches on the same inputs differ")
                say(f"[kernels] decision bucket={bucket} support="
                    f"{sm.t_pad.shape[0]} d={D} {kind:6s} {precision:4s} "
                    f"entry {cfg.entry} max_abs={err:.3e} max_rel={rel:.3e} "
                    f"tol={tol} tol/median_work={share:.2e} "
                    f"relaunch=bitwise")

    def gram_rows(kind, m, d, seed):
        """Toy rows, unit-length for linear and poly (as above)."""
        r = X_np if (m, d, seed) == (M, D, SEED) else make_toy(seed, m,
                                                                d=d)[0]
        if kind != "rbf":
            r = r / np.linalg.norm(r, axis=1, keepdims=True)
        return torch.as_tensor(r, device=dev)

    for (gm, gn, gd) in GRAM_SHAPES:
        for kind, kern in kernels.items():
            x = gram_rows(kind, gm, gd, SEED)
            y = x if gn == gm else gram_rows(kind, gn, gd, SEED + 1)
            for precision in PRECISIONS:
                n0 = gram_ops.GRAM.launches
                out = gram_ops.gram(x, y, kern, precision=precision)
                torch.cuda.synchronize()
                check(gram_ops.GRAM.launches == n0 + 1,
                      "the gram wrapper launched no kernel")
                plain = gram_plain(x, y, precision=precision,
                                   **plain_kw(kind))
                err, rel, tol, share = hold(
                    out, plain, plain,
                    f"gram {gm}x{gn} d={gd} {kind} {precision}")
                key = worst_key("gram", precision)
                worst[key] = max(worst[key], err)
                del out, plain
                say(f"[kernels] gram {gm}x{gn} d={gd} {kind:6s} "
                    f"{precision:4s} max_abs={err:.3e} max_rel={rel:.3e} "
                    f"tol={tol} tol/median_value={share:.2e}")

    def menu_case(family, s, precision):
        """(launch(cfg), plain, work) at the menu check's ragged shape:
        rbf on toy rows, each kernel's work O(1) as above."""
        kern = rbf(1.0 / MENU_D)
        kw = dict(kind="rbf", gamma=kern.gamma)
        a = torch.as_tensor(make_toy(SEED + 2, MENU_ROWS, d=MENU_D)[0],
                            device=dev)
        if family == "gram":
            ops = gram_ops.prepare(a, a[:77], precision=precision)
            plain = gram_plain(ops[0], ops[1], precision=precision, **kw)
            return (lambda c: gram_ops.launch(*ops, kern, c)(), plain,
                    plain)
        if family == "fupdate":
            delta = torch.as_tensor(rng.standard_normal(s)
                                    .astype(np.float32), device=dev)
            f = torch.as_tensor(rng.uniform(-1, 1, MENU_ROWS)
                                .astype(np.float32), device=dev)
            ops = fup.prepare(a, a[:s], delta, torch.zeros_like(f),
                              precision=precision)
            step = fupdate_plain(*ops, **kw).abs().max()
            ops = fup.prepare(a, a[:s], delta / step, f,
                              precision=precision)
            plain = fupdate_plain(*ops, **kw)
            return (lambda c: fup.launch(*ops, kern, c)(), plain,
                    plain - ops[3])
        # Ragged for both classes: 203 support rows (no multiple of
        # SW = 64 or 32), d = 45 (16-bit rows padded to 48 for TMA).
        g = torch.as_tensor(np.abs(rng.standard_normal(MENU_ROWS))
                            .astype(np.float32), device=dev)
        s_ = gram_plain(a[:77], a, precision=precision, **kw) @ g
        g, s_ = g / s_.max(), s_ / s_.max()       # 0 < s <= 1
        r1, r2 = (float(torch.quantile(s_, p)) for p in (0.25, 0.75))
        ops = dec.prepare(a[:77], a, g, precision=precision)
        plain = decision_plain(*ops, r1, r2, **kw)
        return (lambda c: dec.launch(*ops, r1, r2, kern, c)(), plain,
                plain + r1 * r2)

    n_menu = 0
    for family, entries in tiling.MENUS.items():
        for idx, entry in enumerate(entries):
            cfg = tiling.config_of(entry, "explicit")
            for precision in tiling.precisions_of(family, cfg):
                s = None if family != "fupdate" else MENU_S[
                    "narrow" if tiling.kernel_of(family, cfg) in ("tile",
                                                                  "pipe")
                    else "wide"]
                check(cfg in tiling.menu(family, s, precision),
                      f"{family} menu entry {entry} outside its class")
                run, plain, work = menu_case(family, s, precision)
                out = run(cfg)
                base = run(tiling.default_config(family, s, precision))
                torch.cuda.synchronize()
                what = f"{family} menu entry {idx} {entry} {precision}"
                err, _, _, share = hold(out, plain, work, what)
                check(torch.equal(out.view(torch.int32),
                                  base.view(torch.int32)),
                      f"{what}: not bitwise equal to the default entry")
                key = worst_key(family, precision, s)
                worst[key] = max(worst[key], err)
                n_menu += 1
    say(f"[kernels] menus: {n_menu} launches (every entry of every family "
        f"in each precision of its class, {MENU_ROWS} rows, d={MENU_D}, "
        f"rbf): each agrees with its plain version and is bitwise its "
        f"class's default")

    # -- 3. the main path --------------------------------------------------
    # Each path runs with the counts set to 0 just before it and read just
    # after; fupdate's launches also by class (the narrow hot loop,
    # S <= 32; the wide init pass and reconcile, S > 32).
    narrow = {c.entry for c in tiling.menu("fupdate", 2 * P)}

    def reset_counts():
        for kern_ in (fup.FUPDATE, dec.DECISION, gram_ops.GRAM):
            kern_.reset_counts()

    def fupdate_classes():
        by = fup.FUPDATE.by_entry
        n_narrow = sum(n for e, n in by.items() if e in narrow)
        return {"narrow": n_narrow,
                "wide": sum(by.values()) - n_narrow}

    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=kernels["rbf"])
    reset_counts()
    fits = {}
    for precision in ("f32", "bf16"):
        n0 = fup.FUPDATE.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = repro_torch.fit(X_np, spec, strategy="auto", P=P, tol=TOL,
                              precision=precision)
        torch.cuda.synchronize()
        fits[precision] = (res, time.perf_counter() - t0,
                           fup.FUPDATE.launches - n0)
    t0 = time.perf_counter()
    sm = repro_torch.serve(X_np, spec, offsets="quantile", P=P, tol=TOL)
    torch.cuda.synchronize()
    serve_fit_s = time.perf_counter() - t0
    queries = {n: make_toy(SEED + 1 + n, n, d=D)[0] for n in REQUEST_SIZES}
    scores = {n: sm.score(q) for n, q in queries.items()}
    launches = {"fupdate": fup.FUPDATE.launches,
                "decision": dec.DECISION.launches}
    main_classes = fupdate_classes()

    hi, lo = spec.upper(M), spec.lower(M)
    for precision, (res, secs, n_launch) in fits.items():
        g = res.model.gamma.double()
        iters = int(res.iters)
        check(bool(res.converged), f"{precision} fit did not converge")
        check(iters > 0, f"{precision} fit took no iteration")
        check(n_launch >= iters,
              f"{precision} fit: {n_launch} fupdate launches < {iters} iters")
        check(abs(float(g.sum()) - spec.total()) < 1e-4,
              f"{precision} fit: sum(gamma) = {float(g.sum())}")
        check(float(g.max()) <= hi + 1e-7 and float(g.min()) >= lo - 1e-7,
              f"{precision} fit: gamma leaves the box")
        say(f"[main] fit {precision}: m={M} d={D} iters={iters} converged="
            f"{bool(res.converged)} gap={float(res.gap):.3e} "
            f"rho=({float(res.model.rho1):.6f}, {float(res.model.rho2):.6f}) "
            f"sum_gamma={float(g.sum()):.6f} fupdate_launches={n_launch} "
            f"seconds={secs:.3f} ms_per_iter={1e3 * secs / iters:.3f}")
    check(launches["decision"] > 0, "serve launched no decision kernel")
    for n, s in scores.items():
        check(s.shape == (n,) and np.all(np.isfinite(s)),
              f"scores for {n} rows: shape {s.shape}")
        ref = sm.model.decision_function(
            torch.as_tensor(queries[n], device=dev)).cpu().numpy()
        np.testing.assert_allclose(s, ref, **truth_tolerance("f32", ref))
        # On target rows s sits between the offsets and the scores are far
        # smaller than that tolerance, so hold the labels as well: every
        # row whose plain score is more than 1% of the median |score| from
        # 0 gets the plain path's sign.
        sure = np.abs(ref) > 1e-2 * np.median(np.abs(ref))
        flips = int(np.sum(np.sign(s[sure]) != np.sign(ref[sure])))
        check(flips == 0, f"scores for {n} rows: {flips} labels differ "
              f"from the plain decision function")
        say(f"[main] serve score n={n}: max_abs_vs_plain="
            f"{float(np.max(np.abs(s - ref))):.3e} median_abs_score="
            f"{float(np.median(np.abs(ref))):.3e} labels_checked="
            f"{int(sure.sum())}/{n} label_flips={flips}")
    say(f"[main] serve: n_sv={sm.n_sv} packed={tuple(sm.t_pad.shape)} "
        f"fit+pack seconds={serve_fit_s:.3f} launches={launches} "
        f"fupdate_by_class={main_classes}")

    # The kernel path against the plain path end to end, small enough
    # for the CPU: the same solve on the card and on the CPU.
    Xs = X_np[:512]
    on_card = repro_torch.fit(Xs, spec, strategy="pallas", P=P, tol=TOL)
    on_cpu = repro_torch.fit(Xs, spec, strategy="pallas", P=P, tol=TOL,
                             device="cpu")
    for a, b, what in ((on_card.model.rho1, on_cpu.model.rho1, "rho1"),
                       (on_card.model.rho2, on_cpu.model.rho2, "rho2")):
        check(abs(float(a) - float(b)) <= 5e-3,
              f"card vs cpu {what}: {float(a)} vs {float(b)}")
    say(f"[main] m=512 card vs cpu: iters {int(on_card.iters)} vs "
        f"{int(on_cpu.iters)}, rho1 {float(on_card.model.rho1):.6f} vs "
        f"{float(on_cpu.model.rho1):.6f}")

    from repro_torch import api
    from repro_torch.core import (dual_objective, dual_objective_matfree,
                                  mcc, recover_rhos, shrinking, solve_qp)
    from repro_torch.core.engine import (SolverArtifact, artifact_from_result,
                                         make_provider, prepare_warm_start,
                                         raw_scores_blocked)
    path_launches = {"main": main_classes}

    def objective(res, X):
        return float(dual_objective_matfree(res.model.gamma.double(),
                                            X.double(),
                                            res.model.spec.kernel))

    def feasible(res, m, what):
        g = res.model.gamma.double()
        check(abs(float(g.sum()) - spec.total()) < 1e-4,
              f"{what}: sum(gamma) = {float(g.sum())}")
        check(float(g.max()) <= spec.upper(m) + 1e-7
              and float(g.min()) >= spec.lower(m) - 1e-7,
              f"{what}: gamma leaves the box")

    # -- 3b. [shrink]: "auto" above the blocked limit -----------------------
    phase_t0 = time.perf_counter()
    X_shr = make_toy(SEED, SHRINK_M, d=D)[0]
    Xs_dev = torch.as_tensor(X_shr, device=dev)
    routes, rounds = [], []
    api_shrink, inner_solve = api.solve_blocked_shrinking, \
        shrinking.solve_blocked

    def route_spy(*a, **k):
        routes.append("shrinking")
        return api_shrink(*a, **k)

    def round_spy(Xs, sp, **k):
        r = inner_solve(Xs, sp, **k)
        rounds.append((int(Xs.shape[0]), k.get("f_offset") is not None,
                       int(r.iters)))
        return r

    shrink_launches, shrink_fits = {}, {}
    api.solve_blocked_shrinking = route_spy
    shrinking.solve_blocked = round_spy
    try:
        for precision in ("f32", "bf16"):
            routes.clear()
            rounds.clear()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = repro_torch.fit(X_shr, spec, P=P, tol=TOL,
                                  precision=precision)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            classes = fupdate_classes()
            shrink_launches[precision] = dict(classes)
            shrink_fits[precision] = res
            check(routes == ["shrinking"],
                  f"auto at m={SHRINK_M} took {routes}, not shrinking")
            check(bool(res.converged),
                  f"shrinking {precision} did not converge")
            feasible(res, SHRINK_M, f"shrinking {precision}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blk = repro_torch.fit(X_shr, spec, strategy="pallas", P=P,
                                  tol=TOL, precision=precision)
            torch.cuda.synchronize()
            blk_s = time.perf_counter() - t0
            o_s, o_b = objective(res, Xs_dev), objective(blk, Xs_dev)
            tol_o = truth_tolerance(precision, [o_b])
            check(abs(o_s - o_b) <= max(tol_o["atol"], SOLVER_ATOL_FLOOR)
                  + tol_o["rtol"] * abs(o_b),
                  f"shrinking {precision} objective {o_s} vs blocked {o_b}")
            rho_s = np.asarray([float(res.model.rho1),
                                float(res.model.rho2)])
            rho_b = np.asarray([float(blk.model.rho1),
                                float(blk.model.rho2)])
            tol_r = truth_tolerance(precision, rho_b)
            check(np.all(np.abs(rho_s - rho_b)
                         <= max(tol_r["atol"], SOLVER_ATOL_FLOOR)
                         + tol_r["rtol"] * np.abs(rho_b)),
                  f"shrinking {precision} rho {rho_s} vs blocked {rho_b}")
            say(f"[shrink] fit {precision} m={SHRINK_M} d={D} (auto -> "
                f"shrinking): rounds={len(rounds) - 1} solves (rows, "
                f"f_offset, iters)={rounds} iters={int(res.iters)} "
                f"converged={bool(res.converged)} seconds={secs:.3f} "
                f"fupdate_launches={classes} objective={o_s:.9f} "
                f"rho=({rho_s[0]:.6f}, {rho_s[1]:.6f})")
            say(f"[shrink] blocked {precision} m={SHRINK_M} (strategy="
                f"pallas): iters={int(blk.iters)} seconds={blk_s:.3f} "
                f"objective={o_b:.9f} rho=({rho_b[0]:.6f}, "
                f"{rho_b[1]:.6f}); |objective diff|={abs(o_s - o_b):.3e}")
    finally:
        api.solve_blocked_shrinking = api_shrink
        shrinking.solve_blocked = inner_solve
    path_launches["shrink"] = shrink_launches
    del Xs_dev
    say(f"[shrink] phase seconds={time.perf_counter() - phase_t0:.2f}")

    # -- 3c. [paper]: the paper's Table 1 on the card ------------------------
    phase_t0 = time.perf_counter()
    reset_counts()

    def timed(fn):
        """(result, seconds of the second of two calls)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for m in TABLE1_SIZES:
        Xp, yp = make_toy(SEED, m)
        Xp_dev = torch.as_tensor(Xp, device=dev)
        K = PAPER_SPEC.kernel.gram(Xp_dev)
        runs = {
            "paper": lambda: repro_torch.fit(
                Xp, PAPER_SPEC, strategy="paper", gram_mode="precomputed",
                tol=1e-3, max_iters=100_000),
            "mvp": lambda: repro_torch.fit(
                Xp, PAPER_SPEC, strategy="mvp", gram_mode="precomputed",
                tol=1e-3, max_iters=100_000),
            "blocked": lambda: repro_torch.fit(
                Xp, PAPER_SPEC, strategy="blocked", gram_mode="on_the_fly",
                P=16, tol=1e-3, max_outer=50_000),
        }
        row = {}
        for name, fn in runs.items():
            res, secs = timed(fn)
            row[name] = (int(res.iters), secs,
                         float(mcc(yp, res.model.predict(Xp_dev))),
                         float(dual_objective(res.model.gamma, K)))
        if m in TABLE1_SIZES[:QP_SIZES]:
            qp, secs = timed(lambda: solve_qp(Xp_dev, PAPER_SPEC,
                                              max_iters=20_000, tol=1e-9))
            # The QP returns gamma only: its offsets from its own scores.
            r1, r2 = recover_rhos(qp.gamma, K @ qp.gamma, PAPER_SPEC)
            qp_model = OCSSVMModel(gamma=qp.gamma, rho1=r1, rho2=r2,
                                   X=Xp_dev, spec=PAPER_SPEC)
            o_qp = float(qp.objective)
            row["qp"] = (int(qp.iters), secs,
                         float(mcc(yp, qp_model.predict(Xp_dev))), o_qp)
            for name in runs:
                check(row[name][3] <= o_qp + 5e-4 + 0.05 * abs(o_qp),
                      f"m={m} {name}: objective {row[name][3]} above the "
                      f"QP's {o_qp}")
        say(f"[paper] m={m} d=2 " + " ".join(
            f"{k}: iters={it} seconds={sec:.4f} mcc={mc:.4f} "
            f"objective={ob:.6e};" for k, (it, sec, mc, ob) in row.items()))
    path_launches["paper"] = fupdate_classes()
    check(fup.FUPDATE.launches == 0,
          "the paper's route launched fupdate: its selector holds both "
          "columns, as in the JAX package")
    say(f"[paper] phase seconds={time.perf_counter() - phase_t0:.2f} "
        f"(QP at m in {TABLE1_SIZES[:QP_SIZES]}) fupdate_launches="
        f"{path_launches['paper']}")

    # -- 3d. [warm]: a streaming refresh at the main cell's size -------------
    # In f32 and bf16, from the main path's fit of that precision: at the
    # delta-scaled P = 64 every iteration (S = 128) and the reconcile run
    # fupdate's wide classes (the SIMT split tile, the wgmma split kernel).
    phase_t0 = time.perf_counter()
    n_delta = M * 5 // 100        # 5% expiry and 5% append
    X_new = np.concatenate([X_np[n_delta:],
                            make_toy(SEED + 7, n_delta, d=D)[0]])
    Xn_dev = torch.as_tensor(X_new, device=dev)
    warm_launches, warm_shapes, warm_fits = {}, {}, {}
    for precision in ("f32", "bf16"):
        art = artifact_from_result(fits[precision][0], precision=precision)
        reset_counts()
        st = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = repro_torch.fit_update(art, X_new, tol=TOL, stats_out=st)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_classes = fupdate_classes()
        warm_launches[precision] = warm_classes
        warm_fits[precision] = warm
        t0 = time.perf_counter()
        cold = repro_torch.fit(X_new, spec, P=P, tol=TOL,
                               precision=precision)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        what = f"warm {precision}"
        check(st["mode"] == "warm", f"{what}: fit_update took the "
              f"{st['mode']} route")
        iters = int(warm.iters)
        check(sum(warm_classes.values()) == iters + 1,
              f"{what}: {warm_classes} fupdate launches, not one per "
              f"iteration plus the reconcile ({iters} iters)")
        check(warm_classes["narrow"] == 0
              and 2 * st["P"] > tiling.FUPDATE_NARROW_MAX_S,
              f"{what}: {warm_classes} at P = {st['P']}: not all wide")
        check(bool(warm.converged), f"{what}: the fit did not converge")
        feasible(warm, M, what)
        o_w, o_c = objective(warm, Xn_dev), objective(cold, Xn_dev)
        tol_o = truth_tolerance(precision, [o_c])
        check(abs(o_w - o_c) <= tol_o["atol"] + tol_o["rtol"] * abs(o_c),
              f"{what}: objective {o_w} vs cold {o_c}")
        say(f"[warm] fit_update {precision} m={M} d={D}: stats "
            + json.dumps({k: st[k] for k in ("mode", "n_overlap", "n_fresh",
                                             "n_expired", "n_corr", "P")})
            + f" warm iters={iters} seconds={warm_s:.3f} "
            f"fupdate_launches={warm_classes}; cold iters={int(cold.iters)} "
            f"seconds={cold_s:.3f}; objective warm={o_w:.9f} "
            f"cold={o_c:.9f}")
        # The reconcile alone: one wide fupdate on the card against the
        # plain K @ gamma0 of the provider's rows.
        ws, info = prepare_warm_start(art, Xn_dev, spec)
        prov = make_provider("pallas", Xn_dev, spec.kernel,
                             precision=precision)
        f_rec = prov.reconcile_scores(ws)
        cfg = fup.FUPDATE.last_config
        check(cfg.entry not in narrow, f"the reconcile launched {cfg}")
        truth = raw_scores_blocked(prov.X, ws.gamma0, spec.kernel)
        torch.cuda.synchronize()
        err, rel, tol, share = hold(f_rec, truth, truth,
                                    f"{what} reconcile")
        warm_shapes[precision] = (("warm hot loop", 2 * st["P"]),
                                  ("warm reconcile", info.n_corr))
        say(f"[warm] {precision} reconcile S={info.n_corr} entry "
            f"{cfg.entry}: vs raw_scores_blocked max_abs={err:.3e} "
            f"max_rel={rel:.3e} tol={tol} tol/median_f={share:.2e}")
        # The checkpoint: saved, loaded, and warm-started again, bitwise.
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "artifact.npz")
            art.save(path)
            again = repro_torch.fit_update(SolverArtifact.load(path), X_new,
                                           tol=TOL)
        check(torch.equal(warm.model.gamma.view(torch.int32),
                          again.model.gamma.view(torch.int32)),
              f"{what}: fit_update from the loaded artifact is not bitwise "
              f"the warm fit")
        say(f"[warm] {precision} artifact saved, loaded and refit: gamma "
            f"bitwise the warm fit's ({int(again.iters)} iters)")
    path_launches["warm"] = warm_launches
    del Xn_dev
    say(f"[warm] phase seconds={time.perf_counter() - phase_t0:.2f}")

    # -- 3e. [serve-wide]: 16-bit scoring at embedding widths ----------------
    # A bf16 model of BERT-base pooled embeddings' width (d = 768) scored
    # through the scorer at every bucket, and one of d = 2048 at the
    # smallest: the resident query tile caps d at 640-1664 by the entry,
    # so each bucket takes an entry that fits (tiling.wgmma_fits), the
    # streamed one above 1664.
    phase_t0 = time.perf_counter()
    wide_models, serve_wide = {}, {}
    for d_w, buckets in ((WIDE_D, BUCKETS), (WIDEST_D, BUCKETS[:1])):
        smw = support_model("rbf", "bf16", d=d_w)
        wide_models[d_w] = smw
        r1, r2 = float(smw.model.rho1), float(smw.model.rho2)
        kern_w = smw.spec.kernel
        reset_counts()
        outs, cfgs = {}, {}
        for bucket in buckets:
            outs[bucket] = smw.score(check_queries("rbf", bucket, d_w))
            cfgs[bucket] = dec.DECISION.last_config
        torch.cuda.synchronize()
        serve_wide[d_w] = dec.DECISION.launches
        check(serve_wide[d_w] == len(buckets),
              f"d={d_w}: {serve_wide[d_w]} decision launches for "
              f"{len(buckets)} buckets")
        for bucket in buckets:
            out, cfg = outs[bucket], cfgs[bucket]
            ops = decision_operands("rbf", smw, bucket, "bf16")
            check(cfg == tiling.packed_decision_config(
                bucket, "bf16", ops[0].shape[1]),
                f"d={d_w} bucket={bucket} launched {cfg}")
            plain = decision_plain(*ops, r1, r2, kind="rbf",
                                   gamma=kern_w.gamma)
            err, rel, tol, share = hold(out, plain, plain + r1 * r2,
                                        f"serve-wide d={d_w} b={bucket}")
            if d_w == WIDE_D:
                worst["decision_d768"] = max(worst["decision_d768"], err)
            sure = plain.abs() > 1e-2 * plain.abs().median()
            flips = int((torch.sign(out[sure]) != torch.sign(plain[sure]))
                        .sum())
            check(flips == 0, f"serve-wide d={d_w} bucket={bucket}: {flips} "
                  f"labels differ from the plain decision")
            # Every entry of the class that fits d, the streamed one among
            # them, gives bitwise the scorer's values.
            fits_d = [c for c in tiling.menu("decision", precision="bf16")
                      if tiling.wgmma_fits(c, ops[0].shape[1])]
            for c in fits_d:
                other = dec.launch(*ops, r1, r2, kern_w, c)()
                torch.cuda.synchronize()
                check(torch.equal(out.view(torch.int32),
                                  other.view(torch.int32)),
                      f"serve-wide d={d_w} bucket={bucket}: entry {c.entry} "
                      f"is not bitwise {cfg.entry}")
            say(f"[serve-wide] bf16 d={d_w} bucket={bucket} support="
                f"{smw.t_pad.shape[0]} entry {cfg.entry} "
                f"({tiling.kernel_of('decision', cfg)}) max_abs={err:.3e} "
                f"max_rel={rel:.3e} tol/median_work={share:.2e} "
                f"labels_checked={int(sure.sum())}/{bucket} label_flips="
                f"{flips}; bitwise across the {len(fits_d)} entries that "
                f"fit d")
    path_launches["serve-wide"] = {f"d={k}": v for k, v in serve_wide.items()}
    say(f"[serve-wide] phase seconds={time.perf_counter() - phase_t0:.2f} "
        f"decision launches={path_launches['serve-wide']}")

    # -- 3f. [fleet]: the serving control plane -----------------------------
    # Three tenants in one ModelRegistry, fitted on first use; a few hundred
    # requests of REQUEST_SIZES from one asyncio loop through an
    # AdmissionController (per-tenant quotas) and its AsyncDriver on the
    # real clock; a drift-gated warm and cold refresh; the bf16 tenant
    # published to shared memory and scored by a spawned process.
    from repro_torch.serve import (AdmissionController, AsyncDriver,
                                   ModelCache, ModelRegistry,
                                   QuotaExceededError, ScoringService,
                                   ShmKeyError, attach, live_refs, publish,
                                   serve_async)
    phase_t0 = time.perf_counter()
    reset_counts()
    fleet_m = M - n_delta                 # 7783 rows; refresh appends 409
    wide_spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=rbf(1.0 / WIDE_D))
    reg = ModelRegistry(ModelCache())
    # The recipes leave P to the solver, so that fit_update scales it with
    # the delta (P = 64: fupdate's wide classes), as a streaming refresh
    # does.
    reg.register("main-f32", X_np[:fleet_m], spec, quota=FLEET_QUOTA,
                 tol=TOL)
    reg.register("main-bf16", X_np[:fleet_m], spec, quota=FLEET_QUOTA,
                 tol=TOL, precision="bf16")
    reg.register("wide-bf16", make_toy(SEED, SUPPORT, d=WIDE_D)[0],
                 wide_spec, quota=FLEET_QUOTA, tol=TOL, precision="bf16")
    tenants = reg.names()
    width = {"main-f32": D, "main-bf16": D, "wide-bf16": WIDE_D}
    first = {}
    for name in tenants:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first[name] = reg.get(name)
        torch.cuda.synchronize()
        check(first[name].fit_iters > 0, f"{name}: the fit took no "
              f"iteration")
        say(f"[fleet] {name}: fit on first use m={first[name].artifact.m} "
            f"d={first[name].d} iters={first[name].fit_iters} "
            f"n_sv={first[name].n_sv} seconds={time.perf_counter() - t0:.3f}")

    pools = {D: make_toy(SEED + 11, 2 * BUCKETS[-1], d=D)[0],
             WIDE_D: make_toy(SEED + 12, BUCKETS[-1], d=WIDE_D)[0]}
    frng = np.random.default_rng(SEED + 13)

    def request(name, n):
        pool = pools[width[name]]
        off = int(frng.integers(0, pool.shape[0] - n + 1))
        return pool[off:off + n]

    # BucketStats keeps launches, rows and summed seconds; the seconds of
    # each warm launch (a bucket's first on a scorer is cold, as in its
    # mean) are kept here as well, for percentiles: the record of each
    # BucketStats the tenants' services file a launch under is wrapped
    # (the instance's, not the class's). A rebuilt service carries its
    # predecessor's BucketStats over.
    lat = {}

    def timed(bs):
        if id(bs) not in lat:
            lat[id(bs)] = []
            rec = bs.record

            def record(queries, requests, dt, cold=False):
                if not cold:
                    lat[id(bs)].append(dt)
                return rec(queries, requests, dt, cold)
            bs.record = record
        return bs

    class TimedStats(dict):
        def setdefault(self, bucket, default=None):
            return timed(super().setdefault(bucket, default))

    def watch(svc):
        svc.stats = TimedStats({b: timed(s) for b, s in svc.stats.items()})

    ctrl = AdmissionController(reg, max_batch=FLEET_MAX_BATCH)
    for name in tenants:
        watch(ctrl.service(name))
    fleet_out = []       # (tenant, model it must score like, rows, scores)
    refreshes = {}

    async def wave(items, models):
        outs = await asyncio.gather(*(
            serve_async(name, q, controller=ctrl,
                        deadline=time.monotonic() + FLEET_DEADLINE_S)
            for name, q in items))
        fleet_out.extend((name, models[name], q, out)
                      for (name, q), out in zip(items, outs))

    async def drive():
        for _ in range(FLEET_WAVES):
            # At most FLEET_PER_WAVE requests a tenant a wave, each wave
            # awaited: a window holds at most 3 requests (<= 7096 rows)
            # when a 4th arrives, so no traffic request passes the quota.
            items = [(name, request(name, int(frng.choice(REQUEST_SIZES))))
                     for name in tenants for _ in range(FLEET_PER_WAVE)]
            frng.shuffle(items)
            await wave(items, first)
        # One group that spans buckets (4096 + 1000 rows) and one request
        # over its tenant's quota (3000 rows onto 5096 queued).
        far = time.monotonic() + 3600
        held = [request("main-bf16", n) for n in (4096, 1000)]
        handles = [ctrl.submit("main-bf16", q, deadline=far) for q in held]
        try:
            ctrl.submit("main-bf16", request("main-bf16", 3000),
                        deadline=far)
            rejected = None
        except QuotaExceededError as e:
            rejected = e
        groups0 = ctrl.service("main-bf16").flush_groups
        span = ctrl.flush_model("main-bf16")
        check(span == 2 and ctrl.service("main-bf16").flush_groups
              == groups0 + 1, f"the 5096-row group took {span} launches")
        fleet_out.extend(("main-bf16", first["main-bf16"], q, h.result())
                      for q, h in zip(held, handles))
        # The drift-gated refresh: the 409 remaining rows route warm and
        # land at the [main] shape; the same rows shifted by 5 route cold.
        for label, app in (("warm", X_np[fleet_m:]),
                           ("cold", X_np[fleet_m:] + 5.0)):
            v0 = reg.version("main-f32")
            by0 = dict(fup.FUPDATE.by_entry)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sm_r = reg.refresh("main-f32", append=app)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            by = {e: n - by0.get(e, 0)
                  for e, n in fup.FUPDATE.by_entry.items()}
            n_nar = sum(n for e, n in by.items() if e in narrow)
            refreshes[label] = (sm_r, secs, reg.refresh_stats("main-f32"),
                                {"narrow": n_nar,
                                 "wide": sum(by.values()) - n_nar},
                                reg.version("main-f32") - v0)
        # Traffic after the refresh scores against the new model.
        watch(ctrl.service("main-f32"))
        await wave([("main-f32", request("main-f32", n))
                    for n in (64, 1000, 4096)],
                   {"main-f32": reg.get("main-f32")})
        return rejected, span

    with AsyncDriver(ctrl) as driver:
        t0 = time.perf_counter()
        rejected, span = asyncio.run(drive())
        drive_s = time.perf_counter() - t0
    check(not driver.alive and driver.crashed is None,
          f"the driver did not stop cleanly: {driver.crashed!r}")
    check(rejected is not None and rejected.queued_rows == 5096
          and sum(s["rejected"] for s in ctrl.stats_dict().values()) == 1,
          f"quota: {rejected!r}, {ctrl.stats_dict()}")
    sm_new = reg.get("main-f32")
    check(ctrl.service("main-f32").scorer.model is sm_new,
          "the controller still serves the replaced main-f32 model")
    for label, (sm_r, _, st, cls_, bumped) in refreshes.items():
        drift = st["last_drift"]
        check(drift is not None and drift.drifted == (label == "cold")
              and st["modes"] == {"warm": 1, "cold": int(label == "cold")}
              and bumped == 1,
              f"{label} refresh: {st['modes']} drift {drift} version +"
              f"{bumped}")
    sm_w, _, st_w, cls_w, _ = refreshes["warm"]
    check(st_w["last_warm"]["mode"] == "warm" and sm_w.artifact.m == M,
          f"warm refresh: {st_w['last_warm']} m={sm_w.artifact.m}")
    check(cls_w["narrow"] == 0 and cls_w["wide"] > 0,
          f"warm refresh fupdate launches {cls_w}: not all wide")

    # Shared memory: main-bf16 published; a spawned process on the card
    # attaches it and scores 1024 rows.
    sm_pub = first["main-bf16"]
    with tempfile.TemporaryDirectory() as spool:
        key = f"{spool}/main-bf16"    # /dev/shm is the host's: our own key
        lease = publish(sm_pub, key, dir=spool)
        out_npy = str(Path(spool) / "child_scores.npy")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", FLEET_CHILD, str(src), key, spool,
             str(SEED + 14), out_npy], capture_output=True, text=True,
            timeout=600)
        child_s = time.perf_counter() - t0
        check(child.returncode == 0,
              f"the attaching process failed: {child.stderr[-2000:]}")
        got = json.loads(child.stdout.strip().splitlines()[-1])
        refs_after = live_refs(key, dir=spool)
        child_scores = np.load(out_npy)
        lease.close()
        try:
            attach(key, dir=spool)
            unlinked = False
        except ShmKeyError:
            unlinked = True
    check(got["live_refs"] == 2 and refs_after == 1 and unlinked,
          f"shm leases {got['live_refs']} -> {refs_after}, unlinked "
          f"{unlinked}")
    check(got["device"].startswith("cuda"), f"attached on {got['device']}")
    fleet_launches = {"fupdate": fupdate_classes(),
                      "decision": dec.DECISION.launches}
    path_launches["fleet"] = fleet_launches

    # The checks (their launches are not the path's). Each result against
    # the direct score of the model that served it, for the same rows:
    # bitwise at d <= 640, where every decision entry of a class adds each
    # sum in one order; at d = 768 within TOLERANCES (PERF.md [fleet]).
    q_shm = make_toy(SEED + 14, 1024, d=D)[0]
    check(sm_pub.score(q_shm).tobytes() == child_scores.tobytes(),
          "the attached model's scores are not bitwise the publisher's")
    n_bitwise, worst_wide = 0, 0.0
    for name, sm_ref, q, out in fleet_out:
        ref = sm_ref.score(q)
        check(out.shape == ref.shape and bool(np.all(np.isfinite(out))),
              f"{name}: scores {out.shape} for {len(q)} rows")
        same = out.tobytes() == ref.tobytes()
        n_bitwise += same
        if width[name] <= 640:
            check(same, f"{name}: {len(q)} rows not bitwise the direct "
                  f"score (max diff {np.max(np.abs(out - ref)):.3e})")
        else:
            np.testing.assert_allclose(out, ref,
                                       **truth_tolerance("f32", ref))
            worst_wide = max(worst_wide, float(np.max(np.abs(out - ref))))
    last = fleet_out[-1]
    check(first["main-f32"].score(last[2]).tobytes() != last[3].tobytes(),
          "traffic after the refresh scored like the replaced model")
    n_traffic = FLEET_WAVES * FLEET_PER_WAVE * len(tenants)
    say(f"[fleet] traffic: {n_traffic} requests in {FLEET_WAVES} waves, "
        f"then 2 held + 1 rejected + 3 after the refresh; the whole drive "
        f"(refreshes included) seconds={drive_s:.3f}; {n_bitwise} of "
        f"{len(fleet_out)} results bitwise the direct score (wide-bf16 "
        f"max_abs={worst_wide:.3e}); quota rejection: {rejected}; 4096 + "
        f"1000 rows flushed as one group in {span} launches")
    for name, st_ in ctrl.stats_dict().items():
        w = st_["windows"]
        say(f"[fleet] {name}: windows flushed={w['flushed']} opened="
            f"{w['opened']} inline={w['inline_flushes']} mean_fill_rows="
            f"{w['flushed_rows'] / max(1, w['flushed']):.1f} rejected="
            f"{st_['rejected']}")
        svc = ctrl.service(name)
        for b in sorted(svc.stats):
            bs = svc.stats[b]
            xs = sorted(lat.get(id(bs), []))
            warm = (f"warm={len(xs)} p50_ms={1e3 * xs[len(xs) // 2]:.4f} "
                    f"p99_ms="
                    f"{1e3 * xs[min(len(xs) - 1, int(0.99 * len(xs)))]:.4f}"
                    if xs else "warm none")
            say(f"[fleet] {name} bucket={b}: launches={bs.batches} rows="
                f"{bs.queries} requests={bs.requests} cold="
                f"{bs.cold_batches} (cold_ms={1e3 * bs.cold_s:.4f}) {warm} "
                f"mean_ms={1e3 * bs.mean_latency_s:.4f}")
    # Each refresh's objective against a cold fit of the same rows: the
    # [main] f32 fit (X_np) for the warm one; for the cold one (8601 rows,
    # which the refresh fitted with the shrinking driver) the blocked solve.
    blk = repro_torch.fit(np.concatenate([X_np, X_np[fleet_m:] + 5.0]), spec,
                          strategy="pallas", tol=TOL)
    for label, (sm_r, secs, st, cls_, _) in refreshes.items():
        art = sm_r.artifact
        Xd = torch.as_tensor(art.X, device=dev)
        o_r = float(dual_objective_matfree(
            torch.as_tensor(art.gamma, device=dev).double(), Xd.double(),
            spec.kernel))
        cold_fit = fits["f32"][0] if label == "warm" else blk
        o_c = objective(cold_fit, Xd)
        tol_o = truth_tolerance("f32", [o_c])
        check(abs(o_r - o_c) <= tol_o["atol"] + tol_o["rtol"] * abs(o_c),
              f"{label} refresh objective {o_r} vs cold {o_c}")
        drift = st["last_drift"]
        say(f"[fleet] refresh {label}: m={art.m} drift_ks="
            f"{drift.statistic:.4f} (threshold {drift.threshold}) iters="
            f"{sm_r.fit_iters} seconds={secs:.3f} fupdate_launches={cls_} "
            f"objective={o_r:.9f}; cold fit of the same rows: iters="
            f"{int(cold_fit.iters)} objective={o_c:.9f}")
    say(f"[fleet] shm: main-bf16 published ({sm_pub.n_sv} support rows); a "
        f"spawned process made the card's context in "
        f"{got['context_s']:.4f} s, then attached it in "
        f"{got['attach_s']:.4f} s on {got['device']} (the process: "
        f"{child_s:.2f} s) and scored 1024 rows bitwise the publisher's; "
        f"leases 2 -> {refs_after}, then unlinked")
    # Per bucket on the replaced main-f32 model, one thread, nothing else
    # running: the scorer's direct latency; a ScoringService's launch
    # latency (its BucketStats) and its whole submit + flush (host clock,
    # numpy in and out). Beside the traffic's launch latency above.
    sc = first["main-f32"].scorer()
    quiet = ScoringService(sc)
    for b in BUCKETS:
        q_b = pools[D][:b]
        direct, launch, whole = [], [], []
        for _ in range(20):
            t0 = time.perf_counter()
            sc.score(q_b)
            direct.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            quiet.submit(q_b)
            quiet.flush()
            whole.append(time.perf_counter() - t0)
            launch.append(quiet.stats[b].last_s)
        for xs in (direct, launch, whole):
            xs.sort()
        say(f"[fleet] main-f32 bucket={b} alone: scorer direct p50_ms="
            f"{1e3 * direct[10]:.4f} min_ms={1e3 * direct[0]:.4f}; service "
            f"launch p50_ms={1e3 * launch[10]:.4f}, submit+flush p50_ms="
            f"{1e3 * whole[10]:.4f}")
    say(f"[fleet] phase seconds={time.perf_counter() - phase_t0:.2f} "
        f"launches={fleet_launches}")

    # -- 3g. [dist]: the row-sharded solver and the sharded scorer ---------
    # Rank processes spawned on the one card: two gloo ranks (NCCL refuses
    # two ranks on one card), then one NCCL rank (world size 1). They load
    # the libraries built in phase 1. Each rank sets its counts to 0 just
    # before each drive and reads them just after.
    served = _served(sm)
    jobs = {"gloo": (2, dict(precisions=("f32", "bf16"), full=True,
                             requests=DIST_REQUESTS, served=served, cards=1)),
            "nccl": (1, dict(precisions=("f32",), full=False,
                             requests=DIST_REQUESTS[:1], served=served,
                             cards=1))}
    path_launches["dist"], dist_decision = _dist_phase(jobs, dict(
        dev=dev, spec=spec, sm=sm, X=X_np, X_shr=X_shr, X_new=X_new,
        main={p_: f[0] for p_, f in fits.items()}, shrink=shrink_fits["f32"],
        warm=warm_fits["f32"]))

    # -- 4. the autotune path ----------------------------------------------
    for kern_ in (fup.FUPDATE, dec.DECISION, gram_ops.GRAM):
        kern_.launches = 0
    cells = autotune.QUICK_CELLS + tuple(
        c for c in autotune.MAIN_CELLS if c.family in ("fupdate", "gram"))
    t0 = time.perf_counter()
    swept = autotune.sweep(cells, precisions=("f32",), repeats=3)
    gram_f32_launches = gram_ops.GRAM.launches      # the SIMT class's
    swept16 = autotune.sweep(cells, precisions=("bf16",), repeats=3)
    sweep_s = time.perf_counter() - t0
    tune_launches = {"fupdate": fup.FUPDATE.launches,
                     "decision": dec.DECISION.launches,
                     "gram": gram_f32_launches,
                     "gram_bf16": gram_ops.GRAM.launches - gram_f32_launches}
    for w in swept["winners"] + swept16["winners"]:
        say(f"[autotune] winner {w['family']} m={w['m']} n={w['n']} "
            f"d={w['d']} {w['precision']}: (BM, BN, BK, TR, TC, DEPTH)="
            f"{tiling.row_config(w).entry}"
            f" best_us={1e6 * w['best_s']:.3f} {w['bound']}-bound")
    n_cand = len(swept["candidates"]) + len(swept16["candidates"])
    say(f"[autotune] quick sweep: {n_cand} candidates, "
        f"{len(swept['winners']) + len(swept16['winners'])} cells, "
        f"seconds={sweep_s:.2f}, launches={tune_launches}")
    for family in tune_launches:
        check(tune_launches[family] > 0, f"the sweep launched no {family}")
    entries = autotune.winners_to_entries(swept) \
        + autotune.winners_to_entries(swept16)
    tiling.validate_table({"entries": entries})   # valid table rows

    # The committed table against none: the fit's launches differ only in
    # rows per CTA, so the fits must be bitwise equal.
    tuned_fits = {}
    for label, table in (("committed", None), ("empty", {"entries": []})):
        tiling.set_tuned_table(table)
        fup.FUPDATE.last_config = None
        res = repro_torch.fit(X_np, spec, strategy="auto", P=P, tol=TOL)
        cfg = fup.FUPDATE.last_config
        tuned_fits[label] = res
        say(f"[autotune] fit f32 m={M} table={label}: fupdate (BM, BN, BK,"
            f" TR, TC, DEPTH)={cfg.entry} source={cfg.source} "
            f"iters={int(res.iters)} "
            f"rho=({float(res.model.rho1):.9f}, "
            f"{float(res.model.rho2):.9f})")
        if label == "committed":
            check(cfg.source in ("table-exact", "table-nearest"),
                  f"the fit's fupdate did not launch from the table: "
                  f"{cfg}")
        else:
            check(cfg.source == "default", f"empty table launched {cfg}")
    tiling.set_tuned_table(None)
    a, b = tuned_fits["committed"], tuned_fits["empty"]
    check(torch.equal(a.model.gamma.view(torch.int32),
                      b.model.gamma.view(torch.int32))
          and float(a.model.rho1) == float(b.model.rho1)
          and float(a.model.rho2) == float(b.model.rho2)
          and int(a.iters) == int(b.iters),
          "the fit with the committed table is not bitwise the fit with "
          "an empty table")
    say("[autotune] the fit with the committed table is bitwise the fit "
        "with an empty table (gamma, rho1, rho2, iters)")

    # -- 5. timing ----------------------------------------------------------
    time_ms = autotune.graph_ms    # device ms of one call, graph-replayed

    def bound(nbytes, flops, precision):
        t = terms(flops, nbytes, 0.0, 1, precision)
        return (1e3 * t.step_time_s,
                "bytes" if t.memory_s >= t.compute_s else "operations")

    # A kernel's time is that of its launch on prepared operands
    # (fup.launch, dec.launch), built on the stream that captures it; the
    # wrapper's casts and norms are not the kernel's work.
    timed = {}
    for (m, s) in FUPDATE_SHAPES:
        for precision in PRECISIONS:
            ops = fupdate_operands("rbf", m, s, precision)
            cfg = fup.tiles(ops[0], s)
            ms = time_ms(lambda: fup.launch(*ops, kernels["rbf"])())
            plain_ms = time_ms(lambda: fupdate_plain(*ops, **plain_kw("rbf")))
            es = ops[0].element_size()
            nbytes = (m + s) * D * es + 4 * (3 * m + 2 * s)
            flops = 2 * m * s * D + 2 * m * s
            b_ms, b_by = bound(nbytes, flops, precision)
            timed[("fupdate", m, s, precision)] = (ms, plain_ms, b_ms, b_by)
            say(f"[timing] fupdate m={m} S={s} d={D} rbf {precision:4s} "
                f"config {cfg.entry} ({cfg.source}) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b_ms:.5f} ({b_by}) "
                f"bound_share={b_ms / ms:.3f}")
    # fupdate's wide classes at the warm path's shapes, as it ran in each
    # precision: its hot loop at the delta-scaled P and its reconcile,
    # held against the plain version first (the init pass, m = S = 2048,
    # is timed above).
    for precision, shapes in warm_shapes.items():
        for what, s_w in shapes:
            ops = fupdate_operands("rbf", M, s_w, precision)
            out = fup.launch(*ops, kernels["rbf"])()
            plain = fupdate_plain(*ops, **plain_kw("rbf"))
            err, _, _, share = hold(out, plain, plain - ops[3],
                                    f"fupdate {what} S={s_w} {precision}")
            key = worst_key("fupdate", precision, s_w)
            worst[key] = max(worst[key], err)
            cfg = fup.tiles(ops[0], s_w)
            ms = time_ms(lambda: fup.launch(*ops, kernels["rbf"])())
            plain_ms = time_ms(lambda: fupdate_plain(*ops,
                                                     **plain_kw("rbf")))
            es = ops[0].element_size()
            b_ms, b_by = bound((M + s_w) * D * es + 4 * (3 * M + 2 * s_w),
                               2 * M * s_w * D + 2 * M * s_w, precision)
            timed[("fupdate", M, s_w, precision)] = (ms, plain_ms, b_ms,
                                                     b_by)
            say(f"[timing] fupdate {what} m={M} S={s_w} d={D} rbf "
                f"{precision:4s} config {cfg.entry} ({cfg.source}) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b_ms:.5f} ({b_by}) bound_share={b_ms / ms:.3f} "
                f"max_abs={err:.3e} tol/median_update={share:.2e}")
    # decision: against SUPPORT check rows and against the served model
    # (the f32 fit's support rows, packed in each precision), at every
    # bucket, with the entry the bucket picks, as the scorer launches it.
    served = {p: sm if p == "f32" else pack_model(sm.model, precision=p)
              for p in PRECISIONS}
    n_dec, n_dec_faster = 0, 0
    for precision in PRECISIONS:
        for smp in (support_model("rbf", precision), served[precision]):
            rho1, rho2 = float(smp.model.rho1), float(smp.model.rho2)
            for bucket in BUCKETS:
                ops = decision_operands("rbf", smp, bucket, precision)
                cfg = tiling.packed_decision_config(bucket, precision)
                ms = time_ms(lambda: dec.launch(*ops, rho1, rho2,
                                                kernels["rbf"], cfg)(),
                             iters=30)
                plain_ms = time_ms(lambda: decision_plain(
                    *ops, rho1, rho2, **plain_kw("rbf")), iters=30)
                es = ops[0].element_size()
                nt, dp = ops[1].shape
                nbytes = (bucket + nt) * dp * es + 4 * (2 * nt + 2 * bucket)
                flops = 2 * bucket * nt * dp + 2 * bucket * nt
                b_ms, b_by = bound(nbytes, flops, precision)
                exp_ms = 1e3 * bucket * nt / SFU_EXPS_PER_S
                timed[("decision", bucket, nt, precision)] = (
                    ms, plain_ms, b_ms, b_by)
                n_dec += 1
                n_dec_faster += ms <= plain_ms
                say(f"[timing] decision bucket={bucket} support={nt} "
                    f"(n_sv={smp.n_sv}) d={dp} rbf {precision:4s} config "
                    f"{cfg.entry} ({cfg.source}) kernel_ms={ms:.4f} "
                    f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
                    f"exp_floor_ms={exp_ms:.5f} bound_share={b_ms / ms:.3f}")
    say(f"[timing] decision no slower than its plain version in "
        f"{n_dec_faster} of {n_dec} (bucket, support, precision) cells")
    # What the kernel value costs: the same launches with the linear
    # kernel (no exp, one FMA a pair) beside rbf.
    for precision in ("f32", "bf16"):
        ops = decision_operands("rbf", support_model("rbf", precision),
                                BUCKETS[-1], precision)
        cfg = tiling.packed_decision_config(BUCKETS[-1], precision)
        pace = {k: time_ms(lambda: dec.launch(*ops, 0.0, 1.0, kernels[k],
                                              cfg)(), iters=30)
                for k in ("rbf", "linear")}
        say(f"[timing] decision bucket={BUCKETS[-1]} support={SUPPORT} "
            f"{precision} by kernel: rbf kernel_ms={pace['rbf']:.4f} linear "
            f"kernel_ms={pace['linear']:.4f}")
    # 16-bit decision at the embedding widths of [serve-wide], with the
    # entry the bucket and d pick, and at d = WIDE_D the streamed entry
    # beside it (what streaming the query tile costs where both fit).
    for d_w, bucket in ((WIDE_D, BUCKETS[0]), (WIDE_D, BUCKETS[-1]),
                        (WIDEST_D, BUCKETS[0]), (WIDEST_D, BUCKETS[-1])):
        smw = wide_models[d_w]
        r1, r2 = float(smw.model.rho1), float(smw.model.rho2)
        ops = decision_operands("rbf", smw, bucket, "bf16")
        nt, dp = ops[1].shape
        cfg = tiling.packed_decision_config(bucket, "bf16", dp)
        kern_w = smw.spec.kernel
        ms = time_ms(lambda: dec.launch(*ops, r1, r2, kern_w, cfg)(),
                     iters=20)
        plain_ms = time_ms(lambda: decision_plain(
            *ops, r1, r2, kind="rbf", gamma=kern_w.gamma), iters=20)
        b_ms, b_by = bound((bucket + nt) * dp * 2 + 4 * (2 * nt + 2 * bucket),
                           2 * bucket * nt * dp + 2 * bucket * nt, "bf16")
        timed[("decision", bucket, nt, "bf16", d_w)] = (ms, plain_ms, b_ms,
                                                        b_by)
        streamed = ""
        if tiling.kernel_of("decision", cfg) != "stream":
            sc = next(c for c in tiling.menu("decision", precision="bf16")
                      if tiling.kernel_of("decision", c) == "stream")
            sc_ms = time_ms(lambda: dec.launch(*ops, r1, r2, kern_w, sc)(),
                            iters=20)
            streamed = f" streamed entry {sc.entry} kernel_ms={sc_ms:.4f}"
        say(f"[timing] decision bf16 d={d_w} (padded {dp}) bucket={bucket} "
            f"support={nt} config {cfg.entry} "
            f"({tiling.kernel_of('decision', cfg)}) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
            f"bound_share={b_ms / ms:.3f}{streamed}")

    # fupdate on the hot loop at the default config too (the table's
    # is timed above: the default is the one-stage tile, the table's the
    # pipelined entry the sweep chose), and on one CTA (m = 64: what a
    # launch costs in a graph beyond its work).
    for precision in ("f32", "bf16"):
        ops = fupdate_operands("rbf", M, 2 * P, precision)
        f_default_ms = time_ms(lambda: fup.launch(
            *ops, kernels["rbf"], tiling.default_config("fupdate", 2 * P))())
        f_cfg = fup.tiles(ops[0], 2 * P)
        one = fupdate_operands("rbf", 64, 2 * P, precision)
        f_one_ms = time_ms(lambda: fup.launch(
            *one, kernels["rbf"], f_cfg)())
        es = one[0].element_size()
        one_b_ms, one_b_by = bound((64 + 2 * P) * D * es
                                   + 4 * (3 * 64 + 2 * 2 * P),
                                   2 * 64 * 2 * P * D + 2 * 64 * 2 * P,
                                   precision)
        say(f"[timing] fupdate m={M} S={2 * P} d={D} rbf {precision} table "
            f"config {f_cfg.entry} ({f_cfg.source}) kernel_ms="
            f"{timed[('fupdate', M, 2 * P, precision)][0]:.4f}; default "
            f"config {tiling.default_config('fupdate', 2 * P).entry} "
            f"kernel_ms={f_default_ms:.4f}; one CTA (m=64) kernel_ms="
            f"{f_one_ms:.4f} bound_ms={one_b_ms:.6f} ({one_b_by})")
    # gram at full width, with its library call.
    for kind, precision in GRAM_TIMED:
        x = torch.as_tensor(rows[kind], device=dev)
        ops = gram_ops.prepare(x, x, precision=precision)
        kern = kernels[kind]
        cfg = gram_ops.tiles(ops[0], ops[1])
        dflt = tiling.default_config("gram", precision=precision)
        ms = time_ms(lambda: gram_ops.launch(*ops, kern)(), iters=20)
        default_ms = time_ms(lambda: gram_ops.launch(*ops, kern, dflt)(),
                             iters=20)
        plain_ms = time_ms(lambda: gram_plain(
            ops[0], ops[1], precision=precision, **plain_kw(kind)), iters=10)
        lib_ms, lib = None, "none (no one PyTorch call computes it)"
        if kind == "linear" and precision == "f32":
            lib_ms = time_ms(lambda: ops[0] @ ops[1].T, iters=20)
            lib = "x @ y.T (TF32 off)"
        elif kind == "linear":
            try:    # 16-bit operands, f32 output: one cuBLAS call, if any
                torch.mm(ops[0], ops[1].T, out_dtype=torch.float32)
                lib_ms = time_ms(lambda: torch.mm(
                    ops[0], ops[1].T, out_dtype=torch.float32), iters=20)
                lib = "torch.mm(x, y.T, out_dtype=float32)"
            except (TypeError, RuntimeError) as e:
                lib = f"none (torch.mm out_dtype: {type(e).__name__})"
        es = ops[0].element_size()
        nbytes = 2 * M * D * es + 2 * M * 4 + M * M * 4
        b_ms, b_by = bound(nbytes, 2.0 * M * M * D, precision)
        timed[("gram", kind, precision)] = (ms, plain_ms, b_ms, b_by, lib_ms)
        say(f"[timing] gram {M}x{M} d={D} {kind} {precision:4s} config "
            f"{cfg.entry} ({cfg.source}) kernel_ms={ms:.4f} default_config "
            f"{dflt.entry} ms={default_ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) bound_share={b_ms / ms:.3f} "
            f"library_ms={'none' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"[{lib}]")
        del ops
    # What sets the wgmma kernel's pace: the same output (M x M f32) from
    # d features. Were the inputs (loads, wgmma) its bound, its time would
    # grow with d; the output's bytes do not.
    pace = []
    for gd in GRAM_PACE_D:
        rows_d = torch.randn(M, gd, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(SEED))
        ops = gram_ops.prepare(rows_d, rows_d, precision="bf16")
        pace.append((gd, time_ms(lambda: gram_ops.launch(
            *ops, kernels["linear"])(), iters=20)))
        del ops
    say("[timing] gram bf16 linear at a fixed output, by feature width: "
        + ", ".join(f"d={gd} kernel_ms={ms:.4f}" for gd, ms in pace)
        + f" (output {M * M * 4 / 1e6:.0f} MB at "
        + ", ".join(f"{M * M * 4 / ms / 1e9:.3f}" for _, ms in pace)
        + " TB/s)")
    fill_out = torch.empty((M, M), device=dev)
    fill_ms = time_ms(lambda: fill_out.fill_(1.0), iters=20)
    say(f"[timing] the card's write rate: fill_ of the {M}x{M} f32 output "
        f"ms={fill_ms:.4f} ({M * M * 4 / fill_ms / 1e9:.3f} TB/s)")
    del fill_out

    scorer = sm.scorer()
    scorer.warmup()
    for bucket in BUCKETS:
        q = queries[REQUEST_SIZES[-1]][:bucket]
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            scorer.score(q)
            lat.append(time.perf_counter() - t0)
        lat.sort()
        p50 = 1e3 * lat[len(lat) // 2]
        # The host's share: what the request costs beyond the kernel's
        # device time at its bucket (query pad, copies, q norms, launch).
        k_ms = timed[("decision", bucket, sm.t_pad.shape[0], "f32")][0]
        say(f"[timing] serve score bucket={bucket} (numpy in/out, n_sv="
            f"{sm.n_sv}) p50_ms={p50:.4f} min_ms={1e3 * lat[0]:.4f} "
            f"kernel_ms={k_ms:.4f} host_ms={p50 - k_ms:.4f} "
            f"host_share={(p50 - k_ms) / p50:.3f}")
    say(f"[timing] max_memory_allocated="
        f"{torch.cuda.max_memory_allocated()} bytes")

    # -- 6. where a fit's time goes: a profiler window over one solve ------
    tr = _traced(lambda: repro_torch.fit(X_np, spec, strategy="auto", P=P,
                                         tol=TOL, max_outer=PROFILE_ITERS))
    _say_trace("[trace]", f"fit f32 m={M}", tr)

    f_ms, f_plain, f_b, f_by = timed[("fupdate", M, 2 * P, "f32")]
    w_s = warm_shapes["f32"][0][1]
    w_ms, w_plain, w_b, w_by = timed[("fupdate", M, w_s, "f32")]
    w16_s = warm_shapes["bf16"][0][1]
    v_ms, v_plain, v_b, v_by = timed[("fupdate", M, w16_s, "bf16")]
    e_nt = wide_models[WIDE_D].t_pad.shape[0]
    e_ms, e_plain, e_b, e_by = timed[("decision", BUCKETS[-1], e_nt, "bf16",
                                      WIDE_D)]
    d_ms, d_plain, d_b, d_by = timed[("decision", BUCKETS[-1], SUPPORT,
                                      "f32")]
    g_ms, g_plain, g_b, g_by, g_lib = timed[("gram", "linear", "f32")]
    h_ms, h_plain, h_b, h_by, h_lib = timed[("gram", "linear", "bf16")]
    say(json.dumps({"kernels": [
        {"name": "fupdate", "route": "cuda",
         "source": "src/repro_torch/csrc/fupdate.cu",
         "replaces": "src/repro/kernels/fupdate/kernel.py:30",
         "launches": launches["fupdate"], "max_abs_err": worst["fupdate"],
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_b, "bound_by": f_by,
         "library_ms": None, "pass": True,
         "shape": f"m={M} S={2 * P} d={D} rbf f32 (narrow class)",
         "launches_by_path": path_launches},
        {"name": "fupdate_wide", "route": "cuda",
         "source": "src/repro_torch/csrc/fupdate.cu",
         "replaces": "src/repro/kernels/fupdate/kernel.py:30",
         "launches": path_launches["warm"]["f32"]["wide"],
         "max_abs_err": worst["fupdate_wide"], "ms": w_ms,
         "plain_ms": w_plain, "bound_ms": w_b, "bound_by": w_by,
         "library_ms": None, "pass": True,
         "shape": f"m={M} S={w_s} d={D} rbf f32 (SIMT split class; warm "
                  f"hot loop)"},
        {"name": "fupdate_wide_bf16", "route": "cuda",
         "source": "src/repro_torch/csrc/fupdate.cu",
         "replaces": "src/repro/kernels/fupdate/kernel.py:30",
         "launches": path_launches["warm"]["bf16"]["wide"],
         "max_abs_err": worst["fupdate_wide_bf16"], "ms": v_ms,
         "plain_ms": v_plain, "bound_ms": v_b, "bound_by": v_by,
         "library_ms": None, "pass": True,
         "shape": f"m={M} S={w16_s} d={D} rbf bf16 (wgmma split class; "
                  f"warm hot loop)"},
        {"name": "decision_bf16_d768", "route": "cuda",
         "source": "src/repro_torch/csrc/decision.cu",
         "replaces": "src/repro/kernels/decision/kernel.py:27",
         "launches": serve_wide[WIDE_D],
         "max_abs_err": worst["decision_d768"], "ms": e_ms,
         "plain_ms": e_plain, "bound_ms": e_b, "bound_by": e_by,
         "library_ms": None, "pass": True,
         "shape": f"queries={BUCKETS[-1]} support={e_nt} d={WIDE_D} rbf "
                  f"bf16 ([serve-wide])"},
        {"name": "decision", "route": "cuda",
         "source": "src/repro_torch/csrc/decision.cu",
         "replaces": "src/repro/kernels/decision/kernel.py:27",
         "launches": launches["decision"], "max_abs_err": worst["decision"],
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_b, "bound_by": d_by,
         "library_ms": None, "pass": True,
         "launches_by_path": {"main": launches["decision"],
                              "serve-wide": path_launches["serve-wide"],
                              "fleet": path_launches["fleet"]["decision"],
                              "dist": dist_decision},
         "shape": f"queries={BUCKETS[-1]} support={SUPPORT} d={D} rbf f32"},
        {"name": "gram", "route": "cuda",
         "source": "src/repro_torch/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram/kernel.py:27",
         "launches": tune_launches["gram"], "max_abs_err": worst["gram"],
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_b, "bound_by": g_by,
         "library_ms": g_lib, "pass": True,
         "shape": f"m=n={M} d={D} linear f32 (SIMT class)"},
        {"name": "gram_bf16", "route": "cuda",
         "source": "src/repro_torch/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram/kernel.py:27",
         "launches": tune_launches["gram_bf16"],
         "max_abs_err": worst["gram_bf16"], "ms": h_ms, "plain_ms": h_plain,
         "bound_ms": h_b, "bound_by": h_by, "library_ms": h_lib,
         "pass": True, "shape": f"m=n={M} d={D} linear bf16 (wgmma class)"},
    ]}))
    _say_cards_and_result()
    return 0


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--cards", type=int, default=1,
        help="run [dist] alone over this many NCCL ranks, one card each "
             "(default 1: every phase on one card)")
    args = parser.parse_args()
    sys.exit(main() if args.cards == 1 else cards_main(args.cards))
