#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing the result line:

1. build   — compile every ``src/repro_torch/csrc/*.cu`` (one nvcc each,
             all at once) and print ptxas's register/shared-memory lines;
2. kernels — call each kernel's wrapper at the main path's shapes and hold
             it against its plain PyTorch version on the card;
3. main    — ``fit`` (f32 and bf16) then ``serve(...).score`` on the toy
             set at m = 8192, d = 128, with the kernels' launch counts set
             to 0 just before and read just after;
4. timing  — device times of each kernel and its plain version (CUDA
             events around a CUDA graph of repeated calls) beside the
             least time the card could take (its bound), and the scorer's
             latency per bucket on the host's clock;
5. trace   — a torch.profiler window over PROFILE_ITERS iterations of the
             f32 fit: the device's busy and idle share from its own
             events, the top kernels by device time and the top
             operations by host time.

The last three lines are the card's name and power limit as nvidia-smi
gives them, a JSON line with one entry per kernel, and the result line
``{"ok": true, "device": {...}}``. Needs one card, the CUDA toolkit
(nvcc) and the repository's ``src/`` beside this file; imports nothing of
JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "f16": 989e12}

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
PROFILE_ITERS = 100       # solver iterations inside the profiler window


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    import numpy as np
    import repro_torch
    from repro_torch.core import SlabSpec, linear, poly, rbf
    from repro_torch.data import make_toy
    from repro_torch.kernels import _build
    from repro_torch.kernels.decision import ops as dec
    from repro_torch.kernels.decision.ref import decision_plain
    from repro_torch.kernels.fupdate import ops as fup
    from repro_torch.kernels.fupdate.ref import fupdate_plain
    from repro_torch.kernels.precision import PRECISIONS, truth_tolerance
    from repro_torch.serve import BUCKETS, pack_model
    from repro_torch.api import resolve_device
    from repro_torch.core.ocssvm import OCSSVMModel

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
        """out against plain at the f32 tolerance of TOLERANCES (both see
        the same operands, so only the summation order differs), a
        tolerance that must be at most 1% of the median |work|. Returns
        (max abs err, max rel err, tolerance, tolerance / median |work|)."""
        out, plain, work = (a.float().cpu().numpy() for a in (out, plain,
                                                              work))
        check(np.all(np.isfinite(out)), f"{what}: non-finite kernel output")
        tol = truth_tolerance("f32", plain)
        share = tol["atol"] / float(np.median(np.abs(work)))
        check(share <= 1e-2, f"{what}: tolerance {tol} is {share:.3g} of "
              f"the median work of the kernel; the check would be blind")
        np.testing.assert_allclose(out, plain, err_msg=what, **tol)
        err = float(np.max(np.abs(out - plain)))
        return err, err / float(np.max(np.abs(plain))), tol, share

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

    worst = {"fupdate": 0.0, "decision": 0.0}
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
                worst["fupdate"] = max(worst["fupdate"], err)
                say(f"[kernels] fupdate m={m} S={s} d={D} {kind:6s} "
                    f"{precision:4s} max_abs={err:.3e} max_rel={rel:.3e} "
                    f"tol={tol} tol/median_update={share:.2e}")

    def check_queries(kind, n):
        q = make_toy(SEED + n, n, d=D)[0]
        if kind != "rbf":
            q = q / np.linalg.norm(q, axis=1, keepdims=True)
        return torch.as_tensor(q, device=dev)

    def support_model(kind, precision):
        """A packed model of SUPPORT check rows. Its weights are positive,
        as almost all of a fitted model's are, and scaled so that
        |s| <= 1 over the largest bucket's queries; its offsets sit at the
        quartiles of that s. The outputs take both signs, and s is O(1)
        (with weights of both signs, s of the linear kernel gathers near
        0 and its output near -s^2, small beside the tolerance)."""
        kern = kernels[kind]
        T = torch.as_tensor(rows[kind][:SUPPORT], device=dev)
        g = torch.as_tensor(np.abs(rng.standard_normal(SUPPORT))
                            .astype(np.float32), device=dev)
        s = kern.cross(check_queries(kind, BUCKETS[-1]), T) @ g
        g, s = g / s.abs().max(), s / s.abs().max()
        model = OCSSVMModel(gamma=g, rho1=torch.quantile(s, 0.25),
                            rho2=torch.quantile(s, 0.75), X=T,
                            spec=SlabSpec(kernel=kern))
        return pack_model(model, precision=precision, sv_threshold=0.0)

    def decision_operands(kind, sm, bucket, precision):
        q = torch.zeros((bucket, sm.t_pad.shape[1]), device=dev)
        q[:, :D] = check_queries(kind, bucket)
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
                say(f"[kernels] decision bucket={bucket} support="
                    f"{sm.t_pad.shape[0]} d={D} {kind:6s} {precision:4s} "
                    f"max_abs={err:.3e} max_rel={rel:.3e} tol={tol} "
                    f"tol/median_work={share:.2e}")

    # -- 3. the main path --------------------------------------------------
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=kernels["rbf"])
    fup.FUPDATE.launches = 0
    dec.DECISION.launches = 0
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
        f"fit+pack seconds={serve_fit_s:.3f} launches={launches}")

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

    # -- 4. timing ----------------------------------------------------------
    def time_ms(fn, iters=100, warmup=3):
        """Mean device time of fn(): `iters` calls captured in one CUDA
        graph, timed by CUDA events around its replay. Replaying leaves
        out the host's launch cost, which is about as long as a hot-loop
        fupdate and would otherwise be what a loop of launches times."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def bound(nbytes, flops, precision):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[precision]
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    # A kernel's time is that of its launch on prepared operands
    # (fup.launch, dec.launch), built on the stream that captures it; the
    # wrapper's casts and norms are not the kernel's work.
    timed = {}
    for (m, s) in FUPDATE_SHAPES:
        for precision in PRECISIONS:
            ops = fupdate_operands("rbf", m, s, precision)
            ms = time_ms(lambda: fup.launch(*ops, kernels["rbf"])())
            plain_ms = time_ms(lambda: fupdate_plain(*ops, **plain_kw("rbf")))
            es = ops[0].element_size()
            nbytes = (m + s) * D * es + 4 * (3 * m + 2 * s)
            flops = 2 * m * s * D + 2 * m * s
            b_ms, b_by = bound(nbytes, flops, precision)
            timed[("fupdate", m, s, precision)] = (ms, plain_ms, b_ms, b_by)
            say(f"[timing] fupdate m={m} S={s} d={D} rbf {precision:4s} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b_ms:.5f} ({b_by}) "
                f"bound_share={b_ms / ms:.3f}")
    for precision in PRECISIONS:
        smp = support_model("rbf", precision)
        rho1, rho2 = float(smp.model.rho1), float(smp.model.rho2)
        for bucket in BUCKETS:
            ops = decision_operands("rbf", smp, bucket, precision)
            ms = time_ms(lambda: dec.launch(*ops, rho1, rho2,
                                            kernels["rbf"])(), iters=30)
            plain_ms = time_ms(lambda: decision_plain(
                *ops, rho1, rho2, **plain_kw("rbf")), iters=30)
            es = ops[0].element_size()
            nt, dp = ops[1].shape
            nbytes = (bucket + nt) * dp * es + 4 * (2 * nt + 2 * bucket)
            flops = 2 * bucket * nt * dp + 2 * bucket * nt
            b_ms, b_by = bound(nbytes, flops, precision)
            timed[("decision", bucket, nt, precision)] = (ms, plain_ms, b_ms,
                                                          b_by)
            say(f"[timing] decision bucket={bucket} support={nt} d={dp} rbf "
                f"{precision:4s} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b_ms:.5f} ({b_by}) "
                f"bound_share={b_ms / ms:.3f}")

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
        say(f"[timing] serve score bucket={bucket} (numpy in/out, n_sv="
            f"{sm.n_sv}) p50_ms={1e3 * lat[len(lat) // 2]:.4f} "
            f"min_ms={1e3 * lat[0]:.4f}")
    say(f"[timing] max_memory_allocated="
        f"{torch.cuda.max_memory_allocated()} bytes")

    # -- 5. where a fit's time goes: a profiler window over one solve ------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = repro_torch.fit(X_np, spec, strategy="auto", P=P, tol=TOL,
                              max_outer=PROFILE_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device time is read from the device's own events (kernels, copies):
    # the operators' rows of key_averages() carry their kernels' time too.
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in on_card):    # the union of their intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_s = busy_us / 1e6
    iters = max(1, int(res.iters))
    say(f"[trace] fit f32 m={M} iters={int(res.iters)} wall_s={wall:.4f} "
        f"device_busy_s={busy_s:.6f} device_idle_share="
        f"{1 - busy_s / wall:.4f} device_ms_per_iter="
        f"{1e3 * busy_s / iters:.4f} device_events_per_iter="
        f"{len(on_card) / iters:.1f}" if busy_s > 0 else
        "[trace] device time: not measured (the profiler saw none)")
    per_name = {}
    for e in on_card:
        calls, us = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    for name, (calls, us) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][1])[:10]:
        say(f"[trace] device {name[:60]!r}: calls={calls} ms={us / 1e3:.3f}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:10]:
        say(f"[trace] host {e.key[:60]!r}: calls={e.count} "
            f"self_cpu_ms={e.self_cpu_time_total / 1e3:.3f}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    say(smi.stdout.strip().splitlines()[0])

    f_ms, f_plain, f_b, f_by = timed[("fupdate", M, 2 * P, "f32")]
    d_ms, d_plain, d_b, d_by = timed[("decision", BUCKETS[-1], SUPPORT,
                                      "f32")]
    say(json.dumps({"kernels": [
        {"name": "fupdate", "route": "cuda",
         "source": "src/repro_torch/csrc/fupdate.cu",
         "replaces": "src/repro/kernels/fupdate/kernel.py:30",
         "launches": launches["fupdate"], "max_abs_err": worst["fupdate"],
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_b, "bound_by": f_by,
         "library_ms": None, "pass": True,
         "shape": f"m={M} S={2 * P} d={D} rbf f32"},
        {"name": "decision", "route": "cuda",
         "source": "src/repro_torch/csrc/decision.cu",
         "replaces": "src/repro/kernels/decision/kernel.py:27",
         "launches": launches["decision"], "max_abs_err": worst["decision"],
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_b, "bound_by": d_by,
         "library_ms": None, "pass": True,
         "shape": f"queries={BUCKETS[-1]} support={SUPPORT} d={D} rbf f32"},
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
