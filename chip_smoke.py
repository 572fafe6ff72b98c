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
import tempfile
import time
from pathlib import Path

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

    shrink_launches = {}
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
    warm_launches, warm_shapes = {}, {}
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
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
