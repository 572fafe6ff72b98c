"""Time every 16-bit entry of the decision kernel's menu that fits a shape,
in turns, in one or several trees, on the card.

For each tree (a checkout's root: ``.``, the parent commit unpacked by
``git archive`` under ``build/``, or a scratch copy with a kernel
changed) a process with that tree's ``src/`` first on ``sys.path`` builds
the tree's kernels and, for each ``--shapes nq,nt,d``, draws N(0, 1)
queries and support rows and positive coefficients from a seed, prepares
them as ``kernels/decision/ops.prepare`` does (``--precision``, rbf of
width 1/d), and times each entry of ``MENUS["decision"]`` of the rows'
class that fits d (``tiling.wgmma_fits``) through ``ops.launch`` with
CUDA events (one warm-up, ``--iters`` launches). A record per entry:
kernel ms, the bound (max of FLOPs at 989 TFLOP/s and each byte once at
3.35 TB/s, as ``utils/roofline``), the share of it, the bytes the tiles
pull through L2 by the count of ``l2_bytes`` below, whether its output is
bitwise the first timed entry's, its largest gap to the plain version
(``ref.decision_plain`` on the card) over the largest |value|, and the
plain version's warm time (CUDA events, 3 calls after one).

``--fupdate m,s,d`` also times fupdate's launch at m rows and S = s
selected rows of d features as the wrapper resolves it (its wide 16-bit
class above S = 32), for a check that an unchanged kernel keeps its time.

    python tools/decision_entries.py --trees build/parent . . build/parent \\
        --shapes 4096,32768,4096 64,32768,4096 --fupdate 2048,2048,3072

``--json PATH`` also writes every record. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
PEAK_16BIT = 989e12
HBM = 3.35e12


def _event_ms(fn, iters: int) -> float:
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nq: int, nt: int, d: int, elem: int = 2) -> float:
    flops = 2.0 * nq * nt * d + 2.0 * nq * nt
    nbytes = nt * (d * elem + 8.0) + nq * (d * elem + 8.0)
    return 1e3 * max(flops / PEAK_16BIT, nbytes / HBM)


def l2_bytes(tiling, cfg, nq: int, nt: int, d: int) -> int:
    """Bytes of 16-bit tiles a launch of ``cfg`` moves from L2 into shared
    memory: each query tile once a CTA (resident) or once a chunk
    (streamed), and each chunk of support rows once a query tile, or once
    a cluster of query tiles where one load feeds them all."""
    qtiles = -(-nq // cfg.block_m)
    nw = 4 * cfg.tc
    chunks = -(-nt // nw)
    wide = cfg.entry == getattr(tiling, "STREAMED_WIDE", None)
    cluster = tiling.CLUSTER_CTAS if wide else 1
    if tiling.kernel_of("decision", cfg) == "stream":
        a_loads = qtiles * chunks
    else:
        a_loads = qtiles * tiling.decision_grid(nq, nt, cfg)[1]
    return 2 * d * (a_loads * cfg.block_m
                    + -(-qtiles // cluster) * chunks * nw)


def _decision_records(tiling, ops, plain, kern, dev, nq, nt, d, precision,
                      iters, gen):
    import torch
    q = torch.randn((nq, d), generator=gen, device=dev)
    t = torch.randn((nt, d), generator=gen, device=dev)
    g = torch.rand((nt,), generator=gen, device=dev) / nt
    prep = ops.prepare(q, t, g, precision=precision)
    del q, t
    want = plain(*prep, 0.1, 0.9, kind=kern.name, gamma=kern.gamma)
    plain_ms = _event_ms(lambda: plain(*prep, 0.1, 0.9, kind=kern.name,
                                       gamma=kern.gamma), 3)
    scale = float(want.abs().max())
    first = None
    out = []
    for cfg in tiling.menu("decision", precision=precision):
        if not tiling.wgmma_fits(cfg, prep[0].shape[1]):
            continue
        launch = ops.launch(*prep, 0.1, 0.9, kern, cfg)
        got = launch().clone()
        ms = _event_ms(launch, iters)
        if first is None:
            first = got
        bound = bound_ms(nq, nt, d)
        out.append({
            "shape": f"{nq}x{nt} d={d}", "entry": list(cfg.entry),
            "kind": tiling.kernel_of("decision", cfg), "kernel_ms": ms,
            "bound_ms": bound, "share": bound / ms,
            "l2_gib": l2_bytes(tiling, cfg, nq, nt, prep[0].shape[1])
            / 2**30,
            "bitwise_first": bool(torch.equal(got, first)),
            "err_vs_plain": float((got - want).abs().max()) / scale,
            "plain_ms": plain_ms})
        del launch, got
    return out


def _fupdate_record(tiling, fops, kern, dev, m, s, d, precision, iters,
                    gen):
    import torch
    x = torch.randn((m, d), generator=gen, device=dev)
    prep = fops.prepare(x, x[:s].clone(), torch.randn((s,), device=dev,
                                                     generator=gen),
                        torch.zeros((m,), device=dev), precision=precision)
    launch = fops.launch(*prep, kern)
    ms = _event_ms(launch, iters)
    return {"shape": f"fupdate m={m} S={s} d={d}",
            "entry": list(launch.config.entry),
            "kind": tiling.kernel_of("fupdate", launch.config),
            "kernel_ms": ms}


def one_tree(tree: Path, args, records) -> None:
    """This process: ``tree``'s port and its decision entries."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    import repro_torch
    from repro_torch.api import resolve_device
    from repro_torch.core.kernel_fn import rbf
    from repro_torch.kernels import tiling
    from repro_torch.kernels.decision import ops
    from repro_torch.kernels.decision.ref import decision_plain
    from repro_torch.kernels.fupdate import ops as fops

    if not Path(repro_torch.__file__).resolve().is_relative_to(
            tree.resolve()):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {tree}'s")
    dev = resolve_device("cuda")
    card = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for shape in args.shapes:
        nq, nt, d = (int(v) for v in shape.split(","))
        for rec in _decision_records(tiling, ops, decision_plain,
                                     rbf(1.0 / d), dev, nq, nt, d,
                                     args.precision, args.iters, gen):
            rec.update(tree=str(tree), card=card)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    for shape in args.fupdate:
        m, s, d = (int(v) for v in shape.split(","))
        rec = _fupdate_record(tiling, fops, rbf(1.0 / d), dev, m, s, d,
                              args.precision, args.iters, gen)
        rec.update(tree=str(tree), card=card)
        records.append(rec)
        print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="*", default=["."])
    ap.add_argument("--shapes", nargs="*", default=["4096,32768,4096"])
    ap.add_argument("--fupdate", nargs="*", default=[])
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--one-tree", help=argparse.SUPPRESS)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    records: list = []
    if args.one_tree:
        one_tree(Path(args.one_tree), args, records)
        return 0
    rest = ["--shapes", *args.shapes, "--fupdate", *args.fupdate,
            "--precision", args.precision, "--iters", str(args.iters)]
    for tree in args.trees:
        out = subprocess.run([sys.executable, __file__, "--one-tree", tree,
                              *rest], capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            return out.returncode
        records.extend(json.loads(ln) for ln in out.stdout.splitlines()
                       if ln.startswith("{"))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
