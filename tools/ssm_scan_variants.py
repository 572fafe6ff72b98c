"""Time the Mamba scan kernels (``csrc/ssm_scan.cu``) and a jamba Mamba
block through them, in several trees, on the card.

``--trees DIR ...`` runs, for each tree (a checkout's root: ``.``, or the
parent commit unpacked by ``git archive`` under ``build/``, or a scratch
copy with a kernel changed), a process with that tree's ``src/`` first on
``sys.path``, which builds that tree's kernels and times them through its
own ``ops`` with CUDA events at jamba's widths (inner 16384, N 16;
B x S = 1 x 4096 and 4 x 512), and times one jamba Mamba block
(published widths, bf16, 1 x 4096; ``chip_smoke.py`` [lm-ssm] (d))
forward and backward through them: host ms (median of 3 after one
warm-up) and peak GiB. Give the trees in turns (A B B A) to see the
spread.

    python tools/ssm_scan_variants.py --trees build/parent . . build/parent

``--json PATH`` also writes every record. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHAPES = ((1, 4096), (4, 512))
INNER, N = 16384, 16
SEED = 0


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


def _inputs(dev, bt, S):
    """jamba-like inputs, as ``chip_smoke.py`` [lm-ssm] (a) draws them."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f32 = dict(dtype=torch.float32, device=dev)

    def rand(*shape, lo=None, hi=None):
        if lo is None:
            return torch.randn(shape, generator=gen, **f32)
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    ins = [rand(bt, S, INNER), rand(bt, S, INNER, lo=1e-3, hi=0.1),
           rand(bt, S, N), rand(bt, S, N),
           -torch.arange(1, N + 1, **f32).repeat(INNER, 1),
           torch.ones(INNER, **f32), 0.1 * rand(bt, INNER, N)]
    gy = rand(bt, S, INNER)
    gh = rand(bt, INNER, N)
    return ins, gy, gh


def _kernel_times(ops, dev):
    """{shape: (fwd ms, bwd ms)} through ``ops``' launches."""
    out = {}
    for bt, S in SHAPES:
        ins, gy, gh = _inputs(dev, bt, S)
        fl = ops.launch_ssm_fwd(*ins)
        _, _, carries = fl()
        bl = ops.launch_ssm_bwd(gy, gh, *ins[:6], carries)
        bl()
        out[f"{bt}x{S}"] = (_event_ms(fl, 5), _event_ms(bl, 3))
        del ins, gy, gh, fl, bl
    return out


def one_tree(tree: Path, records) -> None:
    """This process: ``tree``'s port, its kernels and its jamba block."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    import repro_torch
    from repro_torch.api import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.kernels.scan import ops
    from repro_torch.models.mamba import mamba_forward, mamba_init

    if not Path(repro_torch.__file__).resolve().is_relative_to(
            tree.resolve()):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {tree}'s")
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    rec = {"tree": str(tree), "card": torch.cuda.get_device_name(dev)}
    for shape, (fms, bms) in _kernel_times(ops, dev).items():
        rec[f"ssm_scan_fwd {shape} ms"] = fms
        rec[f"ssm_scan_bwd {shape} ms"] = bms
    jamba = get_arch("jamba-1.5-large-398b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = mamba_init(torch.Generator(device=dev).manual_seed(SEED), jamba,
                   jamba.dtype)
    x0 = torch.randn((1, 4096, jamba.d_model), generator=gen,
                     device=dev).to(jamba.dtype)
    gy = torch.randn(x0.shape, generator=gen, device=dev).to(jamba.dtype)
    secs = []
    for _ in range(4):
        live = {k: t.detach().requires_grad_() for k, t in p.items()}
        x = x0.detach().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        s0 = time.perf_counter()
        y, _ = mamba_forward(live, x, jamba)
        y.backward(gy)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - s0)
        del live, x, y
    rec["block ms (median of 3)"] = 1e3 * statistics.median(secs[1:])
    rec["block peak GiB"] = torch.cuda.max_memory_allocated(dev) / 2**30
    rec["seconds"] = time.perf_counter() - t0
    records.append(rec)
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="*", default=[])
    ap.add_argument("--one-tree", help=argparse.SUPPRESS)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    records: list = []
    if args.one_tree:
        one_tree(Path(args.one_tree), records)
    for tree in args.trees:
        out = subprocess.run([sys.executable, __file__, "--one-tree", tree],
                             capture_output=True, text=True)
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
