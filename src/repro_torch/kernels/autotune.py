"""Tile-config autotuner for the three CUDA kernel families, on the card.

    python -m repro_torch.kernels.autotune --quick|--full \\
        [--precisions f32,bf16] [--repeats 3] [--json PATH] [--update-table]

Sweeps the menu entries (``tiling.MENUS``) of each (family, shape,
precision) cell, times each feasible candidate on the card, classifies it
as bytes- or operations-bound on the H100 roofline
(``utils/roofline.terms``) and commits the winners to the table
``kernels/tuned_configs.json`` that ``tiling.resolve_tiles`` reads at
every launch. The counterpart of the JAX package's
``kernels/autotune.py``, with the same row schema (plus the register
tile ``tr``/``tc``) and backend key ``"cuda"``.

The moving parts:

* :func:`candidates` — the menu entries a cell's launch may take
  (``tiling.menu``: for fupdate those of the selected block's class, for
  gram those of the precision's), kept if :func:`feasible` on a Hopper
  SM: static shared memory (:func:`smem_bytes`) at most 48 KiB and
  static plus dynamic at most 227 KiB (the ring of the pipelined and
  wgmma kernels is dynamic: the launchers opt in with
  ``cudaFuncSetAttribute``), :func:`threads` a multiple of 32 and at
  most 1024, a row's ``BN/TC`` threads inside one warp for the row-sum
  kernels, and :func:`register_estimate` within 255 a thread and 65536
  a CTA. ``chip_smoke.py`` holds the estimate against the counts
  ``ptxas -v`` prints when the kernels are built
  (:func:`ptxas_registers`).
* :func:`cost_model` — the logical FLOPs (as the JAX package counts
  them) and the bytes the CUDA grid streams from device memory: no 128
  pad, the second operand read once per CTA (for gram, each operand once
  per tile of the other). Re-reads of an operand small enough for the
  50 MB L2 are served there, so for those the count is an upper bound on
  the HBM traffic; it is what the tile sizes trade off.
* :func:`classify` — "memory" (bytes-bound) or "compute" from those two
  numbers on the H100's peaks for the input type.
* :func:`sweep` — each candidate launched through the family's
  ``launch`` on prepared operands with an explicit config (never the
  table it is producing), timed by CUDA events around the replay of a
  CUDA graph of repeated launches (:func:`graph_ms`), the minimum of
  ``repeats`` replays kept. It raises without a CUDA card: timing the
  plain versions on the CPU would say nothing about the kernels.
* :func:`winners_to_entries` / :func:`write_table` — the winners in the
  table format, merged into ``tuned_configs.json`` on their key.

The cells are the JAX package's ``QUICK_CELLS``/``FULL_CELLS`` plus the
main path's shapes at full width (:data:`MAIN_CELLS`).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.core.kernel_fn import rbf
from repro_torch.kernels.decision import ops as dec
from repro_torch.kernels.fupdate import ops as fup
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.precision import check_precision, tile_dtype
from repro_torch.kernels.tiling import (TUNED_TABLE_PATH, TileConfig,
                                        clear_caches, kernel_of, menu,
                                        validate_table)
from repro_torch.utils.roofline import terms

# Hopper feasibility model (per CTA; H100 SXM).
SMEM_STATIC_BYTES = 48 * 1024      # static shared memory a CTA may declare
SMEM_BYTES = 232448                # static + dynamic (227 KiB)
MAX_THREADS = 1024
MAX_REGS_PER_THREAD = 255
REGS_PER_SM = 65536

# Launches in each timed graph of the sweep.
SWEEP_ITERS = 20

# <repo>/build/autotune (this file is <repo>/src/repro_torch/kernels/).
DEFAULT_JSON = (Path(__file__).resolve().parents[3] / "build" / "autotune"
                / "BENCH_torch_autotune.json")


@dataclass(frozen=True)
class Cell:
    """One sweep cell: a (family, shape) point.

    Shape semantics per family — ``m`` is always the table-key row count:
      gram:     m x n kernel matrix, d features (training: n == m).
      fupdate:  m training rows, n = selected-block size S, d features.
      decision: m support rows, n query rows, d features.
    """

    family: str
    m: int
    n: int
    d: int


# The JAX package's cells (its kernels/autotune.py) ...
QUICK_CELLS = (
    Cell("gram", 512, 512, 16),
    Cell("fupdate", 512, 16, 16),
    Cell("decision", 512, 128, 16),
)
# ... and the main path's shapes at full width: the solver's hot loop at
# m = 8192, d = 128 (S = 2P = 32), its init pass (m = S = 2048), the
# kernel matrix of the same rows, and 4096 queries against 8192 rows.
MAIN_CELLS = (
    Cell("gram", 8192, 8192, 128),
    Cell("fupdate", 8192, 32, 128),
    Cell("fupdate", 2048, 2048, 128),
    Cell("decision", 8192, 4096, 128),
)
FULL_CELLS = QUICK_CELLS + (
    Cell("gram", 1024, 1024, 64),
    Cell("gram", 2048, 2048, 16),
    Cell("fupdate", 1024, 16, 64),
    Cell("fupdate", 2048, 32, 16),
    Cell("decision", 1024, 256, 64),
    Cell("decision", 4096, 256, 16),
) + MAIN_CELLS


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def threads(family: str, cfg: TileConfig) -> int:
    """Threads of one CTA: (BM/TR) * (BN/TC), plus the producer
    warpgroup of a wgmma entry."""
    nt = (cfg.block_m // cfg.tr) * (cfg.block_n // cfg.tc)
    return nt + (128 if kernel_of(family, cfg) == "wgmma" else 0)


def smem_bytes(family: str, cfg: TileConfig,
               precision: str = "f32") -> Tuple[int, int]:
    """(static, dynamic) shared memory of one CTA, by kernel: the tile's
    two f32 chunks with their +1 columns of bank padding; the SIMT
    kernel's two stages with +4 columns; the pipelined fupdate's ring of
    DEPTH raw chunks, rows padded by 16 bytes; the wgmma ring of DEPTH
    16-bit (BM + BN) x BK stages, four 64 x 64 f32 output chunks, two
    tiles' BN column norms, 1024 bytes of alignment slack and two 8-byte
    barriers a stage."""
    bm, bn, bk, depth = cfg.block_m, cfg.block_n, cfg.block_k, cfg.depth
    kind = kernel_of(family, cfg)
    if kind == "tile":
        return (bm + 1 + bn + 1) * bk * 4 * depth, 0
    if kind == "simt":
        return depth * bk * (bm + 4 + bn + 4) * 4, 0
    if kind == "wgmma":
        return 0, (depth * (bm + bn) * bk * 2 + 4 * 64 * 64 * 4 + 2 * bn * 4
                   + 1024 + 16 * depth)
    es = torch.empty((), dtype=tile_dtype(precision)).element_size()
    return 0, depth * (bm + bn) * (bk * es + 16)


def register_estimate(family: str, cfg: TileConfig) -> int:
    """Registers a thread needs, by kernel: the TR x TC accumulators and
    a fixed allowance for addresses, loop counters and the epilogue, plus
    the operands of one step — the tile's TR + TC and its TR row norms
    and partial sums; the SIMT kernel's two float4s of rows and of
    columns and its prefetched float4s; the pipelined fupdate's 16-byte
    reads of TR rows and TC columns (8 values each in 16 bits) and its
    staging addresses. A wgmma consumer holds its BN/2 accumulators
    (TR x TC) and the epilogue's few. Capped at what the kernels'
    ``__launch_bounds__`` leave a thread of a full CTA (ptxas fits the
    kernel to that); above 255 the kernel cannot run."""
    acc = cfg.tr * cfg.tc
    kind = kernel_of(family, cfg)
    if kind == "wgmma":
        regs = acc + 56
    elif kind == "simt":
        regs = acc + 4 * (cfg.tr + cfg.tc) + 48
    elif kind == "pipe":
        regs = acc + 8 * (cfg.tr + cfg.tc) + 96
    else:
        regs = acc + 3 * cfg.tr + cfg.tc + 48
    return min(regs, REGS_PER_SM // threads(family, cfg) // 8 * 8)


def feasible(family: str, cfg: TileConfig, precision: str = "f32") -> bool:
    """Whether ``cfg`` can launch on a Hopper SM with rows of
    ``precision`` (module docstring)."""
    if cfg.block_m % cfg.tr or cfg.block_n % cfg.tc:
        return False
    nt = threads(family, cfg)
    if nt % 32 or nt > MAX_THREADS:
        return False
    ntx = cfg.block_n // cfg.tc
    if family != "gram" and (ntx > 32 or 32 % ntx):
        return False            # a row's threads must sit in one warp
    static, dynamic = smem_bytes(family, cfg, precision)
    if static > SMEM_STATIC_BYTES or static + dynamic > SMEM_BYTES:
        return False
    regs = register_estimate(family, cfg)
    return regs <= MAX_REGS_PER_THREAD and regs * nt <= REGS_PER_SM


def _config_dict(cfg: TileConfig) -> dict:
    return {"block_m": cfg.block_m, "block_n": cfg.block_n,
            "block_k": cfg.block_k, "tr": cfg.tr, "tc": cfg.tc,
            "depth": cfg.depth}


def candidates(cell: Cell, *, precision: str) -> List[dict]:
    """The feasible configs for a cell: the menu entries its launch may
    take (``tiling.menu``) that pass :func:`feasible`."""
    check_precision(precision)
    return [_config_dict(c) for c in menu(cell.family, cell.n, precision)
            if feasible(cell.family, c, precision)]


def cost_model(cell: Cell, *, block_m: int, block_n: int,
               block_k: Optional[int] = None, precision: str) -> tuple:
    """(flops, hbm_bytes) for one candidate.

    FLOPs count the logical work, as the JAX package counts it; the
    bytes count what the grid requests from device memory, ragged tiles
    only their live rows (``block_k`` is the chunk depth; each CTA reads
    every feature once, so it does not enter).
    """
    es = torch.empty((), dtype=tile_dtype(precision)).element_size()
    if cell.family == "gram":
        m, n, d = cell.m, cell.n, cell.d
        gm, gn = _ceil_div(m, block_m), _ceil_div(n, block_n)
        flops = 2.0 * m * n * d
        hbm = (m * d * es * gn                       # x, once per col tile
               + n * d * es * gm                     # y, once per row tile
               + m * n * 4.0                         # output, written once
               + (m * gn + n * gm) * 4.0)            # norms, with the rows
    elif cell.family == "fupdate":
        m, s, d = cell.m, cell.n, cell.d
        gm = _ceil_div(m, block_m)
        flops = 2.0 * m * s * d + 2.0 * m * s
        hbm = (m * d * es                            # x, streamed once
               + s * d * es * gm                     # xsel, per CTA
               + 3.0 * m * 4.0                       # f in, out, norms
               + gm * 2.0 * s * 4.0)                 # delta + sel norms
    elif cell.family == "decision":
        msv, nq, d = cell.m, cell.n, cell.d
        gq = _ceil_div(nq, block_m)
        flops = 2.0 * nq * msv * d + 2.0 * nq * msv
        hbm = (nq * d * es                           # q, once
               + msv * d * es * gq                   # t, per query tile
               + 2.0 * msv * 4.0 * gq                # gamma + norms
               + 2.0 * nq * 4.0)                     # q norms + output
    else:
        raise ValueError(f"unknown family {cell.family!r}")
    return flops, hbm


def classify(flops: float, hbm_bytes: float, precision: str = "f32") -> str:
    """Bytes-bound ("memory") or operations-bound ("compute") on the
    H100's roofline for inputs of ``precision``."""
    t = terms(flops, hbm_bytes, 0.0, 1, precision)
    return "memory" if t.memory_s >= t.compute_s else "compute"


def graph_ms(fn: Callable[[], object], *, iters: int = 100,
             repeats: int = 1) -> float:
    """Device time of one ``fn()`` in ms: ``iters`` calls captured in one
    CUDA graph (after 3 warm-up calls on a side stream), timed by CUDA
    events around its replay; the least of ``repeats`` replays (after one
    untimed replay). Replaying leaves out the host's launch cost, which
    is about as long as a small launch and would otherwise be what a loop
    of launches times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(repeats, 1)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / iters)
    return best


def _make_runner(cell: Cell, precision: str,
                 dev: torch.device) -> Callable[[TileConfig], object]:
    """The timed launch of one cell: data made once on the card from a
    seed, each candidate launched on the prepared operands with its
    explicit config (never the table)."""
    kern = rbf(gamma=0.5)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    if cell.family == "gram":
        ops = gram_ops.prepare(normal(cell.m, cell.d),
                               normal(cell.n, cell.d), precision=precision)
        return lambda cfg: gram_ops.launch(*ops, kern, cfg)()
    if cell.family == "fupdate":
        x = normal(cell.m, cell.d)
        ops = fup.prepare(x, x[:cell.n], normal(cell.n) * 0.05,
                          normal(cell.m), precision=precision)
        return lambda cfg: fup.launch(*ops, kern, cfg)()
    if cell.family == "decision":
        dt = tile_dtype(precision)
        t = fup.as_tile(normal(cell.m, cell.d), dt)
        q = fup.as_tile(normal(cell.n, cell.d), dt)
        ops = (q, t, normal(cell.m) * 0.05, fup.row_norms(q),
               fup.row_norms(t))
        return lambda cfg: dec.launch(*ops, 0.2, 0.8, kern, cfg)()
    raise ValueError(f"unknown family {cell.family!r}")


def _candidate_name(cell: Cell, cfg: dict) -> str:
    return (f"{cell.family}_m{cell.m}_n{cell.n}_d{cell.d}_bm{cfg['block_m']}"
            f"_bn{cfg['block_n']}_bk{cfg['block_k']}_t{cfg['tr']}x"
            f"{cfg['tc']}_x{cfg['depth']}")


def sweep(cells: Optional[Iterable[Cell]] = None, *, mode: str = "quick",
          precisions: Sequence[str] = ("f32",), repeats: int = 3,
          progress: Optional[Callable[[str], None]] = None) -> dict:
    """Run the sweep on the current CUDA card; returns the BENCH document
    (``candidates`` and ``winners`` rows). ``cells`` defaults to
    :data:`QUICK_CELLS` / :data:`FULL_CELLS` by ``mode``; one winner row
    per (cell, precision): the least time of any candidate."""
    if not torch.cuda.is_available():
        raise RuntimeError("the autotune sweep times the kernels on a CUDA "
                           "card, and none is available")
    if cells is None:
        cells = QUICK_CELLS if mode == "quick" else FULL_CELLS
    precisions = tuple(check_precision(p) for p in precisions)
    say = progress or (lambda _msg: None)
    dev = torch.device("cuda", torch.cuda.current_device())

    cand_rows: List[dict] = []
    winner_rows: List[dict] = []
    for cell in cells:
        for precision in precisions:
            run = _make_runner(cell, precision, dev)
            best = None
            for cfg in candidates(cell, precision=precision):
                tile = TileConfig(cfg["block_m"], cfg["block_n"],
                                  cfg["block_k"], cfg["tr"], cfg["tc"],
                                  cfg["depth"], "explicit")
                flops, hbm = cost_model(
                    cell, block_m=cfg["block_m"], block_n=cfg["block_n"],
                    block_k=cfg["block_k"], precision=precision)
                t = 1e-3 * graph_ms(lambda: run(tile), iters=SWEEP_ITERS,
                                    repeats=repeats)
                row = {"name": _candidate_name(cell, cfg),
                       "family": cell.family,
                       "m": cell.m, "n": cell.n, "d": cell.d,
                       "precision": precision, "time_s": t, **cfg,
                       "bound": classify(flops, hbm, precision),
                       "flops": flops, "hbm_bytes": hbm}
                cand_rows.append(row)
                say(f"{row['name']},{precision},{t * 1e6:.2f}us,"
                    f"{row['bound']}-bound")
                if best is None or t < best["time_s"]:
                    best = row
            win = dict(best)
            win["name"] = (f"{cell.family}_m{cell.m}_n{cell.n}"
                           f"_d{cell.d}_best")
            win["best_s"] = win.pop("time_s")
            winner_rows.append(win)
            say(f"WINNER {win['name']},{precision},"
                f"bm{win['block_m']}/bn{win['block_n']}/bk{win['block_k']}"
                f"/t{win['tr']}x{win['tc']}/x{win['depth']},"
                f"{win['best_s'] * 1e6:.2f}us")

    return {
        "mode": mode,
        "backend": "cuda",
        "device": torch.cuda.get_device_name(dev),
        "candidates": cand_rows,
        "winners": winner_rows,
    }


# ---------------------------------------------------------------------------
# committed-table production
# ---------------------------------------------------------------------------

def winners_to_entries(result: dict) -> List[dict]:
    """Winner rows -> tuned-table entries keyed for ``resolve_tiles``."""
    backend = result["backend"]
    out = []
    for w in result["winners"]:
        out.append({
            "family": w["family"],
            "m": w["m"],                  # the table-key row count
            "d": w["d"],
            "precision": w["precision"],
            "backend": backend,
            "block_m": w["block_m"],
            "block_n": w["block_n"],
            "block_k": w["block_k"],
            "tr": w["tr"],
            "tc": w["tc"],
            "depth": w["depth"],
            "bound": w["bound"],
            "best_s": w["best_s"],
        })
    return out


def _entry_key(e: dict) -> tuple:
    return (e["family"], e["m"], e["d"], e["precision"], e["backend"])


def write_table(entries: List[dict], path=TUNED_TABLE_PATH, *,
                merge: bool = True) -> dict:
    """Merge ``entries`` into the table at ``path``.

    Same-key entries are replaced, everything else is preserved (so a
    quick sweep refreshes its cells without wiping a full sweep's).
    Entries are sorted by key so re-runs produce stable diffs. The
    document is validated before it is written, and the process's parsed
    table is forgotten (``tiling.clear_caches``).
    """
    path = Path(path)
    merged = {}
    if merge and path.exists():
        with open(path) as fh:
            for e in json.load(fh).get("entries", []):
                merged[_entry_key(e)] = e
    for e in entries:
        merged[_entry_key(e)] = e
    doc = {
        "version": 1,
        "generated_by": "python -m repro_torch.kernels.autotune "
                        "--update-table",
        "entries": [merged[k] for k in sorted(merged)],
    }
    validate_table(doc)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    clear_caches()
    return doc


# ---------------------------------------------------------------------------
# the register estimate against ptxas
# ---------------------------------------------------------------------------

_ENTRY_RE = re.compile(r"(gram|fupdate|decision)(?:_simt|_wgmma|_pipe)?"
                       r"_kernelI(f|13__nv_bfloat16|6__half)((?:Li\d+E){6})")
_REGS_RE = re.compile(r"Used (\d+) registers")
_DTYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def ptxas_registers(lines: Iterable[str]) -> Dict[tuple, int]:
    """{(family, dtype, (BM, BN, BK, TR, TC, DEPTH)): registers} from the
    ``ptxas -v`` lines of a build (``_build.Built.ptxas``): each
    "Compiling entry function" line names a kernel instantiation, and the
    next "Used N registers" line is its count."""
    out: Dict[tuple, int] = {}
    key = None
    for line in lines:
        m = _ENTRY_RE.search(line)
        if m:
            key = (m.group(1), _DTYPES[m.group(2)],
                   tuple(int(v) for v in re.findall(r"\d+", m.group(3))))
            continue
        r = _REGS_RE.search(line)
        if r and key is not None:
            out[key] = int(r.group(1))
            key = None
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.autotune",
        description="Sweep the CUDA kernels' menus on the card and "
                    "(optionally) commit the winners to "
                    "src/repro_torch/kernels/tuned_configs.json.")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--quick", action="store_true",
                      help="QUICK_CELLS (the default)")
    size.add_argument("--full", action="store_true",
                      help="FULL_CELLS: the JAX package's cells and the "
                           "main path's shapes")
    ap.add_argument("--precisions", default="f32",
                    help="comma-separated, e.g. f32,bf16")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--json", default=str(DEFAULT_JSON),
                    help="where the BENCH document goes")
    ap.add_argument("--update-table", action="store_true",
                    help="merge the winners into the committed table")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    result = sweep(mode="full" if args.full else "quick",
                   precisions=args.precisions.split(","),
                   repeats=args.repeats, progress=print)
    result["seconds"] = time.perf_counter() - t0
    out = Path(args.json)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1) + "\n")
    print(f"{len(result['candidates'])} candidates, "
          f"{len(result['winners'])} winners in {result['seconds']:.2f} s "
          f"on {result['device']} -> {out}")
    if args.update_table:
        doc = write_table(winners_to_entries(result))
        print(f"{TUNED_TABLE_PATH}: {len(doc['entries'])} entries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
