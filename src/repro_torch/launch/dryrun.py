"""Multi-pod dry run: every (arch x shape x mesh) cell's step, run on meta
tensors as rank 0 of the production mesh — the JAX package's
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out results/dryrun_torch

The JAX dry run lowers and compiles each cell for 256 / 512 host devices:
a successful compile proves that the shardings divide and the
collectives are legal, and the compiled module gives its memory and cost
analyses. The port runs SPMD, one process per rank, so its dry run is
rank 0 itself: a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``, whose collectives
return at once), the production mesh over it, rank 0's shards of every
input, and the step run through ``utils.cost_analysis`` on ``meta``
tensors. Nothing is computed and no memory is allocated; no card is
needed. This is not a CPU fallback of the step: it is the JAX dry run's
lowering on host devices, done the port's way.

Each cell writes one JSON record in the reference's layout:

* ``memory``: ``argument_bytes_per_device`` — the bytes of rank 0's
  shards of the inputs (the batch's rows under its sharding: the step
  takes the global batch and keeps its rows; a cache's position is a
  host int); ``output_bytes_per_device`` and ``alias_bytes_per_device``
  (outputs written into the inputs' storage: the optimizer's update, the
  KV caches); ``temp_bytes_per_device`` — the most the storages the step
  allocates ever held at once, less its outputs; ``peak_bytes_per_device``
  = argument + output + temp - alias; ``fits_80gb_hbm`` against the H100
  SXM's 80 GB (NVIDIA's data sheet; the reference's ``fits_16gb_hbm`` is
  a TPU's);
* ``op_cost``: the counted FLOPs, the HBM bytes upper bound and the
  collective bytes by kind, rank 0's times the ranks (the reference's
  ``hlo_cost``, its module being the per-device program);
* ``analytic`` and ``roofline``: ``utils.roofline``'s inventory and
  three terms (compute from the counted FLOPs at the peak of the cell's
  compute type, memory from the analytic bytes, as in the reference) and
  ``mfu_fraction``.

A cell that raises is recorded as ``failed`` and the sweep goes on. So
is a cell whose op stream passes ``MAX_OPS`` operations. (The Mamba and
RWKV scans are one operator a layer and a pass, ``kernels.scan.ops``,
whose fake implementation gives their shapes and whose FLOP formulas the
counter reads; as a Python loop over the sequence their op streams ran
to tens of millions at 4096 and 32768 positions.)

The fake process group lives in this process only: run the dry run as a
process of its own (``main`` does), never in a process that holds a
real group or builds a one-rank mesh afterwards.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, long_context_capable
from repro_torch.utils import roofline
from repro_torch.utils.cost_analysis import analyze_with_memory, storage_bytes

# FSDP (ZeRO-3 weight sharding over "data") on for everything that needs it;
# small models keep pure TP+DP which is faster at their scale.
FSDP_MIN_PARAMS = 4e9
# The H100 SXM's memory (NVIDIA's data sheet), the fit test of a cell.
HBM_BYTES = 80e9
# Operations a cell may dispatch before it is recorded as failed.
MAX_OPS = 4_000_000

_PRECISION = {torch.bfloat16: "bf16", torch.float16: "f16",
              torch.float32: "f32"}


def should_skip(arch: str, shape_name: str) -> str:
    cfg = get_arch(arch)
    if shape_name == "long_500k" and not long_context_capable(cfg):
        return ("pure full-attention arch: 500k dense-KV decode excluded "
                "per the long_500k sub-quadratic policy (DESIGN.md)")
    return ""


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks with this process as rank
    0, destroyed on exit (``launch.mesh`` reads the group: one left
    behind would make every later mesh this process builds a
    production one)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: run "
                           "the dry run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def microbatches_for(cfg, batch: int, mesh, layout: str = "tp") -> int:
    """Auto gradient accumulation: ~2 sequences per device per microbatch
    (1 for deep/wide models) so activation residuals and attention-score
    transients fit HBM (the reference's rule)."""
    dp = 1
    axes = (("pod", "data", "model") if layout == "fsdp"
            else ("pod", "data"))
    for ax in axes:
        if ax in mesh.axis_names:
            dp *= mesh.shape[ax]
    b_loc = max(1, batch // dp)
    big = cfg.n_layers * cfg.d_model >= 250_000
    return b_loc if big else max(1, b_loc // 2)


def _shard_nbytes(tree, shardings) -> int:
    """The bytes of rank 0's shard of each meta tensor of ``tree`` under
    its ``NamedSharding`` (``shardings``, the same structure)."""
    from repro_torch.sharding.collectives import shard
    from repro_torch.utils.tree import leaves
    return sum(shard(t, s.spec, s.mesh).numel() * t.element_size()
               for t, s in zip(leaves(tree), leaves(shardings)))


def lower_cell(cfg, shape, mesh, *, fsdp: bool, q_chunk: int = 1024,
               layout: str = "tp", microbatches=None, ledger=None):
    """This rank's inputs of one cell and its step, on ``meta``: (step,
    args, the bytes of the inputs' shards). ``shape``: a ``SHAPES`` name
    or a cell of its own ({"seq_len", "batch", "step"}); ``microbatches``
    (train): default the reference's rule."""
    from repro_torch.launch.specs import input_specs
    from repro_torch.sharding.specs import make_constrain
    from repro_torch.sharding.state import init_cache_sharded, shard_params
    from repro_torch.train.serve_step import make_decode, make_prefill
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    constrain = make_constrain(mesh, fsdp=fsdp, layout=layout, ledger=ledger)
    kind, args, shds = input_specs(cfg, sh, mesh, fsdp=fsdp, layout=layout)
    if kind == "train":
        state_sds, batch = args
        state = init_train_state(cfg, shard_params(state_sds.params, cfg,
                                                   constrain))
        if microbatches is None:
            microbatches = microbatches_for(cfg, sh["batch"], mesh, layout)
        step = make_train_step(cfg, constrain=constrain,
                               microbatches=microbatches)
        arg_bytes = storage_bytes(state) + _shard_nbytes(batch, shds[1])
        return step, (state, batch), arg_bytes
    p_sds, _, inp = args
    params = shard_params(p_sds, cfg, constrain)
    cache = init_cache_sharded(cfg, sh["batch"], sh["seq_len"], constrain,
                               device="meta")
    arg_bytes = (storage_bytes((params, cache["layers"]))
                 + _shard_nbytes(inp, shds[2]))
    if kind == "prefill":
        step = make_prefill(cfg, constrain=constrain, q_chunk=q_chunk)
    else:
        cache["pos"] = sh["seq_len"] - 1     # the last step of a full cache
        step = make_decode(cfg, constrain=constrain)
    return step, (params, cache, inp), arg_bytes


def cost_cell(cfg, shape, mesh, *, fsdp: bool, q_chunk: int = 1024,
              layout: str = "tp", microbatches=None) -> dict:
    """Build one cell on ``mesh`` and run its step under
    ``cost_analysis``: the record's ``memory``, ``op_cost``,
    ``analytic`` (for a ``SHAPES`` name) and ``roofline`` sections."""
    from repro_torch.core.engine.stats import CollectiveLedger
    ledger = CollectiveLedger()
    ledger.set_phase("step")
    step, args, arg_bytes = lower_cell(cfg, shape, mesh, fsdp=fsdp,
                                       q_chunk=q_chunk, layout=layout,
                                       microbatches=microbatches,
                                       ledger=ledger)
    out, cost, info = analyze_with_memory(step, *args, ledger=ledger,
                                          max_ops=MAX_OPS)
    seen: set = set()
    storage_bytes(args, seen)
    new_out = storage_bytes(out, seen)      # outputs in storage of their own
    all_out = storage_bytes(out)
    alias = all_out - new_out
    temp = max(0, info.peak - new_out)
    peak = arg_bytes + all_out + temp - alias
    rec = {"memory": {
        "argument_bytes_per_device": int(arg_bytes),
        "output_bytes_per_device": int(all_out),
        "temp_bytes_per_device": int(temp),
        "alias_bytes_per_device": int(alias),
        "peak_bytes_per_device": int(peak),
        "fits_80gb_hbm": bool(peak < HBM_BYTES),
    }, "ops": info.ops}
    chips = math.prod(mesh.shape.values())
    flops = cost.flops * chips
    coll = cost.collective_bytes * chips
    rec["op_cost"] = {
        "flops_trip_scaled": flops,
        "hbm_bytes_upper_bound": cost.bytes * chips,
        "collective_bytes": coll,
        "collectives": {k: v * chips for k, v in cost.coll.items()},
    }
    precision = _PRECISION[cfg.dtype]
    if isinstance(shape, str):
        analytic_flops = roofline.model_flops(cfg, shape)
        analytic_bytes = roofline.model_hbm_bytes(cfg, shape, chips,
                                                  fsdp=fsdp)
        rec["analytic"] = {
            "model_flops": analytic_flops,
            "model_hbm_bytes": analytic_bytes,
            "useful_flops_ratio": (analytic_flops / flops if flops
                                   else None),
        }
        # Roofline terms: compute + collectives from the op stream, memory
        # from the analytic inventory (eager operations overcount HBM
        # traffic: no fusion), as in the reference.
        terms = roofline.terms(flops, analytic_bytes, coll, chips,
                               precision=precision)
        rec["roofline"] = terms.to_dict()
        rec["roofline"]["precision"] = precision
        rec["roofline"]["mfu_fraction"] = roofline.mfu_fraction(
            terms, analytic_flops, precision)
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             fsdp=None, q_chunk: int = 1024, layout: str = "tp") -> dict:
    """One cell's record; needs the fake process group of its mesh
    (``fake_world(256 or 512)``), which ``main`` holds."""
    from repro_torch.launch.mesh import make_production_mesh
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "layout": layout,
        "status": "ok",
    }
    skip = should_skip(arch, shape_name)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    t0 = time.time()
    try:
        cfg = get_arch(arch)
        if fsdp is None:
            fsdp = cfg.param_count() >= FSDP_MIN_PARAMS
        rec["fsdp"] = bool(fsdp)
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec.update(cost_cell(cfg, shape_name, mesh, fsdp=fsdp,
                             q_chunk=q_chunk, layout=layout))
        rec["lower_s"] = round(time.time() - t0, 1)
    except Exception as e:  # noqa: BLE001 — record, continue the sweep
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        rec["lower_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="all archs x shapes, single-pod + multi-pod")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--q-chunk", type=int, default=1024)
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if (args.all or args.arch == "all") else [args.arch]
    shapes = (list(SHAPES) if (args.all or args.shape == "all")
              else [args.shape])
    meshes = ([False, True] if (args.all or args.mesh == "both")
              else [args.mesh == "multi"])
    fsdp = None if args.fsdp == "auto" else (args.fsdp == "on")

    os.makedirs(args.out, exist_ok=True)
    for multi_pod in meshes:
        with fake_world(512 if multi_pod else 256):
            for arch in archs:
                for shape in shapes:
                    tag = (f"{arch}__{shape}__"
                           f"{'multi' if multi_pod else 'single'}")
                    path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(path):
                        print(f"[skip existing] {tag}")
                        continue
                    print(f"[dryrun] {tag} ...", flush=True)
                    rec = run_cell(arch, shape, multi_pod=multi_pod,
                                   fsdp=fsdp, q_chunk=args.q_chunk)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    status = rec["status"]
                    extra = ""
                    if status == "ok":
                        extra = (
                            f" lower={rec['lower_s']}s "
                            f"dominant={rec['roofline']['dominant']} "
                            f"peak/dev="
                            f"{rec['memory']['peak_bytes_per_device']/1e9:.2f}"
                            f"GB mfu={rec['roofline']['mfu_fraction']:.4f}")
                    elif status == "failed":
                        extra = " " + rec["error"][:200]
                    print(f"[dryrun] {tag}: {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
