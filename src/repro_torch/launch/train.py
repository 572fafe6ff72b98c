"""LM training launcher (the JAX package's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 100 --batch 8 --seq-len 256 [--reduced] [--device cpu] \
        [--layout tp|fsdp] [--multi-pod] --ckpt-dir DIR

``--reduced`` takes the arch's reduced config on the (1, 1) mesh;
without it the production mesh, (16, 16) or (2, 16, 16) with
``--multi-pod``, over the process group (started as that many
processes: ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``
in the environment, one card a rank, NCCL). With fewer ranks the mesh
raises, as the JAX package's ``make_production_mesh`` does; with enough,
the launcher raises too: drawing only this rank's shards of the
parameters is not ported (ROADMAP A.12b.2s), and every rank drawing the
whole model does not fit at a production arch's size. FSDP is on from
4e9 parameters; ``--layout`` picks "tp" or "fsdp" (``sharding.specs``).
Random parameters (a generator seeded 0) on the device (default: the
CUDA card), sharded onto the mesh; the synthetic pipeline (seed 0) and
the fault-tolerant loop (checkpoints every ``--save-every`` steps into
``--ckpt-dir``, resumed from there: on the one-rank mesh a rank's
shards are the full, mesh-agnostic arrays ``checkpoint.reshard``
reads); prints the first and the last step's loss as the JAX package's
launcher does.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.data.synthetic import SyntheticPipeline
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models.transformer import init_params
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
from repro_torch.sharding.specs import make_constrain
from repro_torch.sharding.state import shard_params
from repro_torch.train.train_step import init_train_state, make_train_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config + the (1, 1) mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) production mesh (512 ranks)")
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train in the temp directory")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    return ap


def main(argv=None):
    from repro_torch.api import resolve_device
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
            and not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dev = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        mesh = make_test_mesh((1, 1), ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        raise NotImplementedError(
            f"{args.arch} on the production mesh {dict(mesh.shape)}: "
            f"drawing only this rank's shards of the parameters is not "
            f"ported (ROADMAP A.12b.2s)")
    fsdp = cfg.param_count() >= 4e9
    constrain = make_constrain(mesh, fsdp=fsdp, layout=args.layout)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train")

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    state = init_train_state(cfg, shard_params(params, cfg, constrain))
    del params
    step = make_train_step(cfg, constrain=constrain, peak_lr=args.lr,
                           warmup_steps=max(1, args.steps // 10),
                           total_steps=args.steps,
                           microbatches=args.microbatches)
    pipe = SyntheticPipeline(cfg, batch=args.batch, seq_len=args.seq_len,
                             seed=0, device=dev)
    loop = FaultTolerantLoop(step, state, pipe, ckpt_dir,
                             save_every=args.save_every)
    loop.run(args.steps)
    first, last = loop.metrics_log[0], loop.metrics_log[-1]
    print(f"step {first['step']}: loss {first['loss']:.4f}")
    print(f"step {last['step']}: loss {last['loss']:.4f} "
          f"({last['step_time_s']*1e3:.0f} ms/step, "
          f"restarts={loop.restarts})")


if __name__ == "__main__":
    main()
