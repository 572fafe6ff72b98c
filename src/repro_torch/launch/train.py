"""LM training launcher (the JAX package's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 100 --batch 8 --seq-len 256 [--reduced] [--device cpu] \
        [--layout tp|fsdp] [--multi-pod] --ckpt-dir DIR

``--reduced`` takes the arch's reduced config on the (1, 1) mesh;
without it the production mesh, (16, 16) or (2, 16, 16) with
``--multi-pod``, over the process group (started as that many
processes: ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` / ``MASTER_ADDR``
/ ``MASTER_PORT`` in the environment, one card a rank, NCCL). With fewer
ranks the mesh raises, as the JAX package's ``make_production_mesh``
does. FSDP is on from 4e9 parameters; ``--layout`` picks "tp" or "fsdp"
(``sharding.specs``). Random parameters (a generator seeded 0) on the
device (default: the CUDA card): on the (1, 1) mesh drawn whole and
sharded, on the production mesh each rank draws only its shards
(``init_params_sharded``, the same values); the synthetic pipeline
(seed 0) and the fault-tolerant loop (checkpoints every ``--save-every``
steps into ``--ckpt-dir``, resumed from there: on the one-rank mesh a
rank's shards are the full, mesh-agnostic arrays ``checkpoint.reshard``
reads; on the production mesh the shards are gathered and the first
rank writes them, ``save_sharded``); the first rank prints the first and
the last step's loss as the JAX package's launcher does.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.data.synthetic import SyntheticPipeline
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.spawn import join_process_group
from repro_torch.models.transformer import init_params, init_params_sharded
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
from repro_torch.sharding.specs import (NamedSharding, make_constrain,
                                        map_specs)
from repro_torch.sharding.state import shard_params, state_specs
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
    dev = join_process_group(resolve_device(args.device))
    cfg = get_arch(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.reduced:
        cfg = cfg.reduced()
        mesh = make_test_mesh((1, 1), ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
    fsdp = cfg.param_count() >= 4e9
    constrain = make_constrain(mesh, fsdp=fsdp, layout=args.layout)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train")

    shardings = None
    if args.reduced:
        params = init_params(cfg, gen, device=dev)
        state = init_train_state(cfg, shard_params(params, cfg, constrain))
        del params
    else:
        state = init_train_state(cfg, init_params_sharded(cfg, gen,
                                                          constrain))
        shardings = map_specs(lambda s: NamedSharding(mesh, s),
                              state_specs(state, cfg, constrain.sharding))
    step = make_train_step(cfg, constrain=constrain, peak_lr=args.lr,
                           warmup_steps=max(1, args.steps // 10),
                           total_steps=args.steps,
                           microbatches=args.microbatches)
    pipe = SyntheticPipeline(cfg, batch=args.batch, seq_len=args.seq_len,
                             seed=0, device=dev)
    loop = FaultTolerantLoop(step, state, pipe, ckpt_dir,
                             save_every=args.save_every, shardings=shardings)
    loop.run(args.steps)
    if mesh.rank != mesh.ranks[0]:
        return
    first, last = loop.metrics_log[0], loop.metrics_log[-1]
    print(f"step {first['step']}: loss {first['loss']:.4f}")
    print(f"step {last['step']}: loss {last['loss']:.4f} "
          f"({last['step_time_s']*1e3:.0f} ms/step, "
          f"restarts={loop.restarts})")


if __name__ == "__main__":
    main()
