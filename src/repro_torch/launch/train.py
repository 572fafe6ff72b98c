"""LM training launcher on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 100 --batch 8 --seq-len 256 [--reduced] [--device cpu] \
        --ckpt-dir DIR

Random parameters (a generator seeded 0) on the device (default: the
CUDA card), the synthetic pipeline (seed 0) and the fault-tolerant loop
(checkpoints every ``--save-every`` steps into ``--ckpt-dir``, resumed
from there); prints the first and the last step's loss as the JAX
package's ``repro.launch.train`` does. ``--layout`` and ``--multi-pod``
name that package's production mesh, which belongs to the sharded slice:
any value but the default is refused.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.data.synthetic import SyntheticPipeline
from repro_torch.models.transformer import init_params
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
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
                    help="the arch's reduced config")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: the production mesh is the sharded "
                         "slice's")
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp"],
                    help="refused unless tp: the production mesh is the "
                         "sharded slice's")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train in the temp directory")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    return ap


def main(argv=None):
    from repro_torch.api import resolve_device
    ap = _parser()
    args = ap.parse_args(argv)
    if args.multi_pod or args.layout != "tp":
        ap.error("--multi-pod and --layout name the production mesh, which "
                 "belongs to the sharded slice; this launcher trains on one "
                 "device")
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train")

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    state = init_train_state(cfg, params)
    del params
    step = make_train_step(cfg, peak_lr=args.lr,
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
