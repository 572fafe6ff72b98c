"""End-to-end training driver on the PyTorch port: a llama-family model
on the synthetic pipeline with checkpointing + fault-tolerant
supervision, on one device (the counterpart of ``examples/train_lm.py``).

Default is a ~10M-param model for a quick demo; --params-100m selects
the ~100M config of the few-hundred-step run.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.api import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import LayerSpec
from repro_torch.data.synthetic import SyntheticPipeline
from repro_torch.models.transformer import init_params
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
from repro_torch.train.train_step import init_train_state, make_train_step


def small_config(full_100m: bool):
    base = get_arch("llama3.2-3b")
    if full_100m:
        # 103M params: 2*49152*640 embeddings + 10 layers
        return dataclasses.replace(
            base, n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
            head_dim=64, d_ff=2560, vocab_size=49152,
            layer_pattern=(LayerSpec("full"),), param_dtype="float32",
            remat="none")
    return dataclasses.replace(
        base, n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=1024, vocab_size=8192, layer_pattern=(LayerSpec("full"),),
        param_dtype="float32", remat="none")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--params-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = small_config(args.params_100m)
    print(f"model: {cfg.param_count()/1e6:.1f}M params, "
          f"{cfg.n_layers}L x {cfg.d_model}d")

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    state = init_train_state(cfg, params)
    step = make_train_step(cfg, peak_lr=3e-3, warmup_steps=20,
                           total_steps=args.steps)
    pipe = SyntheticPipeline(cfg, batch=args.batch, seq_len=args.seq_len,
                             seed=0, device=dev)
    loop = FaultTolerantLoop(step, state, pipe, args.ckpt_dir,
                             save_every=50)
    loop.run(args.steps)
    first = loop.metrics_log[0]
    last = loop.metrics_log[-1]
    print(f"step {first['step']}: loss {first['loss']:.3f}")
    print(f"step {last['step']}: loss {last['loss']:.3f} "
          f"({last['step_time_s']*1000:.0f} ms/step)")
    print(f"checkpoints in {args.ckpt_dir}; restarts={loop.restarts}")
    return loop


if __name__ == "__main__":
    main()
