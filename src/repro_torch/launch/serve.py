"""LM serving launcher: prefill + batched greedy decode on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --batch 4 --prompt-len 512 --new-tokens 32 [--reduced] [--device cpu]

Random parameters (a generator seeded 0) and a random prompt (seeded 1)
on the device (default: the CUDA card). Prints the time of prefill plus
decode and the first sequence's tokens, as the JAX package's
``repro.launch.serve`` does; the production mesh belongs to the sharding
slice.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.train.serve_step import make_decode, make_prefill


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    return ap


def main(argv=None):
    from repro_torch.api import resolve_device
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    total_len = args.prompt_len + args.new_tokens
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    cache = init_cache(cfg, args.batch, total_len, dtype=cfg.dtype,
                       device=dev)
    prefill, decode = make_prefill(cfg), make_decode(cfg)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, {"tokens": prompt})
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out = [tok]
    for _ in range(args.new_tokens - 1):
        logits, cache = decode(params, cache, tok)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        out.append(tok)
    tokens = torch.cat(out, dim=1).cpu()     # waits for the device
    dt = time.perf_counter() - t0
    print(f"generated {tuple(tokens.shape)} in {dt*1e3:.0f} ms "
          f"({dt / (args.new_tokens * args.batch) * 1e3:.1f} ms/token)")
    print("first sequence:", tokens[0].tolist())


if __name__ == "__main__":
    main()
