"""LM serving launcher: prefill + batched greedy decode on the mesh (the
JAX package's ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --batch 4 --prompt-len 512 --new-tokens 32 [--reduced] \
        [--multi-pod] [--device cpu]

``--reduced`` takes the arch's reduced config on the (1, 1) test mesh
(one process; its collectives are one-rank identities); without it the
production mesh, (16, 16) or (2, 16, 16) with ``--multi-pod``, over the
process group (started as that many processes: ``WORLD_SIZE`` / ``RANK``
/ ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` in the environment,
one card a rank, NCCL). FSDP is on from 4e9 parameters off ``--reduced``,
as in the JAX launcher. Both run the sharded code path (layout "tp"):
each rank draws its shards of random parameters (a generator seeded 0,
``init_params_sharded``) and of the cache (``init_cache_sharded``, the
layout ``launch.specs.decode_specs`` states), on the device (default:
the CUDA card), and every rank takes the same random prompt (seeded 1).
The first rank prints the time of prefill plus decode and the first
sequence's tokens, as the JAX CLI does.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.spawn import join_process_group
from repro_torch.models.transformer import init_params_sharded
from repro_torch.sharding.specs import make_constrain
from repro_torch.sharding.state import init_cache_sharded
from repro_torch.train.serve_step import make_decode, make_prefill


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    return ap


def main(argv=None):
    from repro_torch.api import resolve_device
    args = _parser().parse_args(argv)
    dev = join_process_group(resolve_device(args.device))
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        mesh = make_test_mesh((1, 1), ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
    fsdp = cfg.param_count() >= 4e9 and not args.reduced
    constrain = make_constrain(mesh, fsdp=fsdp)

    total_len = args.prompt_len + args.new_tokens
    params = init_params_sharded(
        cfg, torch.Generator(device=dev).manual_seed(0), constrain)
    cache = init_cache_sharded(cfg, args.batch, total_len, constrain,
                               dtype=cfg.dtype, device=dev)
    prefill = make_prefill(cfg, constrain=constrain)
    decode = make_decode(cfg, constrain=constrain)
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
    if mesh.rank == mesh.ranks[0]:
        print(f"generated {tuple(tokens.shape)} in {dt*1e3:.0f} ms "
              f"({dt / (args.new_tokens * args.batch) * 1e3:.1f} ms/token)")
        print("first sequence:", tokens[0].tolist())


if __name__ == "__main__":
    main()
