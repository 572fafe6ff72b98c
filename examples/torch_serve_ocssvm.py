"""Batched OCSSVM scoring service on the PyTorch port — the serving half
of the paper system (the counterpart of ``examples/serve_ocssvm.py``).

Everything goes through ``repro_torch.serve``: the warm-model cache fits
on miss (here through the fused ``fupdate`` kernel, ``gram_mode=
"pallas"``) and packs the support set for the ``decision`` kernel once;
the scorer pads every batch to a bucket; the service micro-batches
queued requests into one launch.

    PYTHONPATH=src python examples/torch_serve_ocssvm.py [--device cpu]

The data come from ``repro_torch.data.make_toy`` with a seed, so they are
not the JAX example's (numpy draws, not ``jax.random``).
"""
import argparse
import time

import numpy as np
import torch

import repro_torch
from repro_torch.api import resolve_device
from repro_torch.core import SlabSpec, rbf
from repro_torch.data import make_toy
from repro_torch.serve import ScoringService

SPEC = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=rbf(gamma=0.5))
BATCHES = (64, 256, 1024)


def main(device=None, m: int = 2000) -> dict:
    """Fit, pack and serve on ``device`` (default: the CUDA card);
    returns the numbers it prints, the served model and every batch's
    queries and scores."""
    dev = resolve_device(device)
    X, _ = make_toy(0, m)
    kw = dict(offsets="quantile", P=16, tol=1e-3, gram_mode="pallas",
              device=dev)

    t0 = time.perf_counter()
    sm = repro_torch.serve(X, SPEC, **kw)
    cold = time.perf_counter() - t0
    print(f"model: {sm.n_sv} SVs (packed {tuple(sm.t_pad.shape)}), "
          f"slab [{float(sm.rho1):.4f}, {float(sm.rho2):.4f}], "
          f"cold fit+pack {cold*1e3:.0f} ms")

    t0 = time.perf_counter()
    again = repro_torch.serve(X, SPEC, **kw)           # cache hit
    cache = repro_torch.serve.default_cache()
    print(f"warm re-serve: {(time.perf_counter() - t0)*1e3:.2f} ms "
          f"(cache {cache.hits} hits / {cache.misses} misses)")

    svc = ScoringService(sm.scorer())
    batches = {}
    for batch_size in BATCHES:
        q, yq = make_toy(1, batch_size)
        svc.score(q)                                   # warm the bucket
        scores = svc.score(q)
        s = svc.stats[batch_size]
        acc = float((np.where(scores >= 0, 1, -1) == yq).mean())
        batches[batch_size] = {"queries": q, "scores": scores, "acc": acc,
                               "ms": s.last_s * 1e3}
        print(f"batch={batch_size:5d}: {s.last_s*1e3:7.2f} ms "
              f"({s.last_s/batch_size*1e6:6.1f} us/query) acc={acc:.3f}")

    # micro-batching: many small requests coalesce into one launch
    reqs = [make_toy(10 + i, 48)[0] for i in range(8)]
    pending = [svc.submit(q) for q in reqs]
    launches = svc.flush()
    print(f"micro-batch: {len(reqs)} x 48-row requests -> "
          f"{launches} launch(es)")
    for line in svc.stats_lines():
        print("  " + line)

    # cross-check against the model's plain PyTorch path
    q, _ = make_toy(2, 128)
    ref = sm.model.decision_function(torch.as_tensor(q, device=dev))
    np.testing.assert_allclose(np.asarray(sm.score(q)), ref.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    print("decision kernel == plain reference: OK")
    return {"served": sm, "hit": again is sm, "n_sv": sm.n_sv,
            "fit_iters": sm.fit_iters, "rho": (float(sm.rho1),
                                               float(sm.rho2)),
            "cold_ms": cold * 1e3, "batches": batches,
            "microbatch": {"requests": reqs,
                           "scores": [p.result() for p in pending],
                           "launches": launches}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    ap.add_argument("--m", type=int, default=2000)
    args = ap.parse_args()
    main(args.device, args.m)
