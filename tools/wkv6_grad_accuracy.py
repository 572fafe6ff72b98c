"""Where the f32 rounding of the WKV gradients lies.

``chip_smoke.py`` [lm-ssm] (c) holds the f32 gradient of every parameter
of rwkv6-7b (published widths, cut to 4 layers, remat "full", 2 x 512
tokens) through the scan kernels against the same through the plain
scans, leaf by leaf in relative L2. The ``u`` leaves (each layer's bonus,
used by the WKV recurrence alone) read closest to that limit. This
script reruns that pair for some seeds and records, at each layer's WKV
call, its inputs and the gradients that reach them (through tensor
hooks: the ones the model's own backward computes). Then, on each path's
own inputs, it runs the plain recurrence in float64 and reports, layer by
layer and for du, dw, dr, dk and dv:

* ``own``: the relative L2 distance of the path's gradient from the
  float64 one on the same inputs (the rounding of that path's scan);
* ``inputs``: the float64 gradients of the two paths' inputs apart (what
  the layers above the scan carry from one path to the other);
* ``pair``: the two paths' gradients apart (for du, the distance that
  [lm-ssm] (c) reads on the ``u`` leaf).

Run on the card (builds ``csrc/wkv6.cu`` on first use):

    python tools/wkv6_grad_accuracy.py [--seeds 0 1 2]

and, for the plumbing only, on the CPU at the reduced config (where both
paths are the plain version): ``--device cpu --reduced``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

NAMES = ("r", "k", "v", "w", "u")
BATCH = 2                 # [lm-ssm] (c)'s SSM_TRAIN_B


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


@contextlib.contextmanager
def recording(impl, calls: list):
    """The model's WKV operator replaced by ``impl``, each call recording
    its inputs and, by hooks, the gradients of y, of the last state and
    of r, k, v, w and u. Remat runs a layer's forward again in the
    backward; the recomputed call's tensors get no gradient, so only the
    first forward's records gain a ``gy``."""
    from repro_torch.models import rwkv as trwkv
    saved = trwkv.wkv6

    def wrapped(r, k, v, w, u, S0, *args, **kwargs):
        rec = {"ins": [t.detach().clone() for t in (r, k, v, w, u, S0)],
               "grads": {}}
        for name, t in zip(NAMES, (r, k, v, w, u)):
            if t.requires_grad:
                t.register_hook(lambda g, n=name: rec["grads"].__setitem__(
                    n, g.detach().clone()))
        y, S = impl(r, k, v, w, u, S0, *args, **kwargs)
        y.register_hook(lambda g: rec.__setitem__("gy", g.detach().clone()))
        S.register_hook(lambda g: None if g is None else rec.__setitem__(
            "gS", g.detach().clone()))
        calls.append(rec)
        return y, S

    trwkv.wkv6 = wrapped
    try:
        yield
    finally:
        trwkv.wkv6 = saved


def exact_grads(rec: dict) -> dict:
    """d(r, k, v, w, u) of the plain recurrence in float64 on ``rec``'s
    inputs, given its gy (and gS, zero when the last state was unused)."""
    from repro_torch.kernels.scan import ref as sref
    live = [t.double().requires_grad_() for t in rec["ins"]]
    y, S = sref.wkv6_plain(*live)
    gS = rec.get("gS", torch.zeros_like(S)).double()
    torch.autograd.backward([y, S], [rec["gy"].double(), gS])
    return {n: t.grad for n, t in zip(NAMES, live)}


def run_path(cfg, params, batch, impl) -> list:
    """The f32 loss's backward with the WKV operator ``impl``: each
    layer's record (inputs, hooked gradients), in layer order."""
    from repro_torch.train import train_step as tts
    from repro_torch.utils.tree import leaves, map_tree
    calls: list = []
    with recording(impl, calls):
        live = map_tree(lambda t: t.detach().requires_grad_(True), params)
        loss = tts.loss_fn(live, cfg, batch)[0]
        torch.autograd.grad(loss, leaves(live), allow_unused=True)
    recs = [c for c in calls if "gy" in c]
    if len(recs) != cfg.n_layers or any(
            set(c["grads"]) != set(NAMES) for c in recs):
        raise RuntimeError(f"recorded {len(recs)} WKV calls with a "
                           f"gradient, {cfg.n_layers} layers expected")
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="rwkv6-7b's reduced config (a CPU check)")
    args = ap.parse_args(argv)

    from repro_torch.api import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import SyntheticPipeline
    from repro_torch.kernels.scan import ops as sops
    from repro_torch.kernels.scan import ref as sref
    from repro_torch.models.transformer import init_params
    from repro_torch.train import train_step as tts

    dev = resolve_device(args.device)
    arch = get_arch("rwkv6-7b")
    if args.reduced:
        arch = arch.reduced()
    cfg = dataclasses.replace(arch, n_layers=args.layers, remat="full",
                              param_dtype="float32")
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(dev), flush=True)
    out = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        params = tts.init_train_state(cfg, init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed),
            device=dev)).params
        batch = SyntheticPipeline(cfg, batch=BATCH,
                                  seq_len=args.tokens, seed=seed,
                                  device=dev).next_batch()
        paths = {"kernels": run_path(cfg, params, batch, sops.wkv6),
                 "plain": run_path(cfg, params, batch, sref.wkv6_plain)}
        del params
        exact = {p: [exact_grads(c) for c in recs]
                 for p, recs in paths.items()}
        for layer in range(cfg.n_layers):
            row = {"seed": seed, "layer": layer}
            for n in ("u", "w", "r", "k", "v"):
                g = {p: paths[p][layer]["grads"][n] for p in paths}
                e = {p: exact[p][layer][n] for p in paths}
                row[n] = {"own_kernels": rel(g["kernels"], e["kernels"]),
                          "own_plain": rel(g["plain"], e["plain"]),
                          "inputs": rel(e["kernels"], e["plain"]),
                          "pair": rel(g["kernels"], g["plain"])}
            out.append(row)
            print(json.dumps(row), flush=True)
        del paths, exact
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    worst = {k: max(r["u"][k] for r in out)
             for k in ("own_kernels", "own_plain", "inputs", "pair")}
    print(json.dumps({"du_largest": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
