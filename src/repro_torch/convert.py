"""Carry a fitted model across from the JAX package.

The JAX package's parameters are handed over as numpy arrays and plain
floats (this module imports nothing of it): the spec (nu1, nu2, eps and
the kernel's name, gamma, coef0, degree), the dual coefficients gamma,
the offsets rho1/rho2 and the training rows X. Out come the port's
``SlabSpec``, ``OCSSVMModel`` and ``SMOResult`` on the chosen device, so
a model fitted by one package can be packed and scored by the other.

LM parameters cross the same way (``lm_params_from_numpy``): the JAX
package's ``init_params`` tree as numpy arrays, whose whole pattern
periods are stacked (R, ...) per period position under "segments" and
whose partial period is the list "tail", becomes the port's ``Decoder``,
one module per layer in stack order (``layers_of`` is that re-indexing,
for caches too).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine.types import SMOResult
from repro_torch.core.kernel_fn import KernelFn
from repro_torch.core.ocssvm import OCSSVMModel, SlabSpec


def spec_from_params(*, nu1: float, nu2: float, eps: float, kernel: str,
                     gamma: float = 1.0, coef0: float = 0.0,
                     degree: int = 3) -> SlabSpec:
    """A ``SlabSpec`` from host floats; ``kernel`` is the kernel's name."""
    return SlabSpec(nu1=float(nu1), nu2=float(nu2), eps=float(eps),
                    kernel=KernelFn(name=str(kernel), gamma=float(gamma),
                                    coef0=float(coef0), degree=int(degree)))


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def model_from_params(*, gamma, rho1: float, rho2: float, X,
                      spec: SlabSpec, device="cpu") -> OCSSVMModel:
    """An ``OCSSVMModel`` from the dual coefficients (m,), the offsets
    and the training rows (m, d)."""
    gamma = _f32(gamma, device).reshape(-1)
    X = _f32(X, device)
    if X.ndim != 2 or X.shape[0] != gamma.shape[0]:
        raise ValueError(f"gamma {tuple(gamma.shape)} and X "
                         f"{tuple(X.shape)} do not describe one model")
    return OCSSVMModel(gamma=gamma, rho1=_f32(rho1, device),
                       rho2=_f32(rho2, device), X=X, spec=spec)


def result_from_params(*, model: OCSSVMModel, iters: int, n_viol: int,
                       max_viol: float, gap: float, converged: bool,
                       f=None) -> SMOResult:
    """An ``SMOResult`` around a carried-across model and its solve's
    diagnostics (``f`` is the optional final f-cache)."""
    dev = model.gamma.device
    return SMOResult(
        model=model,
        iters=torch.tensor(int(iters), dtype=torch.int32, device=dev),
        n_viol=torch.tensor(int(n_viol), dtype=torch.int32, device=dev),
        max_viol=_f32(max_viol, dev), gap=_f32(gap, dev),
        converged=torch.tensor(bool(converged), device=dev),
        f=None if f is None else _f32(f, dev).reshape(-1))


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and (named) tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        vals = [_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    return fn(tree)


def _stack(trees: list):
    """Equal-structure dicts of arrays -> one dict of arrays stacked on a
    new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def layers_of(tree: dict, cfg) -> list:
    """The per-layer subtrees of a JAX-layout tree (parameters or a
    cache), in stack order: layer j is period position j % period of
    whole period j // period, then the tail."""
    out = []
    for j in range(cfg.n_layers):
        r, i = divmod(j, cfg.period)
        if r < cfg.n_repeats:
            out.append(_map(lambda a, r=r: a[r], tree["segments"][f"l{i}"]))
        else:
            out.append(tree["tail"][j - cfg.n_repeats * cfg.period])
    return out


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: its 2-byte bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def lm_params_from_numpy(tree: dict, cfg, device=None):
    """The port's ``Decoder`` from the JAX package's ``init_params`` tree
    as numpy arrays, on ``device`` (default: the CUDA card; ``"cpu"`` on
    the CPU); every leaf keeps its dtype."""
    from repro_torch.api import resolve_device
    from repro_torch.models.transformer import Decoder
    dev = resolve_device(device)
    to = lambda a: _tensor(a, dev)                        # noqa: E731
    return Decoder(cfg, {
        "embed": to(tree["embed"]), "final_norm": to(tree["final_norm"]),
        "unembed": to(tree["unembed"]),
        "layers": [_map(to, t) for t in layers_of(tree, cfg)]})


def lm_params_to_numpy(params, cfg) -> dict:
    """The inverse of ``lm_params_from_numpy``: the JAX package's tree of
    numpy arrays (bf16 leaves come back as f32: numpy has no bf16)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    layers = []
    for layer in params.layers:
        t = {k: leaf(v) for k, v in layer.named_parameters(recurse=False)}
        t.update({k: {n: leaf(w) for n, w in m.items()}
                  for k, m in layer.named_children()})
        layers.append(t)
    tree = {"embed": leaf(params.embed), "final_norm":
            leaf(params.final_norm), "unembed": leaf(params.unembed)}
    if cfg.n_repeats:
        tree["segments"] = {
            f"l{i}": _stack([layers[r * cfg.period + i]
                             for r in range(cfg.n_repeats)])
            for i in range(cfg.period)}
    if cfg.n_tail:
        tree["tail"] = layers[cfg.n_repeats * cfg.period:]
    return tree
